"""Pluggable draft proposers for speculative decoding on the serve path
(the PyTorch port's copy of the JAX package's ``serve/speculative.py``:
host numpy, no model and no device).

A proposer drafts up to ``k`` candidate tokens per slot from the slot's
token history; the engine verifies all drafts in ONE widened batched
launch (``model.verify`` — prefill semantics with the head at every
position) and keeps the longest prefix the model's own greedy argmax
agrees with, plus the model's correction token.  Greedy accept-or-fix is
exactly equivalent to plain greedy decoding — outputs are bit-for-bit
the same, only the launch count shrinks — so the only quality metric is
the accept rate (``stats["spec_accepted_tokens"] /
stats["spec_drafted_tokens"]``).

Built-ins:

* ``"ngram"`` — :class:`NGramProposer`, prompt-lookup decoding: the
  longest recent n-gram is matched against earlier history and its
  historical continuation proposed.  Free (no model), strong on
  repetitive continuations.
* :class:`DraftModelProposer` — the draft-model interface, stubbed: wire
  a small LM by subclassing and implementing :meth:`~Proposer.propose`.
"""
from __future__ import annotations

from typing import Optional, Protocol, Union, runtime_checkable

import numpy as np

__all__ = ["Proposer", "NGramProposer", "DraftModelProposer", "PROPOSERS",
           "get_proposer"]


@runtime_checkable
class Proposer(Protocol):
    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` drafted continuation tokens (int32, possibly
        empty) for a slot whose prompt+generated history is
        ``history``; ``history[-1]`` is the token the next decode step
        will consume."""
        ...


class NGramProposer:
    """Prompt-lookup drafting: match the last ``m``-gram (``m`` from
    ``max_ngram`` down to 1) against earlier history; on a hit, propose
    the continuation that followed the most recent prior occurrence.
    Deterministic and model-free."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history).reshape(-1)
        n = int(h.shape[0])
        empty = np.zeros((0,), np.int32)
        if k <= 0 or n < 2:
            return empty
        for m in range(min(self.max_ngram, n - 1), 0, -1):
            pat = h[n - m:]
            win = np.lib.stride_tricks.sliding_window_view(h, m)
            # windows strictly before the suffix itself, with at least
            # one continuation token available
            hits = np.flatnonzero((win[:n - m] == pat).all(axis=1))
            if hits.size:
                # most recent occurrence with a FULL k-token continuation
                # (the very last occurrence of a repeating run sits at the
                # end of history and would truncate the draft)
                full = hits[hits + m + k <= n]
                j = int(full[-1]) if full.size else int(hits[-1])
                cont = h[j + m:j + m + k]
                if cont.size:
                    return cont.astype(np.int32)
        return empty


class DraftModelProposer:
    """Interface stub for model-based drafting: hold a small draft LM and
    greedily roll it forward ``k`` tokens per call.  Not wired yet —
    subclass and implement :meth:`propose` (the verify side of the engine
    is proposer-agnostic, so no engine changes are needed)."""

    def __init__(self, model, params):
        self.model = model
        self.params = params

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError(
            "DraftModelProposer is an interface stub: subclass it and run "
            "the draft model greedily over `history`, returning up to k "
            "tokens")


PROPOSERS = {"ngram": NGramProposer}


def get_proposer(p: Union[str, Proposer, None]) -> Optional[Proposer]:
    """Resolve ``ServeConfig(speculative=...)``: None passes through, a
    name constructs the registered proposer, any object exposing
    ``propose`` is used as-is."""
    if p is None:
        return None
    if isinstance(p, str):
        try:
            return PROPOSERS[p]()
        except KeyError:
            raise ValueError(
                f"unknown proposer {p!r}; known: {sorted(PROPOSERS)} "
                f"(or pass an object with .propose(history, k))") from None
    if hasattr(p, "propose"):
        return p
    raise ValueError(
        f"speculative proposer must be a name or expose "
        f".propose(history, k); got {type(p).__name__}")
