"""Data pipeline: the deterministic synthetic token stream of training,
the :class:`Request` record and the variable-length request sampler (the
paper's dynamic-shape workload generator), and sequence packing.  numpy
only, so both packages draw the same batches and requests from the same
seed, bit for bit.

Determinism contract (fault tolerance): every training batch is a pure
function of (seed, step), so resuming from a checkpoint at step k
reproduces the exact stream without replaying it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLMStream", "VarLenRequestStream", "Request",
           "pack_sequences"]


class SyntheticLMStream:
    """Markov-ish synthetic LM tokens: learnable structure, not pure noise.

    Tokens follow t_{i+1} = (a·t_i + b + noise) mod vocab with per-sequence
    (a, b) — a model with capacity reduces loss well below uniform entropy,
    so training curves are meaningful.
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        b, s, v = self.batch, self.seq_len + 1, self.vocab
        a = rng.randint(1, 17, size=(b, 1))
        c = rng.randint(0, v, size=(b, 1))
        t0 = rng.randint(0, v, size=(b, 1))
        idx = np.arange(s)[None, :]
        noise = rng.randint(0, 3, size=(b, s))
        toks = (t0 + a * idx + c // 7 + noise) % v
        toks = toks.astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, s - 1), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict) -> None:
        self.step = st["step"]
        self.seed = st["seed"]


# process-wide monotonic request-id source: a Request's rid is its STABLE
# identity — the serve engine keys admission removal, preemption requeue,
# and the done dict on it, so it must be unique among in-flight requests
_RID_COUNTER = itertools.count()


@dataclass
class Request:
    # explicit rid (stable across requeues) or None for an auto-assigned
    # monotonic id
    rid: Optional[int] = None
    tokens: np.ndarray = None   # (prompt_len,) — required
    max_new_tokens: int = 0
    # serve-path scheduling metadata: higher priority admits first under
    # the "priority" admission policy; arrival is the request's offset (in
    # seconds) into a synthetic trace (0.0 = available immediately)
    priority: int = 0
    arrival: float = 0.0
    # completion deadline in seconds from submission (None = no deadline):
    # the serve engine checks it at admission and between steps, retiring
    # expired requests FAILED with a DeadlineExceeded reason
    deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.rid is None:
            self.rid = next(_RID_COUNTER)


class VarLenRequestStream:
    """Inference requests with varying prompt lengths — the dynamic-shape
    workload of the paper's evaluation (ASR/Seq2seq/BERT serving)."""

    def __init__(self, vocab: int, *, min_len: int = 8, max_len: int = 512,
                 seed: int = 0, distribution: str = "lognormal"):
        self.vocab = vocab
        self.min_len = min_len
        self.max_len = max_len
        self.seed = seed
        self.distribution = distribution
        self._next_rid = 0

    def sample(self, n: int) -> List[Request]:
        out = []
        for _ in range(n):
            rng = np.random.RandomState(
                (self.seed * 7_777_777 + self._next_rid) % 2**31)
            if self.distribution == "lognormal":
                ln = int(np.clip(rng.lognormal(np.log(64), 0.8),
                                 self.min_len, self.max_len))
            else:
                ln = int(rng.randint(self.min_len, self.max_len + 1))
            toks = rng.randint(0, self.vocab, size=ln).astype(np.int32)
            out.append(Request(rid=self._next_rid, tokens=toks,
                               max_new_tokens=int(rng.randint(4, 64)),
                               priority=int(rng.randint(0, 4))))
            self._next_rid += 1
        return out

    def sample_trace(self, n: int, *, burst: int = 4,
                     mean_gap: float = 0.05) -> List[Request]:
        """A bursty arrival trace: requests land in bursts of ``burst``
        separated by exponential gaps with mean ``mean_gap`` seconds —
        the serve benchmark's synthetic heavy-traffic workload.
        Deterministic in (seed, cursor), like :meth:`sample`."""
        reqs = self.sample(n)
        t = 0.0
        for i, r in enumerate(reqs):
            if i and i % burst == 0:
                rng = np.random.RandomState(
                    (self.seed * 13_131_313 + r.rid) % 2**31)
                t += float(rng.exponential(mean_gap))
            r.arrival = t
        return reqs


def pack_sequences(seqs: List[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy first-fit packing of variable-length sequences into fixed
    rows; returns (tokens, segment_ids, mask).  segment_ids let attention
    layers prevent cross-sequence leakage (standard packed-training)."""
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    for s in seqs:
        s = s[:seq_len]
        placed = False
        for i, sp in enumerate(space):
            if len(s) <= sp:
                rows[i].append(s)
                space[i] -= len(s)
                placed = True
                break
        if not placed:
            rows.append([s])
            space.append(seq_len - len(s))
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segs = np.zeros((n, seq_len), np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    for i, row in enumerate(rows):
        off = 0
        for j, s in enumerate(row):
            tokens[i, off:off + len(s)] = s
            segs[i, off:off + len(s)] = j + 1
            mask[i, off:off + len(s)] = 1.0
            off += len(s)
    return tokens, segs, mask
