"""Serving requests: the :class:`Request` record and the variable-length
request sampler (the paper's dynamic-shape workload generator).  numpy
only, so both packages draw the same requests from the same seed.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["VarLenRequestStream", "Request"]


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
