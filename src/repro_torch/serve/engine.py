"""Serving engine: continuous batching over 2-D DISC shape buckets, on one
card (the PyTorch port of the JAX package's ``serve/engine.py``).

The serving problem — requests with varying prompt lengths force either
per-shape recompilation or interpretation — is solved as DISC prescribes,
on the public ``disc_torch.compile`` API (``pipeline="jit"``):

* **prefill** is ONE single-pass batched artifact with two dynamic dims,
  ``Dim("B", max=slots)`` × ``Dim("S", max=max_seq)``: waiting requests
  are admitted together, grouped by prompt-chunk bucket, and one launch
  computes every prompt position's K/V plus last-position logits for the
  whole group (``model.prefill``).  Per-request true lengths ride the
  ``lens`` vector; the gathered KV-cache rows thread through a
  ``TreeSpec`` so the generated dispatch bucket-pads the batch axis of
  every leaf.  Compile count stays O(#(B, S) buckets); hot exact (B, S)
  signatures escalate (§4.4) to unpadded entries via
  ``ServeConfig(escalation_threshold=...)``.
* **chunked prefill**: ``ServeConfig(prefill_chunk=...)`` splits long
  prompts into chunks interleaved with decode steps
  (``prefill_interleave`` decode steps owed between launches); the model
  continues a prompt at its cache offset (``offsets``).
* **admission** is pluggable (:mod:`repro_torch.serve.policies`):
  ``"fifo"``, ``"shortest-prompt-first"``, ``"priority"``, or any
  callable ordering the waiting queue.
* **decode** is one artifact over the fixed-capacity KV cache; a step
  serves any mix of sequence lengths via the lens vector, and an
  ``active`` row mask gates cache writes so mid-prefill and empty slots
  are never touched by a decode step.
* ``ServeConfig(prefill_mode="replay")`` keeps the O(prompt_len)
  sequential-launches prefill as a baseline.
* **replicas** (``ServeConfig(replicas=N)``): the engine owns
  ``N x max_batch`` KV-cache rows on the one card; replica ``r`` owns
  the slot range ``[r*max_batch, (r+1)*max_batch)``, admission routes
  each request to the least-loaded replica with a free slot, and decode
  is one launch over all rows.

On the card every attention runs the flash-attention kernel, every
norm its RMSNorm or LayerNorm kernel, every RWKV time mix the WKV kernel,
every Mamba-2 block the SSD kernel and every MoE router the masked
softmax kernel (the model's layers call their wrappers).  On the card
each prefill bucket and the decode step is one CUDA graph, captured at
its first call and replayed after (:mod:`repro_torch.core.graphs`); the
graphs of one engine share a memory pool.  The compiled entries hold
the engine weakly, so a dropped engine frees its cache, parameters and
graphs at once.  The cache lives on the card; the engine updates its
rows in place (prefill's rows by ``index_copy_``, a decode step inside
its graph) where the JAX package rebuilds the array.  A cache is any
tree of layer-stacked leaves with the batch on axis 1 (the dense KV
cache, RWKV's nested recurrent state): row gathers, scatters, zeroing
and gating map over its leaves.

Not ported yet, each raising ``NotImplementedError`` naming its slice:
paged KV (``kv_block_size``), speculative decoding (``speculative``),
SPMD placement (``mesh``) and replica heartbeats
(``heartbeat_deadline_s``).  Every ``stats`` key is documented in
:data:`STATS_KEYS`.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..api.options import CompileOptions, Dim, TreeSpec, resolve_device
from ..api.staged import compile as disc_compile, weak_method
from ..core.bucketing import BucketPolicy, POW2
from ..core.cache import CompileCache
from ..data.pipeline import Request
from ..errors import (CONTROL_EXCEPTIONS, DEFAULT_RETRY, DiscError,
                      wrap_launch_error)
from ..frontends.fx_frontend import ArgSpec
from ..models.registry import (Model, gate_rows, replay_prefill,
                               row_keep_mask, tree_map)
from .policies import get_admission_policy

__all__ = ["ServeConfig", "ServeEngine", "STATS_KEYS", "BATCH_POW2"]

# admission groups bucket to powers of two starting at 1 (1, 2, 4, ...,
# clamped to the slot count) — log-many batch buckets
BATCH_POW2 = BucketPolicy(kind="pow2", granule=1)

#: every ``ServeEngine.stats`` key, documented in one place.  Counters
#: reset via :meth:`ServeEngine.reset_stats` except where noted.
STATS_KEYS: Dict[str, str] = {
    "prefill_calls": "prefill launches (any group size)",
    "batched_prefills": "prefill launches serving >1 request in one pass",
    "prefill_chunks": "prefill launches that touched a partially-prefilled "
                      "prompt (chunked prefill active)",
    "prefill_compiles": "prefill artifact compiles, bucket + exact "
                        "(artifact-lifetime: not reset)",
    "prefill_escalations": "§4.4 exact specializations of the prefill "
                           "artifact (artifact-lifetime: not reset)",
    "prefill_bucket_pairs": "distinct (B, S) bucket pairs launched "
                            "(artifact-lifetime: not reset)",
    "decode_steps": "decode launches (whole active batch per launch)",
    "tokens_generated": "tokens produced (incl. each prompt's first token "
                        "at prefill completion)",
    "tokens_per_sec": "tokens_generated / busy seconds inside step()",
    "max_decode_gap_s": "longest wall-clock gap between decode launches "
                        "while decode work was pending (decode stall)",
    "requests_completed": "requests retired into done",
    "rejected_requests": "requests refused at submit(): prompt longer than "
                         "max_seq (the rest of the batch is still "
                         "admitted)",
    "peak_active_slots": "max concurrently occupied slots observed",
    "mem_launch_bytes": "staging bytes of the last prefill launch (dynamic "
                        "args padded to their (B, S) bucket; not reset)",
    "mem_peak_launch_bytes": "largest single prefill launch observed "
                             "(artifact-lifetime: not reset)",
    "mem_launch_saved_bytes": "cumulative staging bytes saved by bucketing "
                              "vs launching every call at the "
                              "slots×max_seq caps (artifact-lifetime: "
                              "not reset)",
    "per_replica": "one dict per replica: admitted, tokens_generated, "
                   "requests_completed, occupied_slots (slot-range "
                   "[r*max_batch, (r+1)*max_batch) counters under "
                   "least-loaded routing)",
    "failed_requests": "requests retired FAILED (permanent launch "
                       "failure, deadline expiry) — reasons in "
                       "``engine.failed[rid]``",
    "retries": "transient launch retries (capped exponential backoff)",
    "deadline_expirations": "requests failed because Request.deadline_s "
                            "passed (checked at admission and between "
                            "steps)",
}

# options of the reference engine whose slices are not ported yet
_LATER = {
    "kv_block_size": "paged KV arrives with the port's paged/speculative "
                     "slice",
    "speculative": "speculative decoding arrives with the port's "
                   "paged/speculative slice",
    "mesh": "SPMD placement arrives with the port's multi-GPU slice",
    "sharding_profile": "SPMD placement arrives with the port's multi-GPU "
                        "slice",
    "heartbeat_deadline_s": "replica health monitoring arrives with the "
                            "port's observability / fault-tolerance slice",
}


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 512
    # S (prompt/chunk length) buckets; B (admission group) buckets
    prefill_policy: BucketPolicy = POW2
    batch_policy: BucketPolicy = BATCH_POW2
    eos_id: int = 1
    # §4.4 static/dynamic mix on the serving path: exact (B, S) prefill
    # signatures seen at least this many times get an unpadded
    # specialization.  None disables.
    escalation_threshold: Optional[int] = None
    # "batched" = single-pass model.prefill; "replay" = the sequential
    # decode-step replay baseline (one request per launch)
    prefill_mode: str = "batched"
    # split prompts into chunks of at most this many tokens, interleaved
    # with decode steps; None prefills whole prompts in one launch
    prefill_chunk: Optional[int] = None
    # decode steps owed between prefill launches when both are pending
    prefill_interleave: int = 1
    # admission policy name (repro_torch.serve.policies) or callable
    admission: Union[str, Callable] = "fifo"
    # data-parallel replica count: the engine serves replicas*max_batch
    # slots, one decode launch over all of them; admission routes each
    # request to the least-loaded replica's slot range
    replicas: int = 1
    # where the model, the KV cache and both artifacts live: the card
    # unless "cpu" is asked for (the kernels' plain versions)
    device: str = "cuda"
    # not ported yet: each raises NotImplementedError when set
    kv_block_size: Optional[int] = None
    speculative: Optional[Any] = None
    mesh: Optional[Any] = None
    sharding_profile: Optional[Any] = None
    heartbeat_deadline_s: Optional[float] = None


@dataclass
class _Slot:
    """One KV-cache row's scheduler state: admitted requests move
    prefill -> decode -> retired (slot freed)."""

    rid: int
    tokens: np.ndarray
    plen: int
    remaining: int
    pos: int = 0                  # prompt tokens prefilled so far
    state: str = "prefill"        # "prefill" | "decode"
    generated: List[int] = field(default_factory=list)


class ServeEngine:
    def __init__(self, model: Model, params, scfg: ServeConfig):
        for name, why in _LATER.items():
            if getattr(scfg, name) is not None:
                raise NotImplementedError(f"ServeConfig({name}=...): {why}")
        if model.cfg.family == "encdec":
            raise ValueError(
                f"ServeEngine serves language models; {model.cfg.name} is "
                f"an encoder-decoder whose decode step needs the encoder's "
                f"output: run encode, then greedy_decode (compile it with "
                f"disc_torch.compile(..., pipeline='jit'))")
        if scfg.prefill_mode not in ("batched", "replay"):
            raise ValueError(
                f"unknown prefill_mode {scfg.prefill_mode!r} "
                f"(expected 'batched' or 'replay')")
        if scfg.replicas < 1:
            raise ValueError(f"ServeConfig(replicas={scfg.replicas}): "
                             f"need at least 1 replica")
        self.device = resolve_device(scfg.device)
        where = {t.device.type for t in _leaves(params)}
        if where != {self.device.type}:
            raise ValueError(f"ServeEngine on {self.device}: the parameters "
                             f"live on {sorted(where)}")
        self.model = model
        self.params = params
        self.scfg = scfg
        self.n_slots = scfg.replicas * scfg.max_batch
        self.cache = model.init_cache(self.n_slots, scfg.max_seq,
                                      self.device)
        self.lens = np.zeros((self.n_slots,), np.int32)
        self.slots: List[Optional[_Slot]] = [None] * self.n_slots
        self.queue: List[Request] = []
        self.done: Dict[int, List[int]] = {}
        self.rejected: List[int] = []   # rids refused at submit()
        # rid -> failure reason for requests retired FAILED (permanent
        # launch error, DeadlineExceeded)
        self.failed: Dict[int, str] = {}
        self._deadlines: Dict[int, float] = {}  # rid -> absolute deadline
        self._clock = time.monotonic            # injectable (tests)
        self._wall = time.perf_counter  # busy_s and decode gaps only
        self._retry = DEFAULT_RETRY
        self._admit_order = get_admission_policy(scfg.admission)
        self._prefill_impl = (model.prefill if scfg.prefill_mode == "batched"
                              else replay_prefill(model.decode_step))
        self._decode_credit = 0
        self._bucket_pairs: Set[Tuple[int, int]] = set()
        self._busy_s = 0.0
        self._last_decode_t: Optional[float] = None
        self._rep_counters = [
            {"admitted": 0, "tokens_generated": 0, "requests_completed": 0}
            for _ in range(scfg.replicas)]

        # one compile cache shared by both artifacts; entries are keyed by
        # per-artifact fingerprint so prefill/decode never collide
        self.compile_cache = CompileCache("serve", max_entries=64)
        pol = dataclasses.replace(
            scfg.prefill_policy,
            overrides=tuple(scfg.prefill_policy.overrides) + (
                ("B", (scfg.batch_policy.kind, scfg.batch_policy.granule)),))
        dim_b = Dim("B", max=self.n_slots)
        i32 = torch.int32
        # the compiled entries call back into the engine through weak
        # references: a dropped engine frees its cache and parameters at
        # once, without waiting for a gc pass over a cycle
        self._prefill_fn = disc_compile(
            weak_method(self._prefill_call),
            specs=[None,                 # params tree
                   TreeSpec({1: "B"}),   # gathered cache rows (L, B, ...)
                   ArgSpec((dim_b, Dim("S", max=scfg.max_seq)), i32,
                           name="tokens"),
                   ArgSpec((dim_b,), i32, name="lens"),
                   ArgSpec((dim_b,), i32, name="offsets")],
            options=CompileOptions(pipeline="jit", name="prefill",
                                   policy=pol, device=scfg.device,
                                   escalation_threshold=
                                   scfg.escalation_threshold,
                                   cache=self.compile_cache))
        n = self.n_slots
        self._decode_fn = disc_compile(
            weak_method(self._decode_step),
            # the parameter and cache trees are read in place (the cache
            # written in place); a step's own inputs are static
            specs=[None, None, ArgSpec((n, 1), i32, name="tokens"),
                   ArgSpec((n,), i32, name="lens"),
                   ArgSpec((n,), torch.bool, name="active")],
            options=CompileOptions(pipeline="jit", name="decode",
                                   device=scfg.device,
                                   cache=self.compile_cache))
        self.stats: Dict[str, Any] = self._zero_stats()
        self._refresh_stats()

    # ------------------------------------------------------------ device --
    def _prefill_call(self, params, rows, tokens, lens, offsets):
        """Single-pass prefill over a gathered group of cache rows.  Fresh
        rows (offset 0) are zeroed first so a previous occupant's state
        can never leak into a new request."""
        fresh = offsets == 0
        rows = tree_map(lambda c: torch.where(row_keep_mask(fresh, c), 0, c),
                        rows)
        return self._prefill_impl(params, rows, tokens, lens, offsets)

    def _decode_step(self, params, cache, tokens, lens, active):
        """One decode step, written into ``cache`` in place and gated to
        ``active`` rows, so mid-prefill and empty slots keep their state
        untouched.  Returns the logits and ``cache``'s own leaves: the
        decode entry's CUDA graph reads and writes the engine's cache where
        it lies, and a step copies only ``tokens``, ``lens`` and
        ``active`` into the graph."""
        logits, new_cache = self.model.decode_step(params, cache, tokens,
                                                   lens)
        return logits, tree_map(lambda c, g: c.copy_(g), cache,
                                gate_rows(active, new_cache, cache))

    def _next_tokens(self, slots: List[int],
                     logits: torch.Tensor) -> List[int]:
        """The greedy next token of each row of ``logits`` (n, V); row r
        belongs to the request in slot ``slots[r]``."""
        return logits.argmax(-1).tolist()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -------------------------------------------------------------- host --
    def submit(self, reqs: List[Request]) -> None:
        """Queue requests for admission.

        A prompt longer than ``max_seq`` is rejected gracefully — counted
        in ``stats["rejected_requests"]``, rid recorded in
        ``self.rejected`` — and the REST of the batch is still admitted.
        A rid already pending (queued or in a slot) raises, atomically,
        before anything in the batch is queued: rids are the engine's
        stable identity.
        """
        pending = {r.rid for r in self.queue}
        pending.update(s.rid for s in self.slots if s is not None)
        accepted: List[Request] = []
        dropped: List[int] = []
        for r in reqs:
            if r.rid in pending:
                raise ValueError(
                    f"request rid={r.rid} is already pending: rids are "
                    f"the engine's stable identity — leave "
                    f"Request(rid=None) for an auto-assigned monotonic "
                    f"id")
            pending.add(r.rid)
            if len(r.tokens) > self.scfg.max_seq:
                dropped.append(r.rid)
                continue
            accepted.append(r)
            if r.deadline_s is not None and r.rid not in self._deadlines:
                self._deadlines[r.rid] = self._clock() + r.deadline_s
        self.stats["rejected_requests"] += len(dropped)
        self.rejected.extend(dropped)
        self.queue.extend(accepted)

    def _replica_of(self, slot: int) -> int:
        return slot // self.scfg.max_batch

    def _admit(self) -> None:
        """Claim free slots for waiting requests in policy order; each
        request goes to the least-loaded replica with a free slot (ties
        to the lowest index).  Admitted requests enter the prefill
        state."""
        mb = self.scfg.max_batch
        free_by_rep = [[i for i in range(r * mb, (r + 1) * mb)
                        if self.slots[i] is None]
                       for r in range(self.scfg.replicas)]
        n_free = sum(len(f) for f in free_by_rep)
        if not n_free or not self.queue:
            return
        taken: Set[int] = set()
        for req in self._admit_order(self.queue):
            if len(taken) >= n_free:
                break
            taken.add(req.rid)
            rep = min((r for r in range(self.scfg.replicas)
                       if free_by_rep[r]),
                      key=lambda r: (mb - len(free_by_rep[r]), r))
            i = free_by_rep[rep].pop(0)
            toks = np.asarray(req.tokens, np.int32)
            self.slots[i] = _Slot(rid=req.rid, tokens=toks,
                                  plen=int(toks.shape[0]),
                                  remaining=req.max_new_tokens)
            self.lens[i] = 0
            self._rep_counters[rep]["admitted"] += 1
        self.queue = [r for r in self.queue if r.rid not in taken]

    # -------------------------------------------------------- fault plane --
    def _fail_request(self, rid: int, reason: str) -> None:
        self.failed[rid] = reason
        self.stats["failed_requests"] += 1
        self._deadlines.pop(rid, None)

    def _fail_slot(self, i: int, reason: str) -> None:
        """Fail the request occupying slot ``i`` and free the slot."""
        rid = self.slots[i].rid
        self.slots[i] = None
        self.lens[i] = 0
        self._fail_request(rid, reason)

    def _launch(self, kind: str, fn: Callable, *args):
        """Run one artifact launch under the taxonomy: transient failures
        (allocator pressure) retry with capped exponential backoff; a
        permanent failure raises a classified
        :class:`~repro_torch.errors.DiscError` for the caller to fail
        exactly the requests in the launch group."""
        attempt = 0
        while True:
            try:
                return fn(*args)
            except CONTROL_EXCEPTIONS:
                raise
            except DiscError as e:   # already classified (e.g. a
                err = e              # CompileError out of dispatch)
            except Exception as e:  # noqa: BLE001 — classified below
                err = wrap_launch_error(e, kind)
            if not err.transient or attempt >= self._retry.max_retries:
                raise err
            self.stats["retries"] += 1
            time.sleep(self._retry.delay(attempt))
            attempt += 1

    def _check_deadlines(self) -> None:
        """Fail queued and in-slot requests whose deadline passed."""
        if not self._deadlines:
            return
        now = self._clock()
        expired = {rid for rid, d in self._deadlines.items() if now > d}
        if not expired:
            return
        for i, s in enumerate(self.slots):
            if s is not None and s.rid in expired:
                self.stats["deadline_expirations"] += 1
                self._fail_slot(i, f"DeadlineExceeded: deadline_s passed "
                                   f"after {len(s.generated)} tokens")
        for r in [r for r in self.queue if r.rid in expired]:
            self.stats["deadline_expirations"] += 1
            self._fail_request(r.rid, "DeadlineExceeded: deadline_s "
                                      "passed before completion")
        self.queue = [r for r in self.queue if r.rid not in expired]

    def _prefill_group(self) -> None:
        """One prefill launch: group prefill-state slots by the bucket of
        their next chunk length and launch the largest group in a single
        batched pass (replay mode launches one request at a time)."""
        chunk_cap = self.scfg.prefill_chunk or self.scfg.max_seq
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for i, s in enumerate(self.slots):
            if s is None or s.state != "prefill":
                continue
            cl = min(s.plen - s.pos, chunk_cap)
            sb = min(self.scfg.prefill_policy.bucket("S", max(cl, 1)),
                     self.scfg.max_seq)
            groups.setdefault(sb, []).append((i, cl))
        if not groups:
            return
        _, members = max(groups.items(), key=lambda kv: (len(kv[1]), -kv[0]))
        if self.scfg.prefill_mode == "replay":
            members = members[:1]
        nb = len(members)
        smax = max(cl for _, cl in members)
        tokens = np.zeros((nb, smax), np.int32)
        lens = np.zeros((nb,), np.int32)
        offsets = np.zeros((nb,), np.int32)
        for r, (i, cl) in enumerate(members):
            s = self.slots[i]
            tokens[r, :cl] = s.tokens[s.pos:s.pos + cl]
            lens[r] = cl
            offsets[r] = s.pos
        idx = self._tensor(np.asarray([i for i, _ in members]))
        rows = tree_map(lambda c: c.index_select(1, idx), self.cache)
        try:
            logits, new_rows = self._launch(
                "prefill", self._prefill_fn, self.params, rows,
                self._tensor(tokens), self._tensor(lens),
                self._tensor(offsets))
        except DiscError as e:
            # a failed launch fails ONLY this launch group; queued and
            # decode-state requests are untouched
            for i, _ in members:
                self._fail_slot(i, f"LaunchError(prefill): {e}")
            return
        tree_map(lambda c, n: c.index_copy_(1, idx, n[:, :nb].to(c.dtype)),
                 self.cache, new_rows)
        # the rows whose prompt this launch completes emit their first
        # token
        ending = [r for r, (i, cl) in enumerate(members)
                  if self.slots[i].pos + cl >= self.slots[i].plen]
        first = dict(zip(ending, self._next_tokens(
            [members[r][0] for r in ending],
            logits[self._tensor(np.asarray(ending, np.int64))]))) \
            if ending else {}

        self._bucket_pairs.add((
            min(self.scfg.batch_policy.bucket("B", nb), self.n_slots),
            min(self.scfg.prefill_policy.bucket("S", smax),
                self.scfg.max_seq)))
        self.stats["prefill_calls"] += 1
        if nb > 1:
            self.stats["batched_prefills"] += 1
        chunked = bool(np.any(offsets > 0))
        for r, (i, cl) in enumerate(members):
            s = self.slots[i]
            s.pos += cl
            self.lens[i] = s.pos
            if s.pos >= s.plen:
                s.state = "decode"
                s.generated.append(first[r])
                self.stats["tokens_generated"] += 1
                self._rep_counters[self._replica_of(i)][
                    "tokens_generated"] += 1
                self._maybe_retire(i)
            else:
                chunked = True
        if chunked:
            self.stats["prefill_chunks"] += 1

    def _mark_decode_launch(self) -> None:
        now = self._wall()
        if self._last_decode_t is not None:
            self.stats["max_decode_gap_s"] = max(
                self.stats["max_decode_gap_s"], now - self._last_decode_t)
        self._last_decode_t = now
        self.stats["decode_steps"] += 1

    def _decode(self) -> None:
        """One decode launch over ALL replicas' rows."""
        active_idx = [i for i, s in enumerate(self.slots)
                      if s is not None and s.state == "decode"]
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for i in active_idx:
            tokens[i, 0] = self.slots[i].generated[-1]
            active[i] = True
        try:
            logits, self.cache = self._launch(
                "decode", self._decode_fn, self.params, self.cache,
                self._tensor(tokens), self._tensor(self.lens),
                self._tensor(active))
        except DiscError as e:
            for i in active_idx:
                self._fail_slot(i, f"LaunchError(decode): {e}")
            return
        nxt = self._next_tokens(
            active_idx,
            logits[self._tensor(np.asarray(active_idx, np.int64)), 0])
        self._mark_decode_launch()
        for i, tok in zip(active_idx, nxt):
            slot = self.slots[i]
            self.lens[i] += 1
            slot.generated.append(tok)
            slot.remaining -= 1
            self.stats["tokens_generated"] += 1
            self._rep_counters[self._replica_of(i)]["tokens_generated"] += 1
            self._maybe_retire(i)

    def _maybe_retire(self, i: int) -> None:
        slot = self.slots[i]
        if (slot.remaining <= 0 or slot.generated[-1] == self.scfg.eos_id
                or self.lens[i] >= self.scfg.max_seq - 1):
            self.done[slot.rid] = slot.generated
            self.stats["requests_completed"] += 1
            self._deadlines.pop(slot.rid, None)
            self._rep_counters[self._replica_of(i)][
                "requests_completed"] += 1
            self.slots[i] = None
            self.lens[i] = 0

    def step(self) -> None:
        """One engine iteration: admit, then either a prefill launch or a
        decode step — the ``prefill_interleave`` budget decides which when
        both kinds of work are pending."""
        t0 = self._wall()
        self._check_deadlines()
        self._admit()
        has_p = any(s is not None and s.state == "prefill"
                    for s in self.slots)
        has_d = any(s is not None and s.state == "decode"
                    for s in self.slots)
        if has_p and (not has_d or self._decode_credit <= 0):
            self._prefill_group()
            self._decode_credit = max(self.scfg.prefill_interleave, 0)
        elif has_d:
            self._decode()
            self._decode_credit -= 1
        if not any(s is not None and s.state == "decode"
                   for s in self.slots):
            self._last_decode_t = None  # decode idle: gaps don't count
        self._busy_s += self._wall() - t0
        self._refresh_stats()

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)):
            self.step()
            steps += 1
            if steps > max_steps:
                break
        return self.done

    # ------------------------------------------------------ introspection --
    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-artifact compile counts (``{"bucket", "exact", "total"}``
        each) — the observable O(#buckets) contract."""
        zero = {"bucket": 0, "exact": 0, "total": 0}

        def counts(fn):
            try:
                return fn.compile_counts()
            except AttributeError:  # not compiled yet (no calls)
                return dict(zero)

        return {"prefill": counts(self._prefill_fn),
                "decode": counts(self._decode_fn)}

    def _zero_stats(self) -> Dict[str, Any]:
        """A typed zero value for every :data:`STATS_KEYS` entry."""
        z: Dict[str, Any] = {k: 0 for k in STATS_KEYS}
        z["tokens_per_sec"] = 0.0
        z["max_decode_gap_s"] = 0.0
        z["per_replica"] = [
            {"admitted": 0, "tokens_generated": 0,
             "requests_completed": 0, "occupied_slots": 0}
            for _ in range(self.scfg.replicas)]
        return z

    def reset_stats(self) -> None:
        """Zero the per-run counters (benchmark warmup boundary), each to
        its documented type; artifact-lifetime counters are re-derived and
        keep accumulating."""
        self.stats.update(self._zero_stats())
        self._rep_counters = [
            {"admitted": 0, "tokens_generated": 0, "requests_completed": 0}
            for _ in range(self.scfg.replicas)]
        self._busy_s = 0.0
        self._last_decode_t = None
        self._refresh_stats()

    def _refresh_stats(self) -> None:
        pc = self.compile_counts()["prefill"]
        self.stats["prefill_compiles"] = pc["total"]
        self.stats["prefill_escalations"] = pc["exact"]
        self.stats["prefill_bucket_pairs"] = len(self._bucket_pairs)
        occ = sum(s is not None for s in self.slots)
        self.stats["peak_active_slots"] = max(
            self.stats["peak_active_slots"], occ)
        try:
            ms = self._prefill_fn._mstats
            self.stats["mem_launch_bytes"] = ms.last_bytes
            self.stats["mem_peak_launch_bytes"] = ms.peak_bytes
            self.stats["mem_launch_saved_bytes"] = ms.saved_bytes
        except AttributeError:  # not compiled yet (no calls)
            pass
        mb = self.scfg.max_batch
        self.stats["per_replica"] = [
            dict(c, occupied_slots=sum(
                s is not None
                for s in self.slots[r * mb:(r + 1) * mb]))
            for r, c in enumerate(self._rep_counters)]
        if self._busy_s > 0:
            self.stats["tokens_per_sec"] = \
                self.stats["tokens_generated"] / self._busy_s


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
