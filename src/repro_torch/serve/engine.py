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
* **paged KV** (``ServeConfig(kv_block_size=..., kv_pool_blocks=...)``):
  slots draw ``block_size``-token blocks from a budget-sized physical
  pool (:mod:`repro_torch.serve.paging`) instead of owning a fixed
  ``max_seq`` row, so concurrency is bounded by actual token footprint.
  Per-slot block tables ride the compiled entries as device tensors
  (the prefill's through a ``TreeSpec``, so they bucket-pad with the
  batch: padded rows get all-null tables), and the gather into dense
  rows and the scatter of the fresh positions happen inside the launch,
  the pool read and written in place.  On pool pressure the scheduler
  preempts a victim (lowest priority, newest admission), releases its
  blocks and requeues the request with prompt + generated tokens: greedy
  recompute reproduces the output.  With an unconstrained pool the paged
  path gives the fixed rows' tokens (``kv_block_size=None``).
* **speculative decoding** (``ServeConfig(speculative=...,
  speculative_k=...)``): a pluggable proposer
  (:mod:`repro_torch.serve.speculative`; ``"ngram"`` prompt lookup, or
  any object with ``.propose(history, k)``) drafts up to k tokens per
  slot, and ONE widened ``(n_slots, k+1)`` launch of ``model.verify``
  (prefill semantics, head at every position) scores them all; each slot
  keeps the longest draft prefix matching the model's own greedy argmax
  plus the correction token.  Greedy accept-or-fix emits the
  plain-decode tokens; only the launch count shrinks.

On the card every attention runs the flash-attention kernel, every
norm its RMSNorm or LayerNorm kernel, every RWKV time mix the WKV kernel,
every Mamba-2 block the SSD kernel and every MoE router the masked
softmax kernel (the model's layers call their wrappers).  On the card
each prefill bucket, the decode step and the verify launch is one CUDA
graph, captured at its first call and replayed after
(:mod:`repro_torch.core.graphs`); the graphs of one engine share a
memory pool.  The compiled entries hold the engine weakly, so a dropped
engine frees its cache, parameters and graphs at once.  The cache (or
the block pool) lives on the card; the engine updates it in place
(prefill's rows by ``index_copy_``; a decode step, a verify launch and
every paged launch inside its graph) where the JAX package rebuilds the
array.  A cache is any tree of layer-stacked leaves with the batch on
axis 1 (the dense KV cache, RWKV's nested recurrent state): row
gathers, scatters, zeroing and gating map over its leaves.

The fault plane is the JAX package's: a launch runs under the
taxonomy's retry ladder (the ``serve.launch`` fault site fires first in
each attempt), a permanent failure fails only its launch group, and
``Request.deadline_s`` retires late requests.  With
``ServeConfig(heartbeat_deadline_s=...)`` each replica must beat
(:meth:`ServeEngine.heartbeat`) within the deadline: a silent replica is
drained, its requests requeued with prompt + generated tokens (greedy
decoding resumes them exactly, through a prefill of those tokens), and
admission routes around it until it beats again.  Each request is one
``request`` async span and each launch one ``serve.prefill`` /
``serve.decode`` / ``serve.verify`` span when a tracer is installed
(host time: a span closes when the launch is queued, or when its CUDA
graph replay is); :meth:`ServeEngine.report` and
``disc_torch.observe()["serve"]`` / ``["health"]`` give the counters.
Under paged KV the ``pool.alloc`` site denies block allocations, and a
request preempted more than ``max_recomputes`` times is retired FAILED
(``PoolExhausted``).  The port has no per-op fallback, so
``kernel_demotions`` stays 0.

Every ``stats`` key is
documented in :data:`STATS_KEYS`.
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
from ..dist.context import spmd_scope
from ..errors import (CONTROL_EXCEPTIONS, DEFAULT_RETRY, CompileError,
                      DiscError, wrap_launch_error)
from ..frontends.fx_frontend import ArgSpec
from ..ft import faults
from ..ft.supervisor import HeartbeatMonitor
from ..models.registry import (Model, cache_batch_axis, gate_rows,
                               replay_prefill,
                               row_keep_mask, tree_map)
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.clock import CLOCK
from .paging import BlockAllocator, PagedKVPool, blocks_for, pick_victim
from .policies import get_admission_policy
from .speculative import get_proposer

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
                         "max_seq, or a worst-case footprint larger than "
                         "the paged pool can ever hold (the rest of the "
                         "batch is still admitted)",
    "peak_active_slots": "max concurrently occupied slots observed (the "
                         "equal-memory concurrency headline for paged KV)",
    "kv_pool_blocks": "paged-KV pool capacity in blocks (0 = fixed rows; "
                      "not reset)",
    "kv_blocks_in_use": "paged-KV blocks currently allocated (not reset)",
    "kv_pool_occupancy": "kv_blocks_in_use / kv_pool_blocks (0.0 under "
                         "fixed rows; not reset)",
    "kv_peak_occupancy": "max pool occupancy fraction observed",
    "kv_preemptions": "slots preempted on pool pressure (request requeued "
                      "with prompt+generated for greedy recompute)",
    "kv_evictions": "blocks reclaimed by preemptions",
    "spec_drafted_tokens": "draft tokens sent to the speculative verify "
                           "launch",
    "spec_accepted_tokens": "draft tokens accepted by verification",
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
                       "failure, recompute budget exhausted under pool "
                       "pressure, deadline expiry) — reasons in "
                       "``engine.failed[rid]``",
    "retries": "transient launch retries (capped exponential backoff); "
               "transient *compile* retries live in the compile cache's "
               "stats",
    "kernel_demotions": "cluster-kernel / backend demotions during this "
                        "engine's run: always 0, the port has no per-op "
                        "fallback (a failed kernel raises)",
    "deadline_expirations": "requests failed because Request.deadline_s "
                            "passed (checked at admission and between "
                            "steps)",
    "replica_drains": "replicas drained after missing the heartbeat "
                      "deadline (slots preempted back to the queue, "
                      "traffic continues on survivors)",
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
    # paged KV pool (repro_torch.serve.paging): block size in tokens, must
    # divide max_seq; None keeps the fixed max_seq-row cache (the parity
    # baseline)
    kv_block_size: Optional[int] = None
    # pool capacity in blocks — the memory budget that replaces
    # n_slots * max_seq.  None = unconstrained (n_slots * max_seq /
    # kv_block_size blocks: the fixed rows' tokens, no preemption)
    kv_pool_blocks: Optional[int] = None
    # speculative decoding (repro_torch.serve.speculative): proposer name
    # ("ngram") or object with .propose(history, k); None disables
    speculative: Optional[Any] = None
    # max draft tokens per slot per verify launch
    speculative_k: int = 4
    # where the model, the KV cache and the artifacts live: the card
    # unless "cpu" is asked for (the kernels' plain versions)
    device: str = "cuda"
    # bounded recompute: a request preempted (and requeued for greedy
    # recompute) on pool pressure more than this many times is retired
    # FAILED with a PoolExhausted reason instead of spinning in the
    # preemption loop forever (None = unbounded)
    max_recomputes: Optional[int] = 50
    # replica health: a replica whose last heartbeat (engine.heartbeat(r))
    # is older than this is drained — its slots preempt back to the queue
    # and admission routes around it until a beat restores it.  None
    # disables monitoring (no drain, no heartbeats required)
    heartbeat_deadline_s: Optional[float] = None
    # SPMD placement (repro_torch.dist): a DeviceMesh with named dims
    # (launch/mesh.py make_mesh) and a profile name or ShardingProfile
    # ("dp" by default under a mesh).  The params follow the profile's
    # weight layout (the model's specs() under "tp"), the KV cache rows
    # the profile's batch axes (cache_specs() under "tp"), and the
    # prefill artifact compiles under CompileOptions(mesh=...).  Every
    # rank runs the same engine loop on the same submissions.
    mesh: Optional[Any] = None
    sharding_profile: Optional[Any] = None


@dataclass
class _Slot:
    """One KV-cache row's scheduler state: admitted requests move
    prefill -> decode -> retired (slot freed); a slot in either live
    state may also be PREEMPTED (pool pressure under paged KV, or a
    replica drain) — its blocks are released and the request requeued
    (prompt+generated) for greedy recompute."""

    rid: int
    tokens: np.ndarray
    plen: int
    remaining: int
    pos: int = 0                  # prompt tokens prefilled so far
    state: str = "prefill"        # "prefill" | "decode"
    generated: List[int] = field(default_factory=list)
    priority: int = 0             # victim ordering on pool pressure
    aseq: int = 0                 # admission sequence (newest preempts first)
    # re-admitted after preemption: the prompt replays previously
    # generated tokens, so the prefill-completion token is NOT the free
    # first token — it consumes max_new budget
    resumed: bool = False


class ServeEngine:
    def __init__(self, model: Model, params, scfg: ServeConfig):
        if scfg.sharding_profile is not None and scfg.mesh is None:
            # mirror CompileOptions: a profile without a mesh is a
            # misconfiguration, not a silent single-device fallback
            raise ValueError(
                "ServeConfig(sharding_profile=...) needs a mesh: pass "
                "ServeConfig(mesh=..., sharding_profile=...)")
        if scfg.mesh is not None:
            from ..dist.context import check_mesh
            check_mesh(scfg.mesh, "ServeConfig")
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
        if scfg.kv_block_size is not None:
            if scfg.kv_block_size < 1:
                raise ValueError(
                    f"ServeConfig(kv_block_size={scfg.kv_block_size}): "
                    f"need a positive block size")
            if scfg.max_seq % scfg.kv_block_size != 0:
                raise ValueError(
                    f"ServeConfig(kv_block_size={scfg.kv_block_size}) must "
                    f"divide max_seq={scfg.max_seq}: full block tables "
                    f"cover exactly max_seq positions so the paged "
                    f"artifacts stay shape-identical to fixed rows")
            if scfg.mesh is not None:
                raise ValueError(
                    "paged KV (kv_block_size=...) does not compose with "
                    "mesh sharding yet: the block-id axis has no "
                    "data-parallel layout — drop the mesh or use fixed "
                    "rows")
        if scfg.speculative is not None and scfg.speculative_k < 1:
            raise ValueError(
                f"ServeConfig(speculative_k={scfg.speculative_k}): need "
                f"at least 1 draft token")
        self.device = resolve_device(scfg.device)
        where = {t.device.type for t in _leaves(params)}
        if where != {self.device.type}:
            raise ValueError(f"ServeEngine on {self.device}: the parameters "
                             f"live on {sorted(where)}")
        self.model = model
        self.params = params
        self.scfg = scfg
        self.n_slots = scfg.replicas * scfg.max_batch
        self.paged = scfg.kv_block_size is not None
        if self.paged:
            self._mbs = scfg.max_seq // scfg.kv_block_size
            n_blocks = (scfg.kv_pool_blocks
                        if scfg.kv_pool_blocks is not None
                        else self.n_slots * self._mbs)
            self.pool = PagedKVPool(model, n_blocks=n_blocks,
                                    block_size=scfg.kv_block_size,
                                    device=self.device)
            self.alloc = BlockAllocator(n_blocks, scfg.kv_block_size,
                                        self.n_slots, self._mbs)
            self.cache = None       # paged state lives in self.pool.tree
        else:
            self._mbs = 0
            self.pool = None
            self.alloc = None
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
        self._recomputes: Dict[int, int] = {}   # rid -> preempt count
        self._deadlines: Dict[int, float] = {}  # rid -> absolute deadline
        self._carry: Dict[int, List[int]] = {}  # rid -> generated-so-far
        self._clock = CLOCK     # deadlines and heartbeats; injectable
        self._wall = CLOCK      # perf timing (busy_s, decode gaps) only
        self._retry = DEFAULT_RETRY
        self._replica_alive = [True] * scfg.replicas
        self.monitor: Optional[HeartbeatMonitor] = None
        if scfg.heartbeat_deadline_s is not None:
            self.monitor = HeartbeatMonitor(
                [f"replica{r}" for r in range(scfg.replicas)],
                deadline_s=scfg.heartbeat_deadline_s)
            now = self._clock()
            for r in range(scfg.replicas):
                self.monitor.beat(f"replica{r}", t=now)
        self._admit_order = get_admission_policy(scfg.admission)
        self._prefill_impl = (model.prefill if scfg.prefill_mode == "batched"
                              else replay_prefill(model.decode_step))
        self._proposer = get_proposer(scfg.speculative)
        self._decode_credit = 0
        self._bucket_pairs: Set[Tuple[int, int]] = set()
        self._busy_s = 0.0
        self._last_decode_t: Optional[float] = None
        self._aseq = 0                  # admission sequence counter
        self._rep_counters = [
            {"admitted": 0, "tokens_generated": 0, "requests_completed": 0}
            for _ in range(scfg.replicas)]

        # SPMD placement: lay the persistent trees out once at init (the
        # per-call argument layouts are the prefill artifact's job)
        self.mesh = scfg.mesh
        self._dp_axes: Tuple[str, ...] = ()
        self._put_args = lambda *xs: xs  # decode-input placement
        if self.mesh is not None:
            self._init_mesh(model)

        # one compile cache shared by the artifacts; entries are keyed by
        # per-artifact fingerprint so prefill/decode/verify never collide
        self.compile_cache = CompileCache("serve", max_entries=64)
        pol = dataclasses.replace(
            scfg.prefill_policy,
            overrides=tuple(scfg.prefill_policy.overrides) + (
                ("B", (scfg.batch_policy.kind, scfg.batch_policy.granule)),))
        dim_b = Dim("B", max=self.n_slots)
        i32 = torch.int32
        # the compiled entries call back into the engine through weak
        # references: a dropped engine frees its cache and parameters at
        # once, without waiting for a gc pass over a cycle.  The paged
        # entries read and write the block pool in place (None spec) and
        # take the block tables as a device input beside the step's own:
        # the prefill's ride a TreeSpec, so they bucket-pad on B with
        # tokens / lens (padded rows carry all-null tables)
        n = self.n_slots
        tables = ([ArgSpec((n, self._mbs), i32, name="tables")]
                  if self.paged else [])
        self._prefill_fn = disc_compile(
            weak_method(self._prefill_paged if self.paged
                        else self._prefill_call),
            specs=[None,                 # params tree
                   # the block pool, or the gathered cache rows (L, B, ...)
                   *([None, TreeSpec({0: "B"})] if self.paged
                     else [TreeSpec({1: "B"})]),
                   ArgSpec((dim_b, Dim("S", max=scfg.max_seq)), i32,
                           name="tokens"),
                   ArgSpec((dim_b,), i32, name="lens"),
                   ArgSpec((dim_b,), i32, name="offsets")],
            options=CompileOptions(pipeline="jit", name="prefill",
                                   policy=pol, device=scfg.device,
                                   escalation_threshold=
                                   scfg.escalation_threshold,
                                   mesh=scfg.mesh,
                                   sharding_profile=scfg.sharding_profile
                                   if scfg.mesh is not None else None,
                                   cache=self.compile_cache))
        self._decode_fn = disc_compile(
            weak_method(self._decode_paged if self.paged
                        else self._decode_step),
            # the parameter and cache trees are read in place (the cache
            # written in place); a step's own inputs are static
            specs=[None, None, *tables, ArgSpec((n, 1), i32, name="tokens"),
                   ArgSpec((n,), i32, name="lens"),
                   ArgSpec((n,), torch.bool, name="active")],
            options=CompileOptions(pipeline="jit", name="decode",
                                   device=scfg.device,
                                   cache=self.compile_cache))
        self._verify_fn = None
        if self._proposer is not None:
            w = scfg.speculative_k + 1
            self._verify_fn = disc_compile(
                weak_method(self._verify_paged if self.paged
                            else self._verify_call),
                specs=[None, None, *tables,
                       ArgSpec((n, w), i32, name="tokens"),
                       ArgSpec((n,), i32, name="dlens"),
                       ArgSpec((n,), i32, name="fills")],
                options=CompileOptions(pipeline="jit", name="verify",
                                       device=scfg.device,
                                       cache=self.compile_cache))
        self.stats: Dict[str, Any] = self._zero_stats()
        self._refresh_stats()
        # weakly held: the registry never keeps the engine (its cache and
        # graph pool on the card) alive
        obs_metrics.register_collector("serve", self._obs_stats,
                                       name="engine")
        obs_metrics.register_collector("health", self._obs_health,
                                       name="engine")

    def _init_mesh(self, model: Model) -> None:
        """Lay params + KV cache out on the mesh per the profile: params
        follow the profile's weight layout, cache rows are partitioned
        along the profile's batch axes on their batch axis (axis 1 of the
        layer-stacked ``(L, B, ...)`` leaves), or follow the model's
        ``cache_specs()`` under ``tp``.  Each rank keeps its own slice of
        the trees every rank built the same way: no collective."""
        from ..dist.profiles import PartitionSpec as P, get_profile
        from ..dist.spmd import fit_spec, mesh_shape, placements_for, \
            shard_tensor

        mesh = self.mesh
        if mesh.device_type != self.device.type:
            raise ValueError(f"ServeConfig(mesh=...) is a "
                             f"{mesh.device_type} mesh, the engine runs on "
                             f"{self.device}")
        profile = get_profile(self.scfg.sharding_profile or "dp")
        self.profile = profile
        sizes = mesh_shape(mesh)
        # the axes the PROFILE shards the batch dim on: the cache layout,
        # the slot-divisibility guard and the decode-input placement all
        # agree with what the prefill artifact's planner emits for "B"
        self._dp_axes = tuple(a for a in profile.batch_axes() if a in sizes)
        dp = 1
        for a in self._dp_axes:
            dp *= sizes[a]
        if dp > 1 and self.n_slots % dp != 0:
            raise ValueError(
                f"replicas*max_batch={self.n_slots} slots must divide the "
                f"batch-sharding mesh axes {self._dp_axes} (size {dp}) "
                f"evenly — adjust replicas/max_batch or the mesh shape")

        def put(x, spec):
            spec = fit_spec(tuple(x.shape), spec, mesh)
            return shard_tensor(x, mesh, placements_for(spec, mesh))

        logical = model.specs() if profile.param_mode == "tp" else None
        pspecs = profile.param_specs(self.params, logical)
        self.params = tree_map(put, self.params, pspecs)
        if profile.param_mode == "tp":
            cspecs = model.cache_specs()
            self.cache = tree_map(put, self.cache, cspecs)
        else:
            def batch_spec(leaf):
                ax = cache_batch_axis(leaf.shape, self.n_slots)
                if ax is None:
                    return P(*([None] * leaf.ndim))
                return profile.batch_leaf_spec(leaf.ndim, ax)

            self.cache = tree_map(lambda c: put(c, batch_spec(c)),
                                  self.cache)
        # decode inputs have fixed shapes: their layouts are decided once
        dp_spec = self._dp_axes if self._dp_axes else None
        places = [placements_for(fit_spec(
            shape, P(*((dp_spec,) + (None,) * (len(shape) - 1))), mesh),
            mesh) for shape in ((self.n_slots, 1), (self.n_slots,),
                                (self.n_slots,))]
        self._put_args = lambda *xs: tuple(
            shard_tensor(x, mesh, pl) for x, pl in zip(xs, places))

    def _whole(self, x):
        """A launch's DTensor output whole on every rank (the host reads
        it), a plain tensor as it is."""
        from ..kernels.sharded import is_dtensor
        return x.full_tensor() if is_dtensor(x) else x

    def _take_rows(self, idx: torch.Tensor):
        """The cache rows ``idx`` of every leaf (batch axis 1)."""
        if self.mesh is None:
            return tree_map(lambda c: c.index_select(1, idx), self.cache)
        from torch.distributed.tensor import DTensor, Replicate

        from ..dist.context import spmd_scope
        idx = DTensor.from_local(idx, self.mesh,
                                 (Replicate(),) * self.mesh.ndim,
                                 run_check=False)
        with spmd_scope(self.mesh):
            return tree_map(lambda c: c.index_select(1, idx), self.cache)

    def _put_rows(self, idx: torch.Tensor, nb: int, new_rows) -> None:
        """Write a prefill's first ``nb`` rows back into cache rows
        ``idx``, in place.  Under a mesh each rank writes the rows its
        shard of the batch axis holds (the rows first laid out as the
        cache leaf, their batch axis whole)."""
        if self.mesh is None:
            tree_map(lambda c, n: c.index_copy_(1, idx,
                                                n[:, :nb].to(c.dtype)),
                     self.cache, new_rows)
            return
        from torch.distributed.tensor import Replicate

        from ..kernels.sharded import _coord, _local, _sharding

        host_idx = idx.tolist()

        def put(c, n):
            place = tuple(c.placements)
            bdims = _sharding(place, 1)
            whole_b = tuple(Replicate() if j in bdims else p
                            for j, p in enumerate(place))
            rows = _local(n, self.mesh, whole_b)[:, :nb].to(c.dtype)
            local = c._local_tensor
            r, m = _coord(self.mesh, bdims) if bdims else (0, 1)
            per = c.shape[1] // m
            mine = [(k, i - r * per) for k, i in enumerate(host_idx)
                    if r * per <= i < (r + 1) * per]
            if mine:
                src = torch.tensor([k for k, _ in mine], device=local.device)
                dst = torch.tensor([i for _, i in mine], device=local.device)
                local.index_copy_(1, dst, rows.index_select(1, src))

        tree_map(put, self.cache, new_rows)

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

    def _verify_call(self, params, cache, tokens, dlens, fills):
        """Speculative verify (fixed rows): one widened chunk pass, written
        into ``cache`` in place as a decode step is, whose per-position
        argmax comes back — ``ids[r, j]`` is the model's greedy token
        after consuming ``tokens[r, j]``.  Rows with ``dlens[r] == 0``
        write nothing (the prefill masks)."""
        logits, new_cache = self.model.verify(params, cache, tokens, dlens,
                                              fills)
        tree_map(lambda c, n: c.copy_(n), cache, new_cache)
        return logits.argmax(-1).to(torch.int32), cache

    def _prefill_paged(self, params, pool, tview, tokens, lens, offsets):
        """Paged prefill: gather each group row's blocks into the dense
        fixed-row layout the attention kernels consume, zero fresh rows,
        run the single-pass prefill, then scatter exactly the freshly
        written positions [offset, offset+len) back into the pool, in
        place.  Bucket-padded rows carry all-null tables: their gathers
        see only the null block (masked out of every real row by the
        length masks) and their writes land back in it."""
        tables = tview["tables"]
        logits, rows = self._prefill_call(params,
                                          self.pool.gather(pool, tables),
                                          tokens, lens, offsets)
        j = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        self.pool.scatter(pool, rows, tables, j < lens[:, None],
                          offsets[:, None] + j)
        return logits, pool

    def _decode_paged(self, params, pool, tables, tokens, lens, active):
        """Paged decode step: gather, step, and scatter only each active
        row's one fresh position ``lens[r]`` (inactive rows write into the
        null block, as the fixed path's ``active`` gate writes nothing)."""
        rows = self.pool.gather(pool, tables)
        logits, rows = self.model.decode_step(params, rows, tokens, lens)
        self.pool.scatter(pool, rows, tables, active[:, None],
                          lens[:, None])
        return logits, pool

    def _verify_paged(self, params, pool, tables, tokens, dlens, fills):
        """Speculative verify over gathered paged rows; the drafted
        positions [fill, fill+dlen) scatter back to the pool."""
        rows = self.pool.gather(pool, tables)
        logits, rows = self.model.verify(params, rows, tokens, dlens, fills)
        j = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        self.pool.scatter(pool, rows, tables, j < dlens[:, None],
                          fills[:, None] + j)
        return logits.argmax(-1).to(torch.int32), pool

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

        Requests the engine can never serve are rejected gracefully —
        counted in ``stats["rejected_requests"]``, rids recorded in
        ``self.rejected`` — and the REST of the batch is still admitted:
        a prompt longer than ``max_seq``, and under paged KV a worst-case
        footprint (prompt + max_new tokens) needing more blocks than the
        whole pool holds.  A rid already pending (queued or in a slot)
        raises, atomically, before anything in the batch is queued: rids
        are the engine's stable identity.
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
            if self.paged:
                worst = min(len(r.tokens) + r.max_new_tokens + 1,
                            self.scfg.max_seq)
                if blocks_for(worst, self.scfg.kv_block_size) \
                        > self.alloc.n_blocks:
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
        request goes to the least-loaded live replica with a free slot
        (ties to the lowest index).  Admitted requests enter the prefill
        state.

        Under paged KV, admission also gates on pool headroom: a request
        is only admitted while the free list covers its first prefill
        chunk (in policy order, no skipping ahead — admitting a slot that
        cannot allocate would just thrash the preemption path).  Blocks
        free up as slots retire, so blocked admission is pressure, not
        deadlock."""
        mb = self.scfg.max_batch
        # a drained replica offers no slots until a heartbeat restores it
        free_by_rep = [[i for i in range(r * mb, (r + 1) * mb)
                        if self.slots[i] is None]
                       if self._replica_alive[r] else []
                       for r in range(self.scfg.replicas)]
        n_free = sum(len(f) for f in free_by_rep)
        if not n_free or not self.queue:
            return
        chunk_cap = self.scfg.prefill_chunk or self.scfg.max_seq
        budget = self.alloc.free_blocks if self.paged else 0
        taken: Set[int] = set()
        for req in self._admit_order(self.queue):
            if len(taken) >= n_free:
                break
            if self.paged:
                need = blocks_for(min(len(req.tokens), chunk_cap),
                                  self.scfg.kv_block_size)
                if need > budget:
                    break
                budget -= need
            taken.add(req.rid)
            rep = min((r for r in range(self.scfg.replicas)
                       if free_by_rep[r]),
                      key=lambda r: (mb - len(free_by_rep[r]), r))
            i = free_by_rep[rep].pop(0)
            toks = np.asarray(req.tokens, np.int32)
            carried = self._carry.pop(req.rid, None)
            self.slots[i] = _Slot(rid=req.rid, tokens=toks,
                                  plen=int(toks.shape[0]),
                                  remaining=req.max_new_tokens,
                                  priority=req.priority,
                                  aseq=self._aseq,
                                  generated=list(carried or ()),
                                  resumed=bool(carried))
            self._aseq += 1
            self.lens[i] = 0
            self._rep_counters[rep]["admitted"] += 1
            if obs_trace.ACTIVE is not None:
                obs_trace.ACTIVE.async_begin(
                    "request", id=req.rid, replica=rep, slot=i,
                    prompt_len=int(toks.shape[0]),
                    resumed=bool(carried))
        self.queue = [r for r in self.queue if r.rid not in taken]

    # -------------------------------------------------------- fault plane --
    def _forget(self, rid: int) -> None:
        """Drop a retired rid's scheduler bookkeeping."""
        self._carry.pop(rid, None)
        self._recomputes.pop(rid, None)
        self._deadlines.pop(rid, None)

    def _fail_request(self, rid: int, reason: str) -> None:
        """Retire ``rid`` FAILED: recorded with its reason, counted, and
        every bookkeeping entry dropped — the rest of the engine keeps
        serving."""
        self.failed[rid] = reason
        self.stats["failed_requests"] += 1
        self._forget(rid)
        if obs_trace.ACTIVE is not None:
            obs_trace.ACTIVE.async_end("request", id=rid, failed=True,
                                       reason=reason)

    def _fail_slot(self, i: int, reason: str) -> None:
        """Fail the request occupying slot ``i`` and free the slot."""
        rid = self.slots[i].rid
        if self.paged:
            self.alloc.release(i)
        self.slots[i] = None
        self.lens[i] = 0
        self._fail_request(rid, reason)

    def _launch(self, kind: str, fn: Callable, *args):
        """Run one artifact launch under the taxonomy: transient failures
        (allocator pressure, injected transients) retry with capped
        exponential backoff; a permanent failure raises a classified
        :class:`~repro_torch.errors.DiscError` for the caller to fail
        exactly the requests in the launch group.

        The ``serve.launch`` fault site fires before the artifact is
        called, so a retried injected fault re-runs a launch that never
        started.  The decode step and the verify launch write the KV
        cache where it lies (in their CUDA graphs too), and so does every
        paged launch write the block pool, so an error such a launch
        raised while it ran is permanent: a retry would apply a partial
        write twice.  A
        :class:`~repro_torch.errors.CompileError` out of its dispatch
        keeps its own class: a failed compile ran nothing, and
        :mod:`repro_torch.core.graphs` makes a failed first call or
        capture transient only where it wrote nothing in place."""
        sp = (obs_trace.ACTIVE.begin(f"serve.{kind}", cat="serve")
              if obs_trace.ACTIVE is not None else None)
        attempt = 0
        ok = False
        try:
            while True:
                started = False
                try:
                    if faults.ACTIVE is not None:
                        faults.ACTIVE.check("serve.launch", key=kind)
                    started = True
                    with spmd_scope(self.mesh):
                        out = fn(*args)
                    ok = True
                    return out
                except CONTROL_EXCEPTIONS:
                    raise
                except DiscError as e:   # already classified (e.g. a
                    err = e              # CompileError out of dispatch)
                except Exception as e:  # noqa: BLE001 — classified below
                    err = wrap_launch_error(e, kind)
                if started and (kind != "prefill" or self.paged) \
                        and not isinstance(err, CompileError):
                    err.transient = False
                if not err.transient or attempt >= self._retry.max_retries:
                    try:
                        raise err
                    finally:
                        # no cycle through this frame (the traceback holds
                        # it, it would hold the error): the engine, its
                        # cache and parameters stay freeable without gc
                        del err
                del err     # nor through a retried attempt's error
                self.stats["retries"] += 1
                obs_metrics.record_event("serve.retry", kind=kind,
                                         attempt=attempt + 1)
                time.sleep(self._retry.delay(attempt))
                attempt += 1
        finally:
            if sp is not None:
                sp.end(attempts=attempt + 1, error=not ok)

    def heartbeat(self, replica: int, *, t: Optional[float] = None) -> None:
        """Record a liveness beat for ``replica`` (requires
        ``ServeConfig(heartbeat_deadline_s=...)``).  A beat from a
        drained replica restores it at the next step."""
        if self.monitor is None:
            raise ValueError(
                "ServeEngine.heartbeat() needs replica health monitoring: "
                "set ServeConfig(heartbeat_deadline_s=...)")
        self.monitor.beat(f"replica{replica}",
                          t=self._clock() if t is None else t)

    def _check_replicas(self) -> None:
        """Drain replicas silent past the heartbeat deadline — their
        slots preempt back to the queue and admission routes around
        them — and restore drained replicas that have beaten again."""
        dead = set(self.monitor.dead_hosts(now=self._clock()))
        mb = self.scfg.max_batch
        for r in range(self.scfg.replicas):
            is_dead = f"replica{r}" in dead
            if is_dead and self._replica_alive[r]:
                self._replica_alive[r] = False
                self.stats["replica_drains"] += 1
                obs_metrics.record_event("replica.drain", replica=r)
                for i in range(r * mb, (r + 1) * mb):
                    if self.slots[i] is not None:
                        self._preempt(i, drain=True)
            elif not is_dead and not self._replica_alive[r]:
                self._replica_alive[r] = True   # restored on recovery
                obs_metrics.record_event("replica.restore", replica=r)

    def _preempt(self, i: int, *, drain: bool = False) -> None:
        """Evict slot ``i`` on pool pressure (or a replica drain): release
        its blocks and requeue the request, at its priority, with prompt
        + generated tokens as the new prompt.  Greedy decoding makes the
        recompute exact: the resumed request continues with the tokens it
        would have produced, through a prefill of those tokens where the
        undisturbed run decoded them one by one.  Its cache rows (or
        blocks) need no clearing: a prefill at offset 0 zeroes its rows
        first.

        Pool-pressure preemptions are bounded by
        ``ServeConfig(max_recomputes=...)``: a request past its budget is
        retired FAILED (PoolExhausted) instead of spinning forever.
        Drain preemptions (a replica fault, not memory pressure) don't
        consume the budget."""
        slot = self.slots[i]
        if not drain and self.scfg.max_recomputes is not None:
            n = self._recomputes.get(slot.rid, 0) + 1
            if n > self.scfg.max_recomputes:
                if self.paged:
                    self.stats["kv_evictions"] += len(self.alloc.owned(i))
                self._fail_slot(
                    i, f"PoolExhausted: preempted {n - 1} times under "
                       f"pool pressure (max_recomputes="
                       f"{self.scfg.max_recomputes})")
                return
            self._recomputes[slot.rid] = n
        if self.paged:
            freed = self.alloc.release(i)
            if not drain:
                self.stats["kv_preemptions"] += 1
                self.stats["kv_evictions"] += freed
        obs_metrics.record_event("preempt", rid=slot.rid, slot=i,
                                 drain=drain)
        toks = slot.tokens
        if slot.generated:
            toks = np.concatenate(
                [toks, np.asarray(slot.generated, np.int32)])
        self._carry[slot.rid] = list(slot.generated)
        self.queue.append(Request(rid=slot.rid, tokens=toks,
                                  max_new_tokens=slot.remaining,
                                  priority=slot.priority))
        self.slots[i] = None
        self.lens[i] = 0

    def _ensure_blocks(self, i: int, n_tokens: int,
                       protect: Set[int]) -> bool:
        """Grow slot ``i``'s allocation to cover ``n_tokens`` positions,
        preempting victims (lowest priority, then newest admission) on
        pool pressure.  ``protect`` shields slots already committed to
        the launch being assembled; returns False only when every
        remaining block owner is protected."""
        while not self.alloc.ensure(i, n_tokens):
            cands = [(j, s.priority, s.aseq)
                     for j, s in enumerate(self.slots)
                     if s is not None and j != i and j not in protect
                     and self.alloc.owned(j)]
            v = pick_victim(cands)
            if v is None:
                return False
            self._preempt(v)
        return True

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
                obs_metrics.record_event("deadline.expire", rid=s.rid)
                self._fail_slot(i, f"DeadlineExceeded: deadline_s passed "
                                   f"after {len(s.generated)} tokens")
        for r in [r for r in self.queue if r.rid in expired]:
            self.stats["deadline_expirations"] += 1
            obs_metrics.record_event("deadline.expire", rid=r.rid)
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
        if self.paged:
            # claim blocks for every member's chunk before building the
            # launch; a member that cannot allocate even after preempting
            # every unprotected victim sheds itself back to the queue
            # (admission re-gates it on pool headroom; the bounded
            # recompute budget turns a permanently starved slot into a
            # PoolExhausted failure instead of a livelock)
            kept = []
            for i, cl in members:
                s = self.slots[i]
                if s is None or s.state != "prefill":
                    continue    # preempted while assembling this launch
                protect = {j for j, _ in kept} | {i}
                if self._ensure_blocks(i, s.pos + cl, protect):
                    kept.append((i, cl))
                else:
                    self._preempt(i)
            members = kept
            if not members:
                return
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
        members_idx = np.asarray([i for i, _ in members])
        if self.paged:
            state = (self.pool.tree,
                     {"tables": self._tensor(self.alloc.table()[members_idx])})
        else:
            idx = self._tensor(members_idx)
            state = (self._take_rows(idx),)
        try:
            logits, new_rows = self._launch(
                "prefill", self._prefill_fn, self.params, *state,
                self._tensor(tokens), self._tensor(lens),
                self._tensor(offsets))
        except DiscError as e:
            # a failed launch fails ONLY this launch group; queued and
            # decode-state requests are untouched
            for i, _ in members:
                self._fail_slot(i, f"LaunchError(prefill): {e}")
            return
        if not self.paged:   # the paged launch wrote its pool in place
            self._put_rows(idx, nb, new_rows)
        logits = self._whole(logits)
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
                if s.resumed:
                    # a resumed prompt replays previously generated
                    # tokens: its completion token is a fresh one and
                    # consumes budget (the free first token was already
                    # granted by the original prefill)
                    s.remaining -= 1
                    s.resumed = False
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
        """One decode launch over ALL replicas' rows; with a proposer
        configured, the launch is the widened speculative verify
        instead."""
        active_idx = [i for i, s in enumerate(self.slots)
                      if s is not None and s.state == "decode"]
        if self._proposer is not None:
            self._decode_speculative(active_idx)
        else:
            self._decode_plain(active_idx)

    def _state(self) -> tuple:
        """The leading arguments of a decode or verify launch after the
        parameters: the cache, or the block pool and the block tables."""
        if self.paged:
            return self.pool.tree, self._tensor(self.alloc.table())
        return (self.cache,)

    def _decode_plain(self, active_idx: List[int]) -> None:
        if self.paged:
            # every active row writes position lens[r]: claim the block
            # first, preempting on pressure; a row that cannot allocate
            # even then (all owners protected) sheds itself
            protect: Set[int] = set()
            for i in list(active_idx):
                s = self.slots[i]
                if s is None or s.state != "decode":
                    continue
                if self._ensure_blocks(i, int(self.lens[i]) + 1, protect):
                    protect.add(i)
                else:
                    self._preempt(i)
            active_idx = [i for i in active_idx
                          if self.slots[i] is not None
                          and self.slots[i].state == "decode"]
            if not active_idx:
                return
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = np.zeros((self.n_slots,), bool)
        for i in active_idx:
            tokens[i, 0] = self.slots[i].generated[-1]
            active[i] = True
        try:
            logits, _ = self._launch(
                "decode", self._decode_fn, self.params, *self._state(),
                *self._put_args(self._tensor(tokens),
                                self._tensor(self.lens),
                                self._tensor(active)))
            logits = self._whole(logits)
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

    def _decode_speculative(self, active_idx: List[int]) -> None:
        """One widened (n_slots, k+1) verify launch: slot r's pending
        token plus up to k drafted tokens; the longest draft prefix
        matching the model's greedy argmax is accepted and the model's
        own token at the first divergence is the correction.  Accept
        counts advance the ``lens`` vector — cache fill moves by
        1 + accepted per launch instead of 1."""
        k = self.scfg.speculative_k
        tokens = np.zeros((self.n_slots, k + 1), np.int32)
        dlens = np.zeros((self.n_slots,), np.int32)
        drafts: Dict[int, np.ndarray] = {}
        protect: Set[int] = set()
        live: List[int] = []
        for i in list(active_idx):
            s = self.slots[i]
            if s is None or s.state != "decode":
                continue    # preempted while assembling this launch
            fill = int(self.lens[i])
            # drafted chunk must fit the row (fill + 1 + drafts <=
            # max_seq - 1) and never draft past the remaining budget
            cap = min(k, self.scfg.max_seq - fill - 2, s.remaining - 1)
            dr = np.zeros((0,), np.int32)
            if cap > 0:
                hist = np.concatenate(
                    [s.tokens, np.asarray(s.generated, np.int32)])
                dr = np.asarray(self._proposer.propose(hist, cap),
                                np.int32).reshape(-1)[:cap]
            dl = 1 + int(dr.shape[0])
            if self.paged:
                if not self._ensure_blocks(i, fill + dl, protect):
                    dr = dr[:0]     # shrink the ask to the bare step
                    dl = 1
                    if not self._ensure_blocks(i, fill + 1, protect):
                        self._preempt(i)
                        continue
                protect.add(i)
            tokens[i, 0] = s.generated[-1]
            tokens[i, 1:dl] = dr
            dlens[i] = dl
            drafts[i] = dr
            live.append(i)
        if not live:
            return
        fills = self.lens.copy()
        try:
            ids, _ = self._launch(
                "verify", self._verify_fn, self.params, *self._state(),
                self._tensor(tokens), self._tensor(dlens),
                self._tensor(fills))
        except DiscError as e:
            for i in live:
                self._fail_slot(i, f"LaunchError(verify): {e}")
            return
        ids = self._whole(ids).tolist()
        self._mark_decode_launch()
        for i in live:
            s = self.slots[i]
            dr = drafts[i]
            dl = int(dlens[i])
            a = 0
            while a < dl - 1 and ids[i][a] == int(dr[a]):
                a += 1
            # emitted = accepted drafts + the model's correction token;
            # rejected positions beyond fill+a+1 stay stale in the cache
            # but are masked (>= fill) until overwritten
            emitted = [int(x) for x in dr[:a]] + [ids[i][a]]
            self.stats["spec_drafted_tokens"] += dl - 1
            self.stats["spec_accepted_tokens"] += a
            kept = 0
            for tok in emitted:
                s.generated.append(tok)
                s.remaining -= 1
                kept += 1
                self.stats["tokens_generated"] += 1
                self._rep_counters[self._replica_of(i)][
                    "tokens_generated"] += 1
                if tok == self.scfg.eos_id or s.remaining <= 0:
                    break
            self.lens[i] = int(fills[i]) + kept
            self._maybe_retire(i)

    def _maybe_retire(self, i: int) -> None:
        slot = self.slots[i]
        if (slot.remaining <= 0 or slot.generated[-1] == self.scfg.eos_id
                or self.lens[i] >= self.scfg.max_seq - 1):
            self.done[slot.rid] = slot.generated
            self.stats["requests_completed"] += 1
            self._forget(slot.rid)
            if obs_trace.ACTIVE is not None:
                obs_trace.ACTIVE.async_end("request", id=slot.rid,
                                           tokens=len(slot.generated))
            self._rep_counters[self._replica_of(i)][
                "requests_completed"] += 1
            if self.paged:
                # normal retirement, not an eviction: blocks just return
                self.alloc.release(i)
            self.slots[i] = None
            self.lens[i] = 0

    def step(self) -> None:
        """One engine iteration: admit, then either a prefill launch or a
        decode step — the ``prefill_interleave`` budget decides which when
        both kinds of work are pending."""
        t0 = self._wall()
        if self.monitor is not None:
            self._check_replicas()
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
    def report(self) -> Dict[str, Any]:
        """Engine health + stats in one structured view.

        ``report()["health"]`` is the fault plane's summary: replica
        liveness (with last-beat ages under monitoring), FAILED requests
        with their reasons, the fault counters, compile-cache
        retry/escalation-failure totals, and the kernel demotions of this
        engine's run (the JAX package's key; always empty here, as the
        port has no per-op fallback)."""
        return {"health": self._obs_health(), "stats": dict(self.stats),
                "compiles": self.compile_counts()}

    def _obs_health(self) -> Dict[str, Any]:
        """The ``report()["health"]`` payload — also registered as the
        pull collector behind ``disc_torch.observe()["health"]["engine"]``."""
        now = self._clock()
        replicas = []
        for r, alive in enumerate(self._replica_alive):
            entry: Dict[str, Any] = {"replica": r, "alive": bool(alive)}
            if self.monitor is not None:
                seen = self.monitor.last_seen[f"replica{r}"]
                entry["last_beat_age_s"] = round(now - seen, 3)
            replicas.append(entry)
        cs = self.compile_cache.stats
        return {
            "alive_replicas": int(sum(self._replica_alive)),
            "replicas": replicas,
            "failed": {rid: self.failed[rid]
                       for rid in sorted(self.failed)},
            "counters": {k: self.stats[k] for k in
                         ("failed_requests", "retries", "kernel_demotions",
                          "deadline_expirations", "replica_drains")},
            "compile": {"retries": cs.retries,
                        "escalation_failures": cs.escalation_failures},
            "kernel_demotions": [],
        }

    def _obs_stats(self) -> Dict[str, Any]:
        """Pull collector behind ``disc_torch.observe()["serve"]["engine"]``
        — the same counters as :attr:`stats`, refreshed at snapshot
        time."""
        self._refresh_stats()
        out = dict(self.stats)
        out["per_replica"] = [dict(c) for c in self.stats["per_replica"]]
        return out

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-artifact compile counts (``{"bucket", "exact", "total"}``
        each) — the observable O(#buckets) contract."""
        zero = {"bucket": 0, "exact": 0, "total": 0}

        def counts(fn):
            try:
                return fn.compile_counts()
            except AttributeError:  # not compiled yet (no calls)
                return dict(zero)

        out = {"prefill": counts(self._prefill_fn),
               "decode": counts(self._decode_fn)}
        if self._verify_fn is not None:
            out["verify"] = counts(self._verify_fn)
        return out

    def _zero_stats(self) -> Dict[str, Any]:
        """A typed zero value for every :data:`STATS_KEYS` entry."""
        z: Dict[str, Any] = {k: 0 for k in STATS_KEYS}
        for k in ("tokens_per_sec", "max_decode_gap_s",
                  "kv_pool_occupancy", "kv_peak_occupancy"):
            z[k] = 0.0
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
        if self.paged:
            self.stats["kv_pool_blocks"] = self.alloc.n_blocks
            self.stats["kv_blocks_in_use"] = self.alloc.used_blocks
            frac = self.alloc.used_blocks / self.alloc.n_blocks
            self.stats["kv_pool_occupancy"] = frac
            self.stats["kv_peak_occupancy"] = max(
                self.stats["kv_peak_occupancy"], frac)
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
