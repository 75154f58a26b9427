#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which stops the run with a non-zero exit when it fails:

1. **Card.**  Prints ``nvidia-smi``'s name and power limit and
   ``torch.cuda.get_device_name()``.  Then lowers path 2's functions and
   starts building every CUDA library the run needs (path 2's kDot
   epilogues and the §4.5 library, both dtypes), one ``nvcc`` each, all
   at once, in the background while path 1 runs.
2. **Path 1.**  Compiles TinyLlama-1.1B's decoder stack at full width
   (d_model 2048, 32/4 heads, d_ff 5632, 22 layers unrolled, ``ln_f`` and
   the 32000-wide head; random weights drawn on the card from a seeded
   ``torch.Generator``) with ``disc_torch.compile(..., backend="hopper")``,
   once in f32 and once in bf16, and serves requests of S = 37, 200, 731,
   1500, 1999 and then 45 (the bucket of 37: a cache hit).  Each output is
   held against the same model function run eagerly on the card:
   max|Δ|/max|ref| ≤ 1e-3 in f32 and ≤ 2e-2 in bf16; a bf16 output is
   also held against the function evaluated in f32 over the same weights,
   and may lie at most 1.25 times as far from it as eager's bf16
   output does.  Checks compiles ==
   distinct buckets, the cluster kernels' runs, and the launch counts of
   the kernels in that run (a kernel that fails raises: the path has no
   per-op fallback to count).
3. **Kernels.**  Holds every kernel program path 1 launched (recorded
   from one extra, uncounted run at S = 1999) against its plain version
   on the same card inputs, through the wrappers the path calls, in f32
   and bf16: at the path's ``n_valid`` and at one below the padded size,
   whose tails must be exactly zero.  kLoop must match bit for bit; a
   kInput sum row may differ by its f32 summation order, bounded
   relative to the row's sum of magnitudes.  Times kernel, plain version
   and (where one exists) a single PyTorch call with CUDA events at the
   path's ``n_valid``, and computes each kernel's bound from the bytes
   it must move.
4. **Path 2.**  The same model with a token-major residual stream,
   x (T, 2048): the layer functions composed so that the MLP's
   projections are plain 2-D dots, which the planner fuses with their
   epilogues into kDot clusters (``x @ w_gate`` with ``silu(g) * h``,
   ``h @ w_out`` with the residual add).  Same requests, limits and
   checks as path 1, and kDot cluster runs == GEMM-epilogue launches > 0.
5. **kDot kernel.**  Every kDot program path 2 launched (recorded at
   T = 1999) against ``matmul_fused_ref`` on the same card inputs: at the
   path's valid M, at a smaller valid M, and once with ragged N and K;
   max|Δ|/max|ref| ≤ 1e-5 (f32) and ≤ 8e-3 (bf16), padded tails exactly
   zero.  Timed against its plain version and ``torch.matmul`` on the
   same operands (the GEMM alone, without the epilogue); its bound is
   the larger of bytes over 3.35 TB/s and 2·M·N·K over the peak of its
   type (67 TFLOP/s f32 FFMA; 989 TFLOP/s dense bf16 tensor cores).
6. **Library.**  ``core.library.pick`` at shapes from TinyLlama's widths
   that select each of the five §4.5 versions and the vendor entry,
   once through ``pick`` (the counted run), then each version against
   ``matmul_ref`` under the same limits, timed like the kDot kernel.
7. Prints the kernels line, the card line, and the result line last.

Run it from a checkout: it builds the kernels from ``src/`` into
``build/torch_kernels/`` and refuses to run without the repository or
without a CUDA device.  ``--layers`` cuts the depth of both paths.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (700 W): HBM bytes/s, f32 non-tensor flop/s
# and dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

REQUESTS = (37, 200, 731, 1500, 1999, 45)
TOL_PATH = {"f32": 1e-3, "bf16": 2e-2}
# bf16 runs are also held against the same function evaluated in f32 over
# the same bf16-valued weights: eager's bf16 output itself lies up to
# 1.8e-2 from it on an H100 (PERF.md), and the compiled path may lie at
# most this factor further from it than eager does
ACCURACY_RATIO = 1.25
# kInput vs its plain version, per row, relative to the row's sum of
# magnitudes: f32 sums differ by summation order only; a bf16 result by
# at most one rounding step (2^-7) of the stored value.  kLoop computes
# each op exactly as eager does and must match bit for bit.
TOL_REDUCE_ROW = {"f32": 1e-5, "bf16": 8e-3}
# GEMM kernels vs their plain versions, max|Δ|/max|ref|: f32 differs by
# the summation order over K ≤ 5632; bf16 by about two bf16 roundings
# (2^-8 each) through the accumulator cast and the epilogue
TOL_GEMM = {"f32": 1e-5, "bf16": 8e-3}

KERNELS = {
    "fused_elementwise": {
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_elementwise/fused_elementwise.py",
        "replaces": "src/repro/kernels/fused_elementwise/fused_elementwise.py:51",
    },
    "fused_reduce": {
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_reduce/fused_reduce.py",
        "replaces": "src/repro/kernels/fused_reduce/fused_reduce.py:48",
    },
    "matmul_epilogue": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cuh",
        "replaces": "src/repro/kernels/matmul/matmul.py:116",
    },
    "matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cuh",
        "replaces": "src/repro/kernels/matmul/matmul.py:54",
    },
}

# §4.5 library phase: a shape from TinyLlama's widths per entry, and the
# entry the reference's selection rules give it
LIBRARY_SHAPES = {
    "library:square_big": (2048, 2048, 5632),
    "library:balanced": (1024, 2048, 256),
    "library:skinny_m": (32, 2048, 2048),
    "library:skinny_n": (512, 2048, 32),
    "library:deep_k": (256, 5632, 256),
    "vendor:torch_matmul": (37, 2048, 2048),
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing --

def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms of ``fn`` per call, each call after an L2 flush (the
    path's callers find a cluster's operands mostly out of the 50 MB L2:
    each layer streams ~150 MB of weights).  A spin kernel ahead of the
    start event keeps the card busy while the host enqueues ``fn``, so the
    interval holds device time, not host launch overhead."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def unique_bytes(t) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast view reads its
    source once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


# -------------------------------------------------------------- model --

def build(cfg, dtype_name: str, seed: int) -> dict:
    """Path 1: the model's own stack over hidden states (1, S, D)."""
    import torch

    import disc_torch
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init(cfg, gen, "cuda")
    dt = torch.float32 if dtype_name == "f32" else torch.bfloat16

    def make_fn(params):
        def fn(x):
            return T.decoder_logits(cfg, params, x)
        return fn

    fn = make_fn(params)
    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((1, disc_torch.Dim("S", max=2048), cfg.d_model), dt)],
        backend="hopper")
    low = f.lower()
    return dict(fn=fn, f=f, low=low, dt=dt, dim="S", params=params,
                make_fn=make_fn,
                lower_s=time.perf_counter() - t0,
                shape=lambda s: (1, s, cfg.d_model),
                out_shape=lambda s: (1, s, cfg.vocab))


def build_token_major(cfg, dtype_name: str, seed: int) -> dict:
    """Path 2: the layer functions over a token-major residual stream,
    x (T, D), so the MLP's projections are plain 2-D dots (kDot)."""
    import torch

    import disc_torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init(cfg, gen, "cuda")
    dt = torch.float32 if dtype_name == "f32" else torch.bfloat16

    def make_fn(params):
        def fn(x):                               # x (T, 2048)
            pos = torch.arange(x.shape[0], dtype=torch.int32,
                               device=x.device)[None, :]
            for bp in params["blocks"]:
                h = L.norm_apply(cfg, bp["ln1"], x)
                a, _ = L.attn_apply(cfg, bp["attn"], h[None], positions=pos)
                x = x + a[0]
                x = x + L.mlp_apply(cfg, bp["ffn"],
                                    L.norm_apply(cfg, bp["ln2"], x))
            return T.logits_from_hidden(cfg, params,
                                        L.norm_apply(cfg, params["ln_f"], x))
        return fn

    fn = make_fn(params)
    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((disc_torch.Dim("T", max=2048), cfg.d_model), dt)],
        backend="hopper")
    low = f.lower()
    return dict(fn=fn, f=f, low=low, dt=dt, dim="T", params=params,
                make_fn=make_fn,
                lower_s=time.perf_counter() - t0,
                shape=lambda s: (s, cfg.d_model),
                out_shape=lambda s: (s, cfg.vocab))


def to_f32(tree):
    """A parameter tree with every tensor upcast to f32 (exactly)."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def start_cuda_builds(arts: list):
    """Build every CUDA library the run launches, one ``nvcc`` each, all
    started together, in a background thread; returns the thread and the
    dict it fills with its seconds (or its error)."""
    import threading

    import torch

    from repro_torch.core.codegen import kdot_jobs
    from repro_torch.kernels.matmul.matmul import (LIBRARY_TILES,
                                                   identity_program,
                                                   prebuild)

    jobs = []
    for art in arts:
        jobs += [(p, dt, ("kdot",))
                 for p, dt in kdot_jobs(art["low"].graph, art["low"].plan)]
    jobs += [(identity_program(dt), dt, LIBRARY_TILES)
             for dt in (torch.float32, torch.bfloat16)]
    result: dict = {"sources": len(jobs)}

    def run():
        t0 = time.perf_counter()
        try:
            prebuild(jobs)
        except Exception as e:  # reported when the thread is joined
            result["error"] = e
        result["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run, name="nvcc-builds")
    th.start()
    return th, result


class Recorder:
    """Records the first call of each distinct kernel program (uncounted
    run) so the kernel phase can replay it at the path's shapes."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr
        from repro_torch.kernels.matmul import ops as mm

        self._saved = (fe.fused_elementwise, fr.fused_reduce,
                       mm.matmul_fused)
        orig_fe, orig_fr, orig_mm = self._saved

        def rec_fe(program, inputs, n_valid, shape):
            key = ("fused_elementwise", program.key, tuple(shape))
            if key not in self.calls:
                self.calls[key] = dict(program=program, inputs=list(inputs),
                                       n_valid=n_valid, shape=tuple(shape),
                                       count=0)
            self.calls[key]["count"] += 1
            return orig_fe(program, inputs, n_valid, shape)

        def rec_fr(program, inputs, n_valid_cols, kind="sum", *, axis=-1,
                   shape, out_dtype=None):
            key = ("fused_reduce", program.key, tuple(shape), kind, axis)
            if key not in self.calls:
                self.calls[key] = dict(program=program, inputs=list(inputs),
                                       n_valid=n_valid_cols, kind=kind,
                                       axis=axis, shape=tuple(shape),
                                       out_dtype=out_dtype, count=0)
            self.calls[key]["count"] += 1
            return orig_fr(program, inputs, n_valid_cols, kind, axis=axis,
                           shape=shape, out_dtype=out_dtype)

        def rec_mm(a, b, extras, program, *, valid_mnk, out_dtypes):
            key = ("matmul_epilogue", program.key, tuple(a.shape),
                   tuple(b.shape))
            if key not in self.calls:
                self.calls[key] = dict(program=program, a=a, b=b,
                                       extras=list(extras),
                                       valid=tuple(valid_mnk),
                                       out_dtypes=tuple(out_dtypes),
                                       count=0)
            self.calls[key]["count"] += 1
            return orig_mm(a, b, extras, program, valid_mnk=valid_mnk,
                           out_dtypes=out_dtypes)

        fe.fused_elementwise, fr.fused_reduce, mm.matmul_fused = \
            rec_fe, rec_fr, rec_mm
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr
        from repro_torch.kernels.matmul import ops as mm

        fe.fused_elementwise, fr.fused_reduce, mm.matmul_fused = self._saved
        return False


def path_phase(path: str, art: dict, dtype_name: str, seed: int,
               cfg, report: dict):
    """Serve ``REQUESTS`` through the compiled function of ``art``, hold
    each against eager, check compiles and kernel launches; returns the
    kernel calls recorded from one extra, uncounted run at 1999 tokens."""
    import torch

    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.matmul import ops as mm

    fn, f, low, dt = art["fn"], art["f"], art["low"], art["dt"]
    tag = f"[{path} {dtype_name}]"
    templates = low.plan.template_counts()
    print(f"{tag} lowered {cfg.n_layers} layers in {art['lower_s']:.2f} s: "
          f"{low.plan.stats()} templates={templates}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    inputs = {s: torch.randn(art["shape"](s), generator=gen,
                             device="cuda").to(dt) for s in REQUESTS}
    buckets = set()
    kern = f.backend.cluster_kernels
    counters = {"fused_elementwise": fe.LAUNCHES,
                "fused_reduce": fr.LAUNCHES,
                "matmul_epilogue": mm.EPILOGUE_LAUNCHES}
    runs0 = {t: k.runs for t, k in kern.items()}
    for c in counters.values():
        c.reset()
    rows = []
    for s in REQUESTS:
        before = f.compile_counts()["total"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = f(inputs[s])
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        after = f.compile_counts()["total"]
        key = f.policy.bucket(art["dim"], s)
        buckets.add(key)
        rows.append((s, key, dt_s, after - before, y))
        if s == 45:
            check(after == before, f"{tag} {s} compiled anew (bucket {key})")
    launches = {name: c.launches for name, c in counters.items()}
    fn32 = None
    if dt != torch.float32:
        # the same function over the same (bf16-valued) weights and
        # inputs, evaluated in f32: how far each bf16 run is from it
        fn32 = art["make_fn"](to_f32(art["params"]))
    for s, key, dt_s, compiled, y in rows:
        with torch.no_grad():
            ref = fn(inputs[s])
            ref32 = None if fn32 is None else fn32(inputs[s].float())
        torch.cuda.synchronize()
        check(tuple(y.shape) == art["out_shape"](s),
              f"{tag} shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{tag} {s}: non-finite output")
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rel = err / scale
        vs32 = ""
        if ref32 is not None:
            s32 = ref32.abs().max().item()
            c32 = (y.float() - ref32).abs().max().item() / s32
            e32 = (ref.float() - ref32).abs().max().item() / s32
            vs32 = f" vs_f32: compiled={c32:.3e} eager={e32:.3e}"
        print(f"{tag} {art['dim']}={s:5d} bucket={key:5d} "
              f"compiled={compiled} latency_s={dt_s:.4f} max|d|={err:.4e} "
              f"max|ref|={scale:.4e} rel={rel:.3e}{vs32}", flush=True)
        tol = TOL_PATH[dtype_name]
        check(rel <= tol, f"{tag} {s}: rel {rel:.3e} > {tol}")
        if ref32 is not None:
            check(c32 <= ACCURACY_RATIO * e32,
                  f"{tag} {s}: {c32:.3e} from the f32 evaluation, eager "
                  f"{e32:.3e}")
        del ref, ref32
    counts = f.compile_counts()
    runs = {t: k.runs - runs0[t] for t, k in kern.items()}
    print(f"{tag} compile_counts={counts} "
          f"distinct_buckets={sorted(buckets)} cache={f.cache_stats()}",
          flush=True)
    print(f"{tag} cluster runs: " + ", ".join(
        f"{t}={n}" for t, n in runs.items()) + f"; launches={launches}",
        flush=True)
    check(counts["total"] == len(buckets),
          f"{tag} {counts['total']} compiles for {len(buckets)} buckets")
    for template, name in (("kLoop", "fused_elementwise"),
                           ("kInput", "fused_reduce"),
                           ("kDot", "matmul_epilogue")):
        if templates.get(template):
            check(runs[template] > 0
                  and launches[name] == runs[template],
                  f"{tag} {template}: runs={runs[template]} "
                  f"launches={launches}")
        else:
            check(launches[name] == 0, f"{tag} {name} launched off-plan")
    if templates.get("kDot"):
        want = templates["kDot"] * len(REQUESTS)
        print(f"{tag} kDot runs {runs['kDot']}, plan predicts "
              f"{templates['kDot']} per request x {len(REQUESTS)} = {want}",
              flush=True)
    report[(path, dtype_name)] = dict(launches=launches, compiles=counts,
                                      lower_s=art["lower_s"])

    # one extra, uncounted run records every kernel program at 1999
    with Recorder() as rec:
        f(inputs[1999])
        torch.cuda.synchronize()
    return rec.calls


def retype(program, dt):
    """The same program with its float32 values stored in ``dt``."""
    import dataclasses

    import torch

    from repro_torch.kernels.program import Program

    sw = (lambda d: dt if d == torch.float32 else d)
    steps = tuple(dataclasses.replace(st, dtype=sw(st.dtype),
                                      param=sw(st.param)
                                      if st.opcode == "convert" else st.param)
                  for st in program.steps)
    return Program(tuple(sw(d) for d in program.in_dtypes), steps,
                   program.outs)


def one_call(program, xs):
    """A single PyTorch call computing a one-step kLoop program over its
    inputs (the library call it is timed against), or ``None``."""
    import torch

    fns = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "max": torch.maximum, "min": torch.minimum,
           "exp": torch.exp, "tanh": torch.tanh, "logistic": torch.sigmoid,
           "rsqrt": torch.rsqrt, "sqrt": torch.sqrt, "neg": torch.neg,
           "abs": torch.abs, "log": torch.log}
    if len(program.steps) != 1 or program.outs != (("t", 0),):
        return None
    st = program.steps[0]
    fn = fns.get(st.opcode)
    args = []
    for kind, x in st.args:
        if kind != "in" or program.in_dtypes[x] != st.dtype:
            return None
        args.append(xs[x])
    return None if fn is None else (lambda: fn(*args))


def reduce_rows_ok(program, xs, n_cols, kind, ax, shape, out_k, out_p,
                   dname) -> bool:
    """kInput kernel vs plain version, row by row: max/min exactly; a sum
    within ``TOL_REDUCE_ROW`` of the row's sum of magnitudes; a product
    within it of the product's magnitude."""
    import torch

    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
    from repro_torch.kernels.program import Program, Step

    d = (out_k.float() - out_p.float()).abs()
    if kind in ("max", "min"):
        return d.max().item() == 0
    if kind == "sum":
        src = program.outs[0]
        mag_prog = Program(program.in_dtypes, program.steps + (
            Step("abs", (src,), program.dtype_of(src)),),
            (("t", len(program.steps)),))
        mag = fused_reduce_ref(mag_prog, xs, n_cols, "sum", ax, shape,
                               torch.float32)
    else:
        mag = out_p.float().abs()
    return bool((d <= TOL_REDUCE_ROW[dname] * mag).all())


def kernel_phase(calls: dict, dtype_name: str, launches: dict, rows: list):
    """Each recorded program through the wrapper the path calls, against
    its plain version on the same card inputs."""
    import torch

    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_elementwise.ref import \
        fused_elementwise_ref
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref

    def launched(counter, fn):
        before = counter.launches
        out = fn()
        check(counter.launches == before + 1,
              f"wrapper launched {counter.launches - before} kernels")
        return out

    variants = [(dtype_name, c) for k, c in calls.items()
                if k[0] in ("fused_elementwise", "fused_reduce")]
    if dtype_name == "f32":
        # kInput reaches the path in f32 only; hold it in bf16 as well
        variants += [("bf16", dict(c, program=retype(c["program"],
                                                     torch.bfloat16),
                                   inputs=[x.to(torch.bfloat16)
                                           for x in c["inputs"]],
                                   out_dtype=torch.bfloat16))
                     for k, c in calls.items() if k[0] == "fused_reduce"]
    for dname, c in variants:
        prog, xs, shape = c["program"], c["inputs"], c["shape"]
        total = math.prod(shape)
        n_path = c["n_valid"]
        lib_err = None
        if "kind" in c:
            name = "fused_reduce"
            kind, ax, out_dtype = c["kind"], c["axis"] % len(shape), \
                c["out_dtype"]

            def run_k(n):
                return fr.fused_reduce(prog, xs, n, kind, axis=ax,
                                       shape=shape, out_dtype=out_dtype)

            def run_p(n):
                return fused_reduce_ref(prog, xs, n, kind, ax, shape,
                                        out_dtype)

            err, scale, ok = 0.0, 0.0, True
            # the path's valid columns, and fewer than the padded size
            for n in sorted({n_path, shape[ax] - 48}):
                out_k = launched(fr.LAUNCHES, lambda: run_k(n))
                out_p = run_p(n)
                torch.cuda.synchronize()
                err = max(err, (out_k.float() - out_p.float())
                          .abs().max().item())
                scale = max(scale, out_p.float().abs().max().item())
                ok = ok and reduce_rows_ok(prog, xs, n, kind, ax, shape,
                                           out_k, out_p, dname)
            tails_ok = True  # masked columns are inside the reduction
            rows_n = total // shape[ax]
            in_bytes = sum(unique_bytes(x) * n_path // shape[ax]
                           if x.stride()[ax] != 0 else unique_bytes(x)
                           for x in [torch.broadcast_to(t, shape) for t in xs])
            out_bytes = rows_n * out_k.element_size()
            ops = (len(prog.steps) + 1) * rows_n * n_path
            lib = None
            st = prog.steps
            if (len(st) == 1 and st[0].opcode == "mul"
                    and st[0].args == (("in", 0), ("in", 0))
                    and kind == "sum" and ax == len(shape) - 1):
                xv = xs[0][..., :n_path]
                lib = lambda: torch.linalg.vecdot(xv, xv, dim=-1)
        else:
            name = "fused_elementwise"

            def run_k(n):
                return fe.fused_elementwise(prog, xs, n, shape)

            def run_p(n):
                return fused_elementwise_ref(prog, xs, n, shape)

            err, scale, tails_ok = 0.0, 0.0, True
            # the path's n_valid, and one below the padded size
            for n in sorted({n_path, total - 3 * shape[-1] - 5}):
                outs_k = launched(fe.LAUNCHES, lambda: run_k(n))
                outs_p = run_p(n)
                torch.cuda.synchronize()
                for a, b in zip(outs_k, outs_p):
                    err = max(err, (a.float() - b.float()).abs().max().item())
                    scale = max(scale, b.float().abs().max().item())
                tails_ok = tails_ok and all(
                    bool((o.reshape(-1)[n:] == 0).all()) for o in outs_k)
            ok = err == 0
            in_bytes = sum(unique_bytes(torch.broadcast_to(t, shape))
                           for t in xs)
            out_bytes = sum(o.numel() * o.element_size() for o in outs_k)
            ops = len(prog.steps) * total
            lib = one_call(prog, xs) if n_path == total else None
            if lib is not None:
                want = run_k(n_path)[0]
                lib_err = (lib().float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: run_k(n_path))
        plain_ms = cuda_ms(lambda: run_p(n_path))
        lib_ms = cuda_ms(lib) if lib is not None else None
        bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_s = ops / F32_FLOPS * 1e3
        bound_ms = max(bytes_s, ops_s)
        row = dict(name=name, **KERNELS[name],
                   launches=launches.get(name, 0) if dname == dtype_name
                   else 0,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by="bytes" if bytes_s >= ops_s else "operations",
                   library_ms=lib_ms)
        detail = dict(dtype=dname, program=prog.key, shape=list(shape),
                      n_valid=n_path, steps=[s.opcode for s in prog.steps],
                      path_launches_of_program=c["count"]
                      if dname == dtype_name else 0,
                      bytes=in_bytes + out_bytes, max_ref=scale,
                      library_max_abs_err=lib_err)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(ok, f"{name} {dname} {prog.key}: max|d| {err:.3e} "
                  f"(max|ref| {scale:.3e})")
        check(tails_ok, f"{name} {dname} {prog.key}: padded tail not zero")
        rows.append((row, detail))


def gemm_bound(a_bytes: int, b_bytes: int, other_bytes: int, flops: int,
               dname: str):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the flops over the peak of the type (f32: FFMA, since the work is
    IEEE f32; bf16: the dense tensor-core rate)."""
    bytes_ms = (a_bytes + b_bytes + other_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (F32_FLOPS if dname == "f32" else BF16_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def gemm_phase(calls: dict, dtype_name: str, launches: dict, rows: list):
    """Each recorded kDot program through the wrapper the path calls,
    against ``matmul_fused_ref`` on the same card inputs: at the path's
    valid M, at a smaller valid M, and with ragged N and K."""
    import torch

    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.ref import matmul_fused_ref

    name = "matmul_epilogue"
    tol = TOL_GEMM[dtype_name]
    for c in [c for k, c in calls.items() if k[0] == name]:
        prog = c["program"]
        gen = torch.Generator(device="cuda").manual_seed(7)
        m, k = c["a"].shape
        n = c["b"].shape[1]
        vm, vn, vk = c["valid"]
        # ragged N and K beside the path's shapes: 2000 x 1000 x 1000
        ra = torch.randn((2000, 1000), generator=gen,
                         device="cuda").to(c["a"].dtype)
        rb = (torch.randn((1000, 1000), generator=gen, device="cuda")
              / 32).to(c["b"].dtype)
        rx = [torch.randn((2000, 1000), generator=gen,
                          device="cuda").to(dt) for dt in prog.in_dtypes[1:]]
        cases = [("path", c["a"], c["b"], c["extras"], (vm, vn, vk)),
                 ("small_m", c["a"], c["b"], c["extras"],
                  (min(vm, 1000), vn, vk)),
                 ("ragged_nk", ra, rb, rx, (1990, 997, 999))]
        err, scale, worst = 0.0, 0.0, 0.0
        for label, a, b, xs, valid in cases:
            before = mm.EPILOGUE_LAUNCHES.launches
            outs_k = mm.matmul_fused(a, b, xs, prog, valid_mnk=valid,
                                     out_dtypes=c["out_dtypes"])
            check(mm.EPILOGUE_LAUNCHES.launches == before + 1,
                  "matmul_fused launched no kernel")
            outs_p = matmul_fused_ref(a, b, xs, prog, valid, c["out_dtypes"])
            torch.cuda.synchronize()
            for ok_, op_ in zip(outs_k, outs_p):
                e = (ok_.float() - op_.float()).abs().max().item()
                sc = op_.float().abs().max().item()
                err, scale = max(err, e), max(scale, sc)
                worst = max(worst, e / sc if sc else e)
                check(not ok_[valid[0]:].any() and not ok_[:, valid[1]:].any(),
                      f"{name} {dtype_name} {prog.key} {label}: padded "
                      f"tail not zero")
            print(f"[gemm] {name} {dtype_name} {prog.key} {label} "
                  f"shape=({a.shape[0]},{a.shape[1]},{b.shape[1]}) "
                  f"valid={valid} rel={worst:.3e}", flush=True)
        a, b, xs = c["a"], c["b"], c["extras"]

        def run_k():
            return mm.matmul_fused(a, b, xs, prog, valid_mnk=(vm, vn, vk),
                                   out_dtypes=c["out_dtypes"])

        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(lambda: matmul_fused_ref(a, b, xs, prog,
                                                    (vm, vn, vk),
                                                    c["out_dtypes"]))
        # the library call: the GEMM alone, without the epilogue
        lib_ms = cuda_ms(lambda: torch.matmul(a[:vm, :vk], b[:vk, :vn]))
        elt = a.element_size()
        x_bytes = 0
        for x in xs:
            v = torch.broadcast_to(x, (m, n))
            x_bytes += (vm if v.stride(0) else 1) * \
                (vn if v.stride(1) else 1) * v.element_size()
        out_bytes = sum(m * n * torch.empty((), dtype=dt).element_size()
                        for dt in c["out_dtypes"])
        bound_ms, bound_by = gemm_bound(vm * vk * elt, vk * vn * elt,
                                        x_bytes + out_bytes,
                                        2 * vm * vn * vk, dtype_name)
        row = dict(name=name, **KERNELS[name],
                   launches=launches.get(name, 0), max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib_ms)
        detail = dict(dtype=dtype_name, program=prog.key,
                      shape=[m, k, n], valid=[vm, vn, vk],
                      steps=[st.opcode for st in prog.steps],
                      path_launches_of_program=c["count"],
                      bytes=vm * vk * elt + vk * vn * elt + x_bytes
                      + out_bytes, max_ref=scale, max_rel=worst,
                      library_call="torch.matmul, GEMM only, without "
                                   "the epilogue",
                      tflops=2 * vm * vn * vk / ms / 1e9)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(worst <= tol, f"{name} {dtype_name} {prog.key}: "
                            f"max|d|/max|ref| {worst:.3e} > {tol}")
        rows.append((row, detail))


def library_phase(rows: list, report: dict):
    """``pick`` at TinyLlama widths: one counted run through each entry,
    then each library version against ``matmul_ref`` and timed."""
    import torch

    from repro_torch.core.library import pick
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.ref import matmul_ref

    name = "matmul"
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        ops_in = {}
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = (torch.randn((k, n), generator=gen, device="cuda")
                 / 32).to(dt)
            ops_in[want] = (a, b)
        mm.LAUNCHES.reset()
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            choice = pick(m, k, n)
            check(choice.name == want,
                  f"pick{(m, k, n)} = {choice.name}, expected {want}")
            y = choice(*ops_in[want])
            check(tuple(y.shape) == (m, n) and y.dtype == dt,
                  f"{want}: {tuple(y.shape)} {y.dtype}")
        torch.cuda.synchronize()
        launches = mm.LAUNCHES.launches
        n_lib = sum(w.startswith("library:") for w in LIBRARY_SHAPES)
        print(f"[library {dname}] pick ran {len(LIBRARY_SHAPES)} entries, "
              f"{launches} library launches", flush=True)
        check(launches == n_lib,
              f"library: {launches} launches for {n_lib} versions")
        report[("library", dname)] = dict(launches={name: launches})
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            if not want.startswith("library:"):
                continue
            version = want.split(":", 1)[1]
            a, b = ops_in[want]
            got = mm.matmul(a, b, version=version)
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / scale
            ms = cuda_ms(lambda: mm.matmul(a, b, version=version))
            plain_ms = cuda_ms(lambda: matmul_ref(a, b))
            lib_ms = cuda_ms(lambda: torch.matmul(a, b))
            elt = a.element_size()
            bound_ms, bound_by = gemm_bound(m * k * elt, k * n * elt,
                                            m * n * elt, 2 * m * n * k,
                                            dname)
            row = dict(name=name, **KERNELS[name], launches=launches,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
            detail = dict(dtype=dname, version=version, shape=[m, k, n],
                          max_ref=scale, max_rel=rel,
                          path_launches_of_program=1,
                          bytes=(m * k + k * n + m * n) * elt,
                          tflops=2 * m * n * k / ms / 1e9)
            print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
            check(rel <= TOL_GEMM[dname],
                  f"{want} {dname}: max|d|/max|ref| {rel:.3e}")
            rows.append((row, detail))


def summary(rows: list, report: dict) -> list:
    """One entry per kernel: its most-launched f32 program at the path's
    shapes stands for it; ``launches`` sums every path's counted runs."""
    out = []
    for name in KERNELS:
        mine = [(r, d) for r, d in rows if r["name"] == name]
        if not mine:
            continue
        row, _ = max(mine, key=lambda rd: (rd[1]["dtype"] == "f32",
                                           rd[1]["path_launches_of_program"],
                                           rd[1]["bytes"]))
        row = dict(row, launches=sum(rep["launches"].get(name, 0)
                                     for rep in report.values()))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder layers to unroll (default: all 22)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    import dataclasses

    from repro_torch.configs import get_config

    builds = None  # (thread, result) of the background nvcc builds
    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"[card] {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {kind}", flush=True)
        # the eager references contract in full f32: no TF32, and no
        # reduced-precision (bf16) reduction inside a bf16 GEMM
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        base = get_config("tinyllama_11b")
        cfgs = {d: dataclasses.replace(base, n_layers=args.layers, dtype=d)
                for d in ("f32", "bf16")}
        report: dict = {}
        rows: list = []
        path2 = {d: build_token_major(cfgs[d], d, args.seed)
                 for d in cfgs}
        builds = start_cuda_builds(list(path2.values()))
        print(f"[build] {builds[1]['sources']} CUDA sources building in "
              f"parallel", flush=True)
        for dname, cfg in cfgs.items():
            t0 = time.perf_counter()
            art = build(cfg, dname, args.seed)
            calls = path_phase("path1", art, dname, args.seed, cfg, report)
            kernel_phase(calls, dname, report[("path1", dname)]["launches"],
                         rows)
            del art, calls
            print(f"[phase path1 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        builds[0].join()
        built = builds[1]
        if "error" in built:
            raise PhaseError(f"CUDA build failed: {built['error']}")
        print(f"[build] {built['sources']} CUDA sources built in "
              f"{built['seconds']:.1f} s (nvcc, in parallel)", flush=True)
        for dname, cfg in cfgs.items():
            t0 = time.perf_counter()
            calls = path_phase("path2", path2[dname], dname, args.seed, cfg,
                               report)
            gemm_phase(calls, dname, report[("path2", dname)]["launches"],
                       rows)
            del calls
            path2[dname] = None
            print(f"[phase path2 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        library_phase(rows, report)
        print(f"[phase library] {time.perf_counter() - t0:.1f} s",
              flush=True)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if builds is not None:
            builds[0].join()
    print(json.dumps({"kernels": summary(rows, report)}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
