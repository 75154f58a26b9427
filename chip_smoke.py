#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which stops the run with a non-zero exit when it fails:

1. **Card.**  Prints ``nvidia-smi``'s name and power limit and
   ``torch.cuda.get_device_name()``.
2. **Path.**  Compiles TinyLlama-1.1B's decoder stack at full width
   (d_model 2048, 32/4 heads, d_ff 5632, 22 layers unrolled, ``ln_f`` and
   the 32000-wide head; random weights drawn on the card from a seeded
   ``torch.Generator``) with ``disc_torch.compile(..., backend="hopper")``,
   once in f32 and once in bf16, and serves requests of S = 37, 200, 731,
   1500, 1999 and then 45 (the bucket of 37: a cache hit).  Each output is
   held against the same model function run eagerly on the card:
   max|Δ|/max|ref| ≤ 1e-3 in f32 and ≤ 2e-2 in bf16.  Checks compiles ==
   distinct buckets, the cluster kernels' runs, and the launch counts of
   both kernels in that run (a kernel that fails raises: the path has no
   per-op fallback to count).
3. **Kernels.**  Holds every kernel program the path launched (recorded
   from one extra, uncounted run at S = 1999) against its plain version
   on the same card inputs, through the wrappers the path calls, in f32
   and bf16: at the path's ``n_valid`` and at one below the padded size,
   whose tails must be exactly zero.  kLoop must match bit for bit; a
   kInput sum row may differ by its f32 summation order, bounded
   relative to the row's sum of magnitudes.  Times kernel, plain version
   and (where one exists) a single PyTorch call with CUDA events at the
   path's ``n_valid``, and computes each kernel's bound from the bytes
   it must move.
4. Prints the kernels line, the card line, and the result line last.

Run it from a checkout: it builds the kernels from ``src/`` into
``build/torch_kernels/`` and refuses to run without the repository or
without a CUDA device.
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

# H100 SXM data-sheet peaks (700 W): HBM bytes/s and f32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

REQUESTS = (37, 200, 731, 1500, 1999, 45)
TOL_PATH = {"f32": 1e-3, "bf16": 2e-2}
# kInput vs its plain version, per row, relative to the row's sum of
# magnitudes: f32 sums differ by summation order only; a bf16 result by
# at most one rounding step (2^-7) of the stored value.  kLoop computes
# each op exactly as eager does and must match bit for bit.
TOL_REDUCE_ROW = {"f32": 1e-5, "bf16": 8e-3}

KERNELS = {
    "fused_elementwise": {
        "source": "src/repro_torch/kernels/fused_elementwise/fused_elementwise.py",
        "replaces": "src/repro/kernels/fused_elementwise/fused_elementwise.py:51",
    },
    "fused_reduce": {
        "source": "src/repro_torch/kernels/fused_reduce/fused_reduce.py",
        "replaces": "src/repro/kernels/fused_reduce/fused_reduce.py:48",
    },
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

def build(cfg, dtype_name: str, seed: int):
    import torch

    import disc_torch
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init(cfg, gen, "cuda")
    dt = torch.float32 if dtype_name == "f32" else torch.bfloat16

    def fn(x):
        return T.decoder_logits(cfg, params, x)

    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((1, disc_torch.Dim("S", max=2048), cfg.d_model), dt)],
        backend="hopper")
    lower_s = time.perf_counter() - t0
    return fn, f, params, dt, lower_s


class Recorder:
    """Records the first call of each distinct kernel program (uncounted
    run) so the kernel phase can replay it at the path's shapes."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr

        self._saved = (fe.fused_elementwise, fr.fused_reduce)
        orig_fe, orig_fr = self._saved

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

        fe.fused_elementwise, fr.fused_reduce = rec_fe, rec_fr
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr

        fe.fused_elementwise, fr.fused_reduce = self._saved
        return False


def path_phase(cfg, dtype_name: str, seed: int, report: dict):
    import torch

    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr

    fn, f, params, dt, lower_s = build(cfg, dtype_name, seed)
    low = f.lower()
    templates = low.plan.template_counts()
    print(f"[path {dtype_name}] lowered {cfg.n_layers} layers in "
          f"{lower_s:.2f} s: {low.plan.stats()} templates={templates}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    inputs = {s: torch.randn((1, s, cfg.d_model), generator=gen,
                             device="cuda").to(dt) for s in REQUESTS}
    buckets = set()
    kern = f.backend.cluster_kernels
    runs0 = {t: k.runs for t, k in kern.items()}
    fe.LAUNCHES.reset()
    fr.LAUNCHES.reset()
    rows = []
    for s in REQUESTS:
        before = f.compile_counts()["total"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = f(inputs[s])
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        after = f.compile_counts()["total"]
        key = f.policy.bucket("S", s)
        new_bucket = key not in buckets
        buckets.add(key)
        rows.append((s, key, dt_s, after - before, y))
        if s == 45:
            check(after == before, f"S=45 compiled anew (bucket {key})")
    launches = {"fused_elementwise": fe.LAUNCHES.launches,
                "fused_reduce": fr.LAUNCHES.launches}
    for s, key, dt_s, compiled, y in rows:
        with torch.no_grad():
            ref = fn(inputs[s])
        torch.cuda.synchronize()
        check(tuple(y.shape) == (1, s, cfg.vocab), f"shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"S={s}: non-finite output")
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rel = err / scale
        print(f"[path {dtype_name}] S={s:5d} bucket={key:5d} "
              f"compiled={compiled} latency_s={dt_s:.4f} max|d|={err:.4e} "
              f"max|ref|={scale:.4e} rel={rel:.3e}", flush=True)
        check(rel <= TOL_PATH[dtype_name],
              f"S={s}: rel {rel:.3e} > {TOL_PATH[dtype_name]}")
        del ref
    counts = f.compile_counts()
    runs = {t: k.runs - runs0[t] for t, k in kern.items()}
    print(f"[path {dtype_name}] compile_counts={counts} "
          f"distinct_buckets={sorted(buckets)} cache={f.cache_stats()}",
          flush=True)
    print(f"[path {dtype_name}] cluster runs: " + ", ".join(
        f"{t}={n}" for t, n in runs.items()) + f"; launches={launches}",
        flush=True)
    check(counts["total"] == len(buckets),
          f"{counts['total']} compiles for {len(buckets)} buckets")
    check(runs["kLoop"] > 0 and launches["fused_elementwise"] == runs["kLoop"],
          f"kLoop: runs={runs['kLoop']} launches={launches}")
    if templates.get("kInput"):
        check(runs["kInput"] > 0
              and launches["fused_reduce"] == runs["kInput"],
              f"kInput: runs={runs['kInput']} launches={launches}")
    report[dtype_name] = dict(launches=launches, compiles=counts,
                              lower_s=lower_s)

    # one extra, uncounted run records every kernel program at S=1999
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

    variants = [(dtype_name, c) for c in calls.values()]
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
        row = dict(name=name, route="triton", **KERNELS[name],
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


def summary(rows: list, report: dict) -> list:
    """One entry per kernel: its most-launched f32 program at the path's
    shapes stands for it; ``launches`` sums both dtypes' path runs."""
    out = []
    for name in KERNELS:
        mine = [(r, d) for r, d in rows if r["name"] == name]
        if not mine:
            continue
        row, _ = max(mine, key=lambda rd: (rd[1]["dtype"] == "f32",
                                           rd[1]["path_launches_of_program"],
                                           rd[1]["bytes"]))
        row = dict(row, launches=sum(rep["launches"][name]
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

    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"[card] {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {kind}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        base = get_config("tinyllama_11b")
        report: dict = {}
        rows: list = []
        for dname in ("f32", "bf16"):
            cfg = dataclasses.replace(base, n_layers=args.layers,
                                      dtype=dname)
            t0 = time.perf_counter()
            calls = path_phase(cfg, dname, args.seed, report)
            kernel_phase(calls, dname, report[dname]["launches"], rows)
            print(f"[phase {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": summary(rows, report)}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
