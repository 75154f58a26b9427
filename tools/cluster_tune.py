"""Times the port's cluster kernels (kLoop, kInput) on the card at the
paths' shapes: candidate plans, a parent tree's kernels and a PyTorch
call, in the same turns; and counts the vector accesses in their PTX.

    PYTHONPATH=src python tools/cluster_tune.py [--reps 20] [--turns 2]
        [--cases NAME[,NAME...]] [--candidates] [--parent-src SRC]
        [--ptx DIR] [--host] [--path-softmax]

Each case (``_cases``) builds its program and operands as
``chip_smoke.py``'s paths give them (path 1's RMSNorm-apply and
softmax-div kLoops, its Σx² kInput), plus a one-row reduce of 4 M
elements, a reduce over the token axis, and the softmax-div on attention
probabilities (``softmax_div_probs8`` / ``probs30``: exp(z − max z) of a
row, z of spread 8 and 30; with 30 most numerators are subnormal).  The
port's own plan (``cluster_plan.loop_plan`` / ``reduce_plan``) runs
first; with ``--candidates`` the tiles, unrolls and warps the tool
varies around it (``dataclasses.replace`` on the plan, launched through
the kernel module's ``launch``).  Each run is held against the plain
version (kLoop bit for bit, kInput within 1e-5 / 8e-3 of the row's sum
of magnitudes; each line says whether it ``agrees``) and timed with CUDA
events, the L2 flushed before each launch, in ``--turns`` rounds that
alternate their order (A B .. B A), beside a ``floor`` run moving the
same bytes (``floor_fn``).  The port's plan, the parent and the
library call are also timed with the L2 emptied by a read (no dirty
lines to write back: ``clean_ms``) and back to back (``warm_ms``).

``--parent-src``: a parent checkout's ``src``; its kLoop / kInput kernel
modules are imported from that tree (as the package
``parent_repro_torch``) and launched through their own
``fused_elementwise_kernel`` / ``fused_reduce_kernel`` in the same turns.
``--ptx DIR``: each kernel's PTX written there, and a ``[ptx]`` line with
its global loads and stores by width (``v4``: 16 bytes of 32-bit words).
``--host``: the host µs a call of the port's wrapper (``ops.py``) and the
parent's kernel entry, 1000 calls back to back, at path 1's programs
over the bucket of S = 37 (64 rows; ``[host]`` lines).
``--path-softmax``: path 1's softmax-div on the operands the path hands
it (one layer compiled as ``chip_smoke.py`` compiles it, the call at
S = 1999 recorded) and on fresh copies of them, the port's kernel and
the parent's in the same turns; then on the recorded operands with the
causal mask's zero numerators set to 0.5 in place (``[path_softmax]``
lines).  A
``[card]`` line gives ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys
import types
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import cluster_plan as cp
from repro_torch.kernels import triton_build
from repro_torch.kernels.fused_elementwise import fused_elementwise as fe
from repro_torch.kernels.fused_elementwise.ref import fused_elementwise_ref
from repro_torch.kernels.fused_reduce import fused_reduce as fr
from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
from repro_torch.kernels.matmul.tune import cuda_ms
from repro_torch.kernels.program import Program, Step

F32, BF16 = torch.float32, torch.bfloat16
HBM_BYTES_PER_S = 3.35e12
TOL_ROW = {F32: 1e-5, BF16: 8e-3}


def _rms_apply(out_dtype) -> Program:
    steps = [Step("div", (("in", 0), ("c", 2048)), F32),
             Step("add", (("t", 0), ("c", 1e-06)), F32),
             Step("rsqrt", (("t", 1),), F32),
             Step("mul", (("in", 1), ("t", 2)), F32),
             Step("mul", (("t", 3), ("in", 2)), F32)]
    if out_dtype != F32:
        steps.append(Step("convert", (("t", 4),), out_dtype, out_dtype))
    return Program((F32, F32, F32), tuple(steps), (("t", len(steps) - 1),))


def _square(dt) -> Program:
    return Program((dt,), (Step("mul", (("in", 0), ("in", 0)), dt),),
                   (("t", 0),))


def _cases(gen) -> Dict[str, dict]:
    """name -> case: the path's program, operands and a library call."""
    def rnd(*shape, dt=F32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    s = 2048
    ss = rnd(1, s, 1).abs() * 2048 + 1.0
    x, w = rnd(1, s, s), rnd(s)
    e = rnd(1, 4, 8, s, s)
    den = e.sum(-1, keepdim=True).abs() + 1.0
    # attention probabilities as a softmax makes them: exp(z - max z) over
    # a row, z of spread 8 (some of them subnormal) and 30 (most of them)
    probs = {}
    for spread in (8, 30):
        z = rnd(1, 4, 8, s, s) * spread
        p = torch.exp(z - z.amax(-1, keepdim=True))
        del z
        probs[spread] = (p, p.sum(-1, keepdim=True))
    sq = rnd(s, s)
    sq16 = sq.to(BF16)
    row = rnd(1, 4 << 20)
    out = {
        "rms_apply_f32": dict(loop=True, program=_rms_apply(F32),
                              inputs=[ss, x, w], shape=(1, s, s), lib=None),
        "rms_apply_bf16": dict(loop=True, program=_rms_apply(BF16),
                               inputs=[ss, x, w], shape=(1, s, s), lib=None),
        "softmax_div_f32": dict(
            loop=True, program=Program((F32, F32), (Step(
                "div", (("in", 0), ("in", 1)), F32),), (("t", 0),)),
            inputs=[e, den], shape=tuple(e.shape),
            lib=lambda: torch.div(e, den)),
        **{f"softmax_div_probs{k}": dict(
            loop=True, program=Program((F32, F32), (Step(
                "div", (("in", 0), ("in", 1)), F32),), (("t", 0),)),
            inputs=list(v), shape=tuple(v[0].shape),
            lib=lambda v=v: torch.div(*v)) for k, v in probs.items()},
        "sumsq_f32": dict(loop=False, program=_square(F32), inputs=[sq],
                          shape=(s, s), axis=1, out_dtype=F32,
                          lib=lambda: torch.linalg.vecdot(sq, sq, dim=-1)),
        "sumsq_bf16": dict(loop=False, program=_square(BF16),
                           inputs=[sq16], shape=(s, s), axis=1,
                           out_dtype=BF16,
                           lib=lambda: torch.linalg.vecdot(sq16, sq16,
                                                           dim=-1)),
        "sumsq_row_4m": dict(loop=False, program=_square(F32),
                             inputs=[row], shape=tuple(row.shape), axis=1,
                             out_dtype=F32,
                             lib=lambda: torch.linalg.vecdot(row, row,
                                                             dim=-1)),
        "sumsq_axis0": dict(loop=False, program=_square(F32), inputs=[sq],
                            shape=(s, s), axis=0, out_dtype=F32,
                            lib=lambda: torch.linalg.vecdot(sq, sq, dim=0)),
    }
    return out


def _bytes(case) -> int:
    total = 1
    for d in case["shape"]:
        total *= d
    n_in = 0
    for t in case["inputs"]:
        n = 1
        for size, st in zip(t.shape, t.stride()):
            n *= size if st else 1
        n_in += n * t.element_size()
    if case["loop"]:
        return n_in + sum(total * dt.itemsize
                          for dt in case["program"].out_dtypes)
    return n_in + total // case["shape"][case["axis"]] * \
        case["out_dtype"].itemsize


def plan_of(case):
    shape = case["shape"]
    ins = cp.layouts(case["inputs"], shape)
    if case["loop"]:
        return cp.loop_plan(shape, ins, tuple(
            dt.itemsize for dt in case["program"].out_dtypes))
    return cp.reduce_plan(shape, case["axis"] % len(shape), ins)


def candidates(plan) -> List[object]:
    """The plan, then tiles, unrolls and warps around it."""
    out = [plan]
    if isinstance(plan, cp.LoopPlan):
        for br in (plan.block_r // 2, plan.block_r * 2, plan.block_r * 4):
            if br >= 1:
                out.append(dataclasses.replace(plan, block_r=br))
        if plan.block_c >= 1024:
            out.append(dataclasses.replace(plan, block_c=plan.block_c // 2,
                                           block_r=plan.block_r * 2))
        out.append(dataclasses.replace(plan, num_warps=8))
        out.append(dataclasses.replace(plan, block_r=plan.block_r * 2,
                                       num_warps=8))
    else:
        alts = [dict(block_a=a) for a in (plan.block_a // 2,
                                          plan.block_a * 2) if a >= 1]
        alts += [dict(unroll=1), dict(unroll=4), dict(num_warps=8)]
        if plan.mode == "cols" and plan.block_b >= 1024:
            alts.append(dict(block_b=plan.block_b // 2,
                             block_a=plan.block_a * 2))
        for alt in alts:
            p = dataclasses.replace(plan, **alt)
            n_split, span = cp.split(p.tiles, p.n_red, p.chunk)
            out.append(dataclasses.replace(p, n_split=n_split, span=span))
    return out


def run_plan(case, plan):
    if case["loop"]:
        return fe.launch(case["program"], case["inputs"], _total(case),
                         case["shape"], plan)[0]
    shape, axis = case["shape"], case["axis"] % len(case["shape"])
    out = torch.empty([d for i, d in enumerate(shape) if i != axis],
                      dtype=case["out_dtype"], device="cuda")
    return fr.launch(case["program"], case["inputs"], shape[axis], "sum",
                     out, plan)


def _total(case) -> int:
    n = 1
    for d in case["shape"]:
        n *= d
    return n


def plain(case):
    if case["loop"]:
        return fused_elementwise_ref(case["program"], case["inputs"],
                                     _total(case), case["shape"])[0]
    shape = case["shape"]
    axis = case["axis"] % len(shape)
    return fused_reduce_ref(case["program"], case["inputs"], shape[axis],
                            "sum", axis, shape, case["out_dtype"])


def agrees(case, got, want) -> bool:
    if case["loop"]:
        return torch.equal(got, want)
    x = case["inputs"][0].float()
    mag = (x * x).sum(case["axis"])
    d = (got.float() - want.float()).abs()
    return bool((d <= TOL_ROW[case["out_dtype"]] * mag).all())


def parent_modules(src: str) -> Dict[str, object]:
    """The parent tree's kLoop / kInput kernel modules, imported from
    ``src`` as ``parent_repro_torch`` (its packages' ``__init__`` files
    skipped: the kernel modules need only ``program``, ``triton_build``
    and ``core.dtypes``)."""
    root = pathlib.Path(src) / "repro_torch"
    for name, path in (("parent_repro_torch", root),
                       ("parent_repro_torch.core", root / "core"),
                       ("parent_repro_torch.kernels", root / "kernels")):
        pkg = types.ModuleType(name)
        pkg.__path__ = [str(path)]
        sys.modules[name] = pkg
    return {
        "loop": importlib.import_module("parent_repro_torch.kernels."
                                        "fused_elementwise.fused_elementwise"),
        "reduce": importlib.import_module("parent_repro_torch.kernels."
                                          "fused_reduce.fused_reduce"),
    }


def parent_run(parent, case):
    if case["loop"]:
        return parent["loop"].fused_elementwise_kernel(
            case["program"], case["inputs"], _total(case), case["shape"])[0]
    shape = case["shape"]
    axis = case["axis"] % len(shape)
    return parent["reduce"].fused_reduce_kernel(
        case["program"], case["inputs"], shape[axis], "sum", axis, shape,
        case["out_dtype"])


def _kernels_of(modules: Dict[str, object], prefix: str, fn: str) -> list:
    """Compiled kernels of the generated modules named ``prefix*`` in a
    ``triton_build._MODULES`` dict."""
    out = []
    for name, mod in modules.items():
        if name.startswith(prefix):
            jit = getattr(mod, fn)
            caches = getattr(jit, "device_caches", None)
            if caches is not None:
                out += [k for c in caches.values() for k in c[0].values()]
            else:
                out += [k for c in getattr(jit, "cache", {}).values()
                        for k in c.values()]
    return out


def write_ptx(out_dir: pathlib.Path, name: str, case, plan, parent) -> None:
    """PTX of the case's kernel (the port's plan) and the parent's, with
    their vector access counts."""
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = "kloop" if case["loop"] else "kinput"
    trees = [("change", triton_build._MODULES, fn + "2_" +
              case["program"].key)]
    if parent is not None:
        pmods = sys.modules["parent_repro_torch.kernels.triton_build"]
        trees.append(("parent", pmods._MODULES,
                      fn + "_" + case["program"].key))
    for tree, mods, prefix in trees:
        for i, k in enumerate(_kernels_of(mods, prefix, fn)):
            ptx = k.asm["ptx"]
            (out_dir / f"{name}_{tree}_{i}.ptx").write_text(ptx)
            print("[ptx] " + json.dumps(dict(
                case=name, tree=tree, instance=i,
                counts=triton_build.ptx_accesses(ptx),
                n_regs=getattr(k, "n_regs", None),
                n_spills=getattr(k, "n_spills", None),
                aligned=plan.aligned if tree == "change" else None)),
                flush=True)


def time_case(name, case, reps, turns, parent, with_candidates):
    plan = plan_of(case)
    want = plain(case)
    runs = {}
    agree = {}
    for i, p in enumerate(candidates(plan) if with_candidates else [plan]):
        got = run_plan(case, p)
        torch.cuda.synchronize()
        agree[f"c{i}"] = agrees(case, got, want)
        runs[f"c{i}"] = (p, lambda p=p: run_plan(case, p))
    if parent is not None:
        got = parent_run(parent, case)
        torch.cuda.synchronize()
        agree["parent"] = agrees(case, got, want)
        runs["parent"] = (None, lambda: parent_run(parent, case))
    if case["lib"] is not None:
        runs["library"] = (None, case["lib"])
    floor = floor_fn(case)
    if floor is not None:
        runs["floor"] = (None, floor)
    order = list(runs)
    ms: Dict[str, List[float]] = {k: [] for k in order}
    for t in range(turns):
        for k in (order if t % 2 == 0 else order[::-1]):
            ms[k].append(cuda_ms(runs[k][1], reps))
    bound = _bytes(case) / HBM_BYTES_PER_S * 1e3
    extra = {k: clean_and_warm_ms(runs[k][1], reps)
             for k in ("c0", "parent", "library") if k in runs}
    for k in order:
        p = runs[k][0]
        desc = None
        if p is not None:
            desc = {f: getattr(p, f) for f in (
                ("block_r", "block_c", "num_warps", "aligned")
                if case["loop"] else
                ("mode", "block_a", "block_b", "unroll", "num_warps",
                 "aligned", "n_split", "span"))}
        print(json.dumps(dict(case=name, run=k, plan=desc,
                              agrees=agree.get(k),
                              ms=sum(ms[k]) / len(ms[k]), turns=ms[k],
                              bound_ms=bound, **extra.get(k, {}))),
              flush=True)
    return plan


def clean_and_warm_ms(fn, reps: int) -> dict:
    """Two readings beside the flushed one: ``clean``, the L2 emptied by
    *reading* 128 MB (no dirty lines left for the kernel to write back);
    ``warm``, ``reps`` calls back to back, no flush (operands that fit
    the 50 MB L2 stay there)."""
    src = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        src.sum()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return dict(clean_ms=total / reps, warm_ms=start.elapsed_time(end) / reps)


def _host_cases(gen) -> Dict[str, dict]:
    """The path-1 programs at the bucket of S = 37 (64 rows)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    e = rnd(1, 4, 8, 64, 64).exp()
    sq = rnd(64, 2048)
    div = Program((F32, F32), (Step("div", (("in", 0), ("in", 1)), F32),),
                  (("t", 0),))
    rms = [rnd(1, 64, 1).abs() + 1.0, rnd(1, 64, 2048), rnd(2048)]
    return {
        "rms_apply_f32": dict(loop=True, program=_rms_apply(F32),
                              inputs=rms, shape=(1, 64, 2048)),
        "rms_apply_bf16": dict(loop=True, program=_rms_apply(BF16),
                               inputs=rms, shape=(1, 64, 2048)),
        "softmax_div_f32": dict(loop=True, program=div,
                                inputs=[e, e.sum(-1, keepdim=True)],
                                shape=tuple(e.shape)),
        "sumsq_f32": dict(loop=False, program=_square(F32), inputs=[sq],
                          shape=(64, 2048), axis=1, out_dtype=F32),
    }


def host_us(case, parent, reps: int) -> dict:
    """Host µs a call, ``reps`` calls back to back: the port's wrapper
    (``ops.py``) and, with a parent tree, the parent's kernel entry."""
    import time

    from repro_torch.kernels.fused_elementwise import ops as fe_ops
    from repro_torch.kernels.fused_reduce import ops as fr_ops

    shape = case["shape"]
    if case["loop"]:
        runs = {"change": lambda: fe_ops.fused_elementwise(
            case["program"], case["inputs"], _total(case), shape)}
    else:
        axis = case["axis"]
        runs = {"change": lambda: fr_ops.fused_reduce(
            case["program"], case["inputs"], shape[axis], "sum",
            axis=axis, shape=shape, out_dtype=case["out_dtype"])}
    if parent is not None:
        runs["parent"] = lambda: parent_run(parent, case)
    out = {}
    for k, fn in runs.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"{k}_host_us"] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return dict(shape=list(shape), **out)


def path_softmax(parent, reps: int, turns: int) -> None:
    """Path 1's softmax-div as the path hands it over: one layer of the
    TinyLlama stack compiled as ``chip_smoke.py`` compiles it, its call at
    S = 1999 recorded, the kernel (and the parent's) timed on the recorded
    operands and on fresh copies of them (the same values, other
    addresses), in turns, beside a copy of the same bytes; then on the
    recorded operands with their zeros set to 0.5."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("tinyllama_11b"), n_layers=1,
                              dtype="f32")
    art = cs.build(cfg, "f32", 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(art["shape"](1999), generator=gen, device="cuda")
    with cs.Recorder() as rec:
        art["f"](x)
        torch.cuda.synchronize()
    c = next(c for k, c in rec.calls.items() if k[0] == "fused_elementwise"
             and [s.opcode for s in c["program"].steps] == ["div"])
    del art
    case = dict(loop=True, program=c["program"], shape=c["shape"],
                inputs=list(c["inputs"]), lib=None)
    fresh = dict(case, inputs=[t.clone() for t in c["inputs"]])
    want = plain(case)
    runs = {}
    for label, cse in (("recorded", case), ("fresh", fresh)):
        runs[f"change_{label}"] = (cse, lambda cse=cse: run_plan(
            cse, plan_of(cse)))
        if parent is not None:
            runs[f"parent_{label}"] = (cse, lambda cse=cse: parent_run(
                parent, cse))
    runs["floor_recorded"] = (case, floor_fn(case))
    order = list(runs)
    ms: Dict[str, List[float]] = {k: [] for k in order}
    for t in range(turns):
        for k in (order if t % 2 == 0 else order[::-1]):
            ms[k].append(cuda_ms(runs[k][1], reps))
    zeros = (case["inputs"][0] == 0).float().mean().item()
    agree = {k: bool(torch.equal(runs[k][1](), want)) if k[0] != "f"
             else None for k in order}
    # the same operands with their zeros (the causal mask's) set to 0.5
    # in place: the same addresses, no zero numerator
    case["inputs"][0].masked_fill_(case["inputs"][0] == 0, 0.5)
    want = plain(case)
    extra = {"change_recorded_nonzero": lambda: run_plan(case,
                                                         plan_of(case))}
    if parent is not None:
        extra["parent_recorded_nonzero"] = lambda: parent_run(parent, case)
    for k, fn in extra.items():
        ms[k] = [cuda_ms(fn, reps) for _ in range(turns)]
        agree[k] = bool(torch.equal(fn(), want))
    for k in ms:
        print("[path_softmax] " + json.dumps(dict(
            run=k, ms=sum(ms[k]) / len(ms[k]), turns=ms[k],
            agrees=agree[k], zero_share=0.0 if "nonzero" in k else zeros,
            bound_ms=_bytes(case) / HBM_BYTES_PER_S * 1e3)), flush=True)


_FLOOR_SOURCE = '''import triton
import triton.language as tl


@triton.jit
def read_floor(x, out, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    v = tl.load(x + pid * BLOCK + tl.arange(0, BLOCK)).to(tl.float32)
    tl.store(out + pid, tl.sum(v * v, axis=0))
'''


def floor_fn(case):
    """The least a kernel moving the case's bytes has shown here: kLoop,
    a PyTorch copy of its dense operand into the output's dtype (the same
    bytes read and written); kInput, a Triton kernel that only reads the
    operand in unmasked 2048-element blocks (no tail, no row structure)."""
    if case["loop"]:
        x = max(case["inputs"], key=lambda t: t.numel())
        dt = case["program"].out_dtypes[0]
        return lambda: x.to(dt, copy=True)
    x = case["inputs"][0]
    if not x.is_contiguous() or x.numel() % 2048:
        return None
    mod = triton_build.load_kernel("cluster_tune_read_floor",
                                   lambda: _FLOOR_SOURCE)
    out = torch.empty(x.numel() // 2048, device="cuda")
    return lambda: mod.read_floor[(out.numel(),)](x, out, BLOCK=2048,
                                                  num_warps=4)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cases", default="")
    ap.add_argument("--candidates", action="store_true")
    ap.add_argument("--parent-src", default="")
    ap.add_argument("--ptx", default="")
    ap.add_argument("--host", action="store_true",
                    help="host µs a call at the bucket of S = 37")
    ap.add_argument("--path-softmax", action="store_true",
                    help="path 1's recorded softmax-div operands")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_tune: no CUDA device", file=sys.stderr)
        return 3
    print(f"[card] {card_line()}", flush=True)
    parent = parent_modules(args.parent_src) if args.parent_src else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = _cases(gen)
    names = args.cases.split(",") if args.cases else list(cases)
    for name in names:
        plan = time_case(name, cases[name], args.reps, args.turns, parent,
                         args.candidates)
        if args.ptx:
            write_ptx(pathlib.Path(args.ptx), name, cases[name], plan,
                      parent)

    if args.path_softmax:
        path_softmax(parent, args.reps, args.turns)
    if args.host:
        for name, case in _host_cases(gen).items():
            print("[host] " + json.dumps(dict(
                case=name, **host_us(case, parent, 1000))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
