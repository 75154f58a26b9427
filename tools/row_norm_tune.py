"""Times candidate plans of the port's row normalisations (RMSNorm and
LayerNorm, ``src/repro_torch/kernels/common/csrc/row_norm.cuh``) on the
card, beside a parent tree's kernels and the library calls, and the host
cost of two trees' wrappers.

    PYTHONPATH=src python tools/row_norm_tune.py [--reps 20] [--turns 2]
        [--cases decode|prefill|all] [--parent-src SRC]
        [--host-trees SRC[,SRC...]] [--host-reps 2000] [--sass DIR]

A candidate is a group width (threads a row): the tool builds the plan
:func:`row_norm.norm_plan` would build around it (chunks to cover the row,
groups a block, the grid) and launches the library's C entry with it, so
the port's own plan and launch take no tuning arguments.  At each case of
:data:`CASES` (the norms' rows on ``chip_smoke.py``'s paths: a 2048-token
prefill and a decode step of B = 4, x f32 or bf16, the weights f32 as in
every model) every candidate is held against the plain version
(max|d|/max|ref| within ``TOL``) and timed with CUDA events, the L2
flushed before each launch, in ``--turns`` rounds that alternate their
order (A B .. B A) so that a drift of the card's clock falls on every
side.  ``--parent-src``: a parent checkout's ``src`` whose norm kernels
are Triton: their source is read from that tree and launched as its
wrappers launched them, timed in the same turns.  ``F.rms_norm`` /
``F.layer_norm`` (weights in x's dtype) is timed beside them.  One JSON
line per (case, candidate), the libraries' registers, stack and local
memory, and a ``[card]`` line with ``nvidia-smi``'s name and power limit.

``--sass DIR``: the SASS of the port's instance that the decode rows of
LayerNorm in f32 take, and of the parent's Triton kernel at that case,
written to DIR, with their instruction counts printed.

``--host-trees``: for each source tree given (this one and a parent's,
say), in turns (a b .. b a), a fresh process imports that tree's
``repro_torch`` and calls its RMSNorm and LayerNorm wrappers
(``kernels/*/ops.py``) at the decode rows (4 x 1 x D) back to back,
``--host-reps`` times with no synchronise: the host µs a call, and
``F.rms_norm`` / ``F.layer_norm``'s; then each once a time after an L2
flush: the device ms a call.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build, row_norm, triton_build
from repro_torch.kernels.layernorm.ref import layernorm_ref
from repro_torch.kernels.matmul.tune import cuda_ms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: (kind, rows, width)
CASES = [("rmsnorm", 2048, 2048), ("rmsnorm", 2048, 3584),
         ("rmsnorm", 2048, 6144), ("layernorm", 2048, 2560),
         ("rmsnorm", 4, 2048), ("rmsnorm", 4, 3584), ("rmsnorm", 4, 6144),
         ("layernorm", 4, 2560)]
#: group widths tried at each case (those whose chunks fit a register
#: instance)
GROUPS = (64, 128, 256, 512)

#: kernel vs plain version, max|d|/max|ref| (chip_smoke TOL_SERVE_KERNEL)
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
EPS = {"rmsnorm": 1e-6, "layernorm": 1e-5}

# run in a fresh process per source tree: its wrappers at the decode rows
_HOST = r'''
import json, sys, time
import torch
import torch.nn.functional as F
from repro_torch.kernels.layernorm import ops as ln
from repro_torch.kernels.rmsnorm import ops as rms
reps = int(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")


def cold_ms(fn, n=20):  # as matmul.tune.cuda_ms: L2 flushed, a spin ahead
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


out = {}
for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    for kind, d in (("rmsnorm", 2048), ("rmsnorm", 3584), ("rmsnorm", 6144),
                    ("layernorm", 2560)):
        x = torch.randn((4, 1, d), generator=gen, device="cuda").to(dt)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        wl, bl = w.to(dt), b.to(dt)
        if kind == "rmsnorm":
            fns = {"wrapper": lambda: rms.rmsnorm(x, w, eps=1e-6),
                   "library": lambda: F.rms_norm(x, (d,), weight=wl,
                                                 eps=1e-6)}
        else:
            fns = {"wrapper": lambda: ln.layernorm(x, w, b, eps=1e-5),
                   "library": lambda: F.layer_norm(x, (d,), weight=wl,
                                                   bias=bl, eps=1e-5)}
        for name, fn in fns.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            out[f"{kind} {dname} 4x1x{d} {name}"] = host * 1e6 / reps
            out[f"{kind} {dname} 4x1x{d} {name} ms"] = cold_ms(fn)
print(json.dumps(out))
'''


def host_us(src: str, reps: int) -> Dict[str, float]:
    """Host µs a call of ``src``'s norm wrappers and the library calls
    (and, keys ending " ms", each one's device ms a call, L2 flushed)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    done = subprocess.run([sys.executable, "-c", _HOST, str(reps)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    if done.returncode != 0:
        raise SystemExit(f"tune: host timing of {src} failed:\n"
                         f"{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def candidate_plan(n_rows: int, d: int, elt: int, group: int,
                   layernorm: bool,
                   sms: int) -> Optional[row_norm.NormPlan]:
    """``norm_plan``'s plan around a group of ``group`` threads (16-byte
    rows), or None where its chunks do not fit a register instance."""
    vec = 16 // elt if d % (16 // elt) == 0 else 1
    units = -(-d // vec)
    chunks = -(-units // group)
    if (chunks > row_norm.MAX_CHUNKS
            or vec * chunks > row_norm.MAX_ELEMS[layernorm]
            or (chunks - 1) * group >= units):
        return None
    rows = max(1, row_norm.BLOCK_THREADS // group)
    threads = rows * group
    if threads % 32:
        return None
    sm_threads = min(row_norm.MAX_SM_THREADS,
                     max(row_norm.SM_THREADS, row_norm.SM_GROUPS * group))
    blocks = max(1, -(-n_rows // rows))
    cap = sms * max(1, sm_threads // threads)
    walk = -(-blocks // cap)
    grid = -(-blocks // walk)
    return row_norm.NormPlan(vec, chunks, group, rows, threads, grid, False,
                             grid * rows < n_rows)


def launch_plan(kind, plan, x, w, b, eps):
    """One launch of ``kind``'s library under ``plan`` on contiguous x
    and contiguous f32 weights."""
    fn, err = row_norm._function(kind)
    codes = (row_norm.DTYPES[x.dtype], row_norm.DTYPES[w.dtype],
             0 if b is None else row_norm.DTYPES[b.dtype])
    word = row_norm.launch_word(plan, *codes)
    word |= row_norm._weight_path(word, codes, w, b) << 24
    out = torch.empty_like(x)
    d = x.shape[-1]
    rc = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), x.numel() // d, d, d, word, plan.grid, eps,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"tune: {kind} {plan}: {err(rc).decode()}")
    return out


def parent_kernels(src: str) -> Dict[str, object]:
    """The parent tree's Triton norm kernels: each one's ``SOURCE`` read
    from ``src`` and imported from the build directory."""
    triton_build.triton()
    mods = {}
    for kind in ("rmsnorm", "layernorm"):
        path = pathlib.Path(src) / "repro_torch" / "kernels" / kind / \
            f"{kind}.py"
        tree = ast.parse(path.read_text())
        source = next(ast.literal_eval(n.value) for n in tree.body
                      if isinstance(n, ast.Assign)
                      and getattr(n.targets[0], "id", "") == "SOURCE")
        name = f"parent_{kind}_" + hashlib.sha1(
            source.encode()).hexdigest()[:12]
        file = triton_build.BUILD_DIR / f"{name}.py"
        file.parent.mkdir(parents=True, exist_ok=True)
        file.write_text(source)
        spec = importlib.util.spec_from_file_location(name, file)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        mods[kind] = getattr(mod, f"{kind}_kernel")
    return mods


def parent_launch(kern, kind, x, w, b, eps):
    """The parent's wrapper's launch: a program a row, the row padded to
    a power of two, 4 warps up to 2048 columns, else 8."""
    n, d = x.shape
    out = torch.empty_like(x)
    block = 1 << (d - 1).bit_length()
    warps = 4 if block <= 2048 else 8
    if kind == "rmsnorm":
        return kern[(n,)](x, w, out, n, d, x.stride(0), out.stride(0),
                          1.0 / d, eps, BLOCK_D=block, num_warps=warps), out
    return kern[(n,)](x, w, b, out, n, d, x.stride(0), out.stride(0),
                      1.0 / d, eps, BLOCK_D=block, num_warps=warps), out


def sass_of(cubin: pathlib.Path, match: str) -> List[str]:
    """The SASS instructions of the kernel in ``cubin`` whose mangled
    name contains ``match``."""
    tool = pathlib.Path(cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out, on = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            on = match in m.group(1)
        elif on and re.search(r"/\*[0-9a-f]{4}\*/", line):
            out.append(line.strip())
    return out


def _inputs(gen, kind, rows, d, dt):
    off = 3.0 if kind == "layernorm" else 0.0   # rows off zero mean
    x = (torch.randn((rows, d), generator=gen, device="cuda") + off).to(dt)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    return x, w, b if kind == "layernorm" else None


def time_case(kind, rows, d, dt, gen, sms, reps, turns, parent):
    """Every candidate at one case, in turns, against the plain version;
    one JSON line each."""
    x, w, b = _inputs(gen, kind, rows, d, dt)
    eps = EPS[kind]
    if kind == "rmsnorm":
        want = rmsnorm_ref(x, w, eps)
        wl = w.to(dt)

        def lib():
            return F.rms_norm(x, (d,), weight=wl, eps=eps)
    else:
        want = layernorm_ref(x, w, b, eps)
        wl, bl = w.to(dt), b.to(dt)

        def lib():
            return F.layer_norm(x, (d,), weight=wl, bias=bl, eps=eps)
    ln = kind == "layernorm"
    default = row_norm.norm_plan(rows, d, x.element_size(), True, sms,
                                 layernorm=ln)
    runs = {"default": lambda: launch_plan(kind, default, x, w, b, eps)}
    plans = {"default": default}
    for g in GROUPS:
        plan = candidate_plan(rows, d, x.element_size(), g, ln, sms)
        if plan is not None and plan != default and not default.loop:
            plans[f"group {g}"] = plan
            runs[f"group {g}"] = (lambda plan=plan:
                                  launch_plan(kind, plan, x, w, b, eps))
    if parent is not None:
        runs["parent"] = lambda: parent_launch(parent[kind], kind, x, w, b,
                                               eps)[1]
    runs["library"] = lib
    for name, run in runs.items():
        if name == "library":
            continue
        got = run()
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        if rel > TOL[dt]:
            raise SystemExit(f"tune: {kind} {rows}x{d} {dt} {name}: "
                             f"{rel:.3e}")
    times: Dict[str, List[float]] = {k: [] for k in runs}
    order = list(runs)
    for t in range(turns):
        for name in (order if t % 2 == 0 else order[::-1]):
            times[name].append(cuda_ms(runs[name], reps))
    for name, t in times.items():
        print(json.dumps(dict(
            case=f"{kind} {rows}x{d}", dtype=str(dt).split(".")[-1],
            candidate=name,
            plan=plans[name]._asdict() if name in plans else None,
            ms_turns=t, ms=sum(t) / len(t))), flush=True)


def write_sass(out_dir: str, parent, sms: int):
    """SASS of the LayerNorm f32 decode instance and the parent's Triton
    kernel at 4 x 2560."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    job = row_norm.source_job("layernorm")
    (lib,) = cuda_build.build([job])
    plan = row_norm.norm_plan(4, 2560, 4, True, sms, layernorm=True)
    # norm_rows<float, VEC, CH, LN, WSEL, WALK> mangles its int arguments
    # as Li<n>E and bools as Lb<n>E
    match = (f"9norm_rowsIfLi{plan.vec}ELi{plan.chunks}ELb1ELi0E"
             f"Lb{int(plan.walk)}E")
    mine = sass_of(pathlib.Path(lib), match)
    (out / "layernorm_f32_decode_port.sass").write_text("\n".join(mine))
    counts = dict(port=len(mine), plan=plan._asdict())
    if parent is not None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, w, b = _inputs(gen, "layernorm", 4, 2560, torch.float32)
        compiled, _ = parent_launch(parent["layernorm"], "layernorm", x, w,
                                    b, EPS["layernorm"])
        asm = getattr(compiled, "asm", None) or {}
        if "cubin" in asm:
            cubin = out / "layernorm_f32_decode_parent.cubin"
            cubin.write_bytes(asm["cubin"])
            theirs = sass_of(cubin, "layernorm_kernel")
            (out / "layernorm_f32_decode_parent.sass").write_text(
                "\n".join(theirs))
            counts["parent"] = len(theirs)
        else:
            counts["parent"] = "no cubin from the Triton launch"
    print(f"[sass] {json.dumps(counts)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cases", default="all",
                    choices=["all", "decode", "prefill"])
    ap.add_argument("--parent-src", default="")
    ap.add_argument("--host-trees", default="")
    ap.add_argument("--host-reps", type=int, default=2000)
    ap.add_argument("--sass", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    jobs = [row_norm.source_job(k) for k in ("rmsnorm", "layernorm")]
    cuda_build.build(jobs)
    for j in jobs:
        print(f"[resources] {j[0]} {json.dumps(cuda_build.resources(j))}",
              flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent = parent_kernels(args.parent_src) if args.parent_src else None
    if args.sass:
        write_sass(args.sass, parent, sms)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, rows, d in CASES:
        if args.cases != "all" and (rows < sms) != (args.cases == "decode"):
            continue
        for dt in (torch.float32, torch.bfloat16):
            time_case(kind, rows, d, dt, gen, sms, args.reps, args.turns,
                      parent)
    trees = [t for t in args.host_trees.split(",") if t]
    if trees:
        turns: Dict[str, List[Dict[str, float]]] = {t: [] for t in trees}
        for order in (trees, trees[::-1]):
            for t in order:
                turns[t].append(host_us(t, args.host_reps))
        for t in trees:
            keys = turns[t][0]
            print(json.dumps(dict(tree=t, host_us={
                k: [r[k] for r in turns[t]] for k in keys})), flush=True)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
