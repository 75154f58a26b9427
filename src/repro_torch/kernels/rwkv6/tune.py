"""Times candidate builds of the WKV kernel's chunked instance on the card.

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.tune [--reps 20]

Each candidate of :data:`CANDIDATES` is the library built with its chunk
length, sub-chunk length and state rows a lane at N = 64 (the source's
``WKV_CHUNK``, ``WKV_SUB`` and ``WKV_R64``); all are built at once and
each instance's registers and local memory printed
(``cuda_build.resources``).  At each case of :data:`CASES` (the WKV
rows of ``chip_smoke.py``, RWKV-6 3B's 40 heads of 64) and in f32 and
bf16, every candidate is held against the plain version (y within the
card tolerance, the state within 1e-5 of max|ref|) and timed with CUDA
events, L2 flushed before each launch, the candidates in turns A B ..
B A so that a drift of the card's clock falls on both sides.  One JSON
line per (case, dtype, candidate) and a ``[card]`` line with
``nvidia-smi``'s name and power limit.  The source's defaults keep the
fastest; this module is a measurement, not a path of the port.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from .. import cuda_build
from ..matmul.tune import cuda_ms
from .ref import rwkv6_ref

# the module (the package's ``rwkv6`` is the ``ops`` entry point)
wkv = importlib.import_module(f"{__package__}.rwkv6")

#: (chunk, sub-chunk, rows a lane at N = 64); the first is the source's
CANDIDATES: List[Tuple[int, int, int]] = [
    (64, 16, 8), (32, 8, 8), (64, 8, 8), (96, 8, 8), (128, 8, 8),
    (96, 16, 8), (128, 16, 8), (64, 8, 4)]

#: name -> (B, T, from a state, lens or None)
CASES = {
    "prefill B=1 T=2048": (1, 2048, False, None),
    "ragged B=1 T=1999": (1, 1999, False, None),
    "chunk B=2 T=512 lens [512, 0]": (2, 512, True, [512, 0]),
    "decode B=4 T=1": (4, 1, True, None),
}

H, N = 40, 64
#: y vs the plain version, max|d|/max|ref| (chip_smoke TOL_SERVE_KERNEL)
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def job(cand: Tuple[int, int, int]):
    chunk, sub, rows = cand
    head = (f"#define WKV_CHUNK {chunk}\n#define WKV_SUB {sub}\n"
            f"#define WKV_R64 {rows}\n")
    name, source, dirs = wkv.source_job()
    return f"{name}_c{chunk}_s{sub}_r{rows}", head + source, dirs


def inputs(gen, b, t, dtype, with_s0, lens):
    def proj():
        return torch.randn((b, t, H, N), generator=gen, device="cuda") \
            .to(dtype).transpose(1, 2)

    w = torch.exp(-torch.exp(torch.randn(
        (b, t, H, N), generator=gen, device="cuda").clamp(-8, 4)))
    u = 0.1 * torch.randn((H, N), generator=gen, device="cuda")
    s0 = (torch.randn((b, H, N, N), generator=gen, device="cuda")
          if with_s0 else None)
    ln = (torch.tensor(lens, dtype=torch.int32, device="cuda")
          if lens is not None else None)
    return proj(), proj(), proj(), w.transpose(1, 2), u, s0, ln


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    jobs = [job(c) for c in CANDIDATES]
    cuda_build.build(jobs)
    fns = {}
    for cand, j in zip(CANDIDATES, jobs):
        print(f"[resources] {list(cand)} "
              f"{json.dumps(cuda_build.resources(j))}", flush=True)
        fns[cand] = wkv.bind(cuda_build.load(*j))
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = wkv._FN
    try:
        for name, (b, t, with_s0, lens) in CASES.items():
            for dtype in (torch.float32, torch.bfloat16):
                xs = inputs(gen, b, t, dtype, with_s0, lens)
                y_p, s_p = rwkv6_ref(*xs)
                times: Dict[Tuple[int, int, int], List[float]] = {
                    c: [] for c in CANDIDATES}
                for order in (CANDIDATES, CANDIDATES[::-1]):
                    for cand in order:
                        wkv._FN = fns[cand]

                        def run():
                            return wkv.rwkv6_kernel(*xs)

                        y, s = run()
                        ry = ((y.float() - y_p.float()).abs().max()
                              / y_p.float().abs().max()).item()
                        rs = ((s - s_p).abs().max()
                              / s_p.abs().max()).item()
                        if ry > TOL[dtype] or rs > 1e-5:
                            raise SystemExit(
                                f"tune: {name} {dtype} {cand}: y {ry:.3e}, "
                                f"state {rs:.3e}")
                        times[cand].append(cuda_ms(run, args.reps))
                for cand in CANDIDATES:
                    ms = sum(times[cand]) / len(times[cand])
                    print(json.dumps(dict(
                        case=name, dtype=str(dtype).split(".")[-1],
                        candidate=list(cand),
                        plan=wkv.wkv_plan(b, H, t, N)._asdict(),
                        ms_turns=times[cand], ms=ms)), flush=True)
    finally:
        wkv._FN = saved
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
