"""Times candidate tiles of the GEMM's f32 (FFMA) body on the card.

    PYTHONPATH=src python -m repro_torch.kernels.matmul.tune [--reps 20]

For each shape of :data:`SHAPES` (the f32 kDot programs of
``chip_smoke.py``'s path 2 at T = 1999 and at its T = 37 bucket, and the
library phase's five §4.5 shapes) and each tile of :data:`CANDIDATES`
for the tile name that shape runs at, it builds one library per
candidate (all ``nvcc`` processes at once), prints each instance's
registers and local memory (``cuda_build.resources``), holds the
candidate against the plain version (max|d|/max|ref| <= 1e-5), and
times it with CUDA events, L2 flushed before each launch, the
candidates in turns A B .. B A so that a drift of the card's clock
falls on both sides.  One JSON line per (shape, candidate) and a
``[card]`` line with ``nvidia-smi``'s name and power limit.  The tile
table :data:`~repro_torch.kernels.matmul.matmul.TILES` keeps the
fastest; this module is a measurement, not a path of the port.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from .. import cuda_build
from ..program import Program, Step
from .ref import matmul_fused_ref

# the module (the package's ``matmul`` is the ``ops`` entry point)
mm = importlib.import_module(f"{__package__}.matmul")

F32 = torch.float32

#: tile name -> candidate (BM, BN, BK, TM, TN, STAGES, MINB) tiles, the
#: one :data:`~repro_torch.kernels.matmul.matmul.TILES` keeps first
CANDIDATES: Dict[str, List[Tuple[int, ...]]] = {
    "kdot": [(128, 256, 32, 8, 16, 4, 1), (128, 128, 16, 8, 8, 4, 2),
             (128, 128, 8, 8, 8, 4, 2), (128, 128, 16, 8, 8, 3, 2),
             (128, 128, 32, 8, 8, 3, 2), (128, 256, 16, 8, 16, 3, 1),
             (256, 128, 16, 16, 8, 3, 1), (128, 128, 16, 16, 8, 4, 2),
             (128, 128, 16, 8, 16, 4, 2), (128, 256, 32, 8, 16, 3, 1),
             (128, 256, 16, 8, 16, 6, 1), (128, 256, 8, 8, 16, 6, 1),
             (256, 128, 16, 16, 8, 4, 1), (128, 256, 16, 8, 16, 4, 1)],
    "square_big": [(128, 256, 32, 8, 16, 4, 1), (128, 128, 16, 8, 8, 4, 2),
                   (128, 256, 16, 8, 16, 3, 1), (256, 128, 16, 16, 8, 3, 1),
                   (128, 256, 16, 8, 16, 4, 1), (128, 256, 32, 8, 16, 3, 1)],
    "balanced": [(128, 64, 32, 8, 4, 3, 2), (64, 64, 16, 4, 4, 4, 2),
                 (64, 64, 16, 4, 4, 4, 4), (128, 128, 16, 8, 8, 4, 2),
                 (128, 64, 16, 8, 4, 4, 2)],
    "skinny_m": [(32, 64, 16, 4, 4, 4, 4), (32, 64, 16, 4, 4, 4, 2),
                 (32, 128, 16, 4, 8, 4, 2), (32, 128, 32, 4, 4, 3, 2)],
    "skinny_n": [(64, 32, 16, 4, 4, 4, 2), (64, 32, 16, 4, 4, 4, 4),
                 (128, 32, 16, 8, 4, 4, 2), (128, 32, 32, 4, 4, 3, 2)],
    "deep_k": [(64, 64, 32, 4, 4, 4, 2), (64, 64, 16, 4, 4, 4, 4),
               (64, 64, 32, 4, 4, 3, 3), (128, 128, 16, 8, 8, 4, 2)],
}


def _silu_h() -> Program:
    return Program((F32, F32), (
        Step("logistic", (("in", 0),), F32),
        Step("mul", (("in", 0), ("t", 0)), F32),
        Step("mul", (("t", 1), ("in", 1)), F32)), (("t", 2),))


def _residual() -> Program:
    return Program((F32, F32), (Step("add", (("in", 0), ("in", 1)), F32),),
                   (("t", 0),))


#: shape name -> (tile name, (M, K, N) padded, (vm, vn, vk) valid,
#: epilogue program, whether it reads an (M, N) extra)
SHAPES = {
    "kdot silu_h T=1999": ("kdot", (2048, 2048, 5632), (1999, 5632, 2048),
                           _silu_h, True),
    "kdot +res T=1999": ("kdot", (2048, 5632, 2048), (1999, 2048, 5632),
                         _residual, True),
    "kdot silu_h T=37": ("kdot", (64, 2048, 5632), (37, 5632, 2048),
                         _silu_h, True),
    "kdot +res T=37": ("kdot", (64, 5632, 2048), (37, 2048, 5632),
                       _residual, True),
    "square_big": ("square_big", (2048, 2048, 5632), (2048, 5632, 2048),
                   lambda: mm.identity_program(F32), False),
    "balanced": ("balanced", (1024, 2048, 256), (1024, 256, 2048),
                 lambda: mm.identity_program(F32), False),
    "skinny_m": ("skinny_m", (32, 2048, 2048), (32, 2048, 2048),
                 lambda: mm.identity_program(F32), False),
    "skinny_n": ("skinny_n", (512, 2048, 32), (512, 32, 2048),
                 lambda: mm.identity_program(F32), False),
    "deep_k": ("deep_k", (256, 5632, 256), (256, 256, 5632),
               lambda: mm.identity_program(F32), False),
}


@contextlib.contextmanager
def candidate(tile: str, shape: Tuple[int, ...]):
    """``tile`` runs at ``shape``, in a library of that tile alone."""
    saved = mm.TILES[tile], mm.KDOT_TILES, mm.LIBRARY_TILES
    mm.TILES[tile] = shape
    if tile in mm.LIBRARY_TILES:
        mm.LIBRARY_TILES = (tile,)
    mm._FNS.clear()
    try:
        yield
    finally:
        mm.TILES[tile], mm.KDOT_TILES, mm.LIBRARY_TILES = saved
        mm._FNS.clear()


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` per call, the L2 flushed before each,
    a spin kernel ahead of the start event so the interval holds device
    time."""
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


def clock_under_load(fn, seconds: float) -> dict:
    """The SM clock (MHz) and board power (W) ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back for ``seconds``: their
    medians and the number of samples."""
    import time

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(x) for x in line.split(",")]
            for line in out.strip().splitlines()[2:]]  # skip the ramp-up
    clocks = sorted(r[0] for r in rows)
    power = sorted(r[1] for r in rows)
    return dict(sm_clock_mhz=clocks[len(clocks) // 2] if clocks else None,
                power_w=power[len(power) // 2] if power else None,
                samples=len(rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--clock-seconds", type=float, default=0.0,
                    help="also sample the SM clock and power while each "
                         "shape's first candidate and torch.matmul run "
                         "back to back this long (0: not sampled)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    jobs, seen = [], set()
    for name in args.shapes:
        tile, _, _, make, _ = SHAPES[name]
        for shape in CANDIDATES[tile]:
            with candidate(tile, shape):
                job = (*mm.kernel_source(make(), F32, (tile,)),
                       mm.INCLUDE_DIRS)
            if job[0] + job[1] not in seen:
                seen.add(job[0] + job[1])
                jobs.append((tile, shape, job))
    cuda_build.build([job for _, _, job in jobs])
    for tile, shape, job in jobs:
        print(f"[resources] {tile} {list(shape)} "
              f"{json.dumps(cuda_build.resources(job))}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.shapes:
        tile, (m, k, n), valid, make, extra = SHAPES[name]
        prog = make()
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") / 32
        xs = [torch.randn((m, n), generator=gen, device="cuda")] \
            if extra else []
        vm, vn, vk = valid
        want = matmul_fused_ref(a, b, xs, prog, valid, [F32])[0]
        scale = want.abs().max().item()
        shapes = CANDIDATES[tile]
        times: Dict[Tuple[int, ...], List[float]] = {s: [] for s in shapes}
        for order in (shapes, shapes[::-1]):
            for shape in order:
                with candidate(tile, shape):
                    def run():
                        return mm.matmul_epilogue_kernel(
                            a, b, xs, prog, valid, [F32], tile=tile)

                    rel = (run()[0] - want).abs().max().item() / scale
                    if rel > 1e-5:
                        raise SystemExit(f"tune: {name} {shape}: "
                                         f"max|d|/max|ref| {rel:.3e}")
                    times[shape].append(cuda_ms(run, args.reps))
        lib_ms = cuda_ms(lambda: torch.matmul(a[:vm, :vk], b[:vk, :vn]),
                         args.reps)
        if args.clock_seconds > 0:
            with candidate(tile, shapes[0]):
                load = clock_under_load(
                    lambda: mm.matmul_epilogue_kernel(
                        a, b, xs, prog, valid, [F32], tile=tile),
                    args.clock_seconds)
            lib_load = clock_under_load(
                lambda: torch.matmul(a[:vm, :vk], b[:vk, :vn]),
                args.clock_seconds)
            print(json.dumps(dict(shape=name, candidate=list(shapes[0]),
                                  kernel_load=load,
                                  library_load=lib_load)), flush=True)
        for shape in shapes:
            ms = sum(times[shape]) / len(times[shape])
            with candidate(tile, shape):
                plan = mm.gemm_plan(F32, tile, vm, vn, vk)
            print(json.dumps(dict(
                shape=name, tile=tile, candidate=list(shape),
                valid=list(valid), ms_turns=times[shape], ms=ms,
                tflops=2 * vm * vn * vk / ms / 1e9, splits=plan.splits,
                library_ms=lib_ms, library_ratio=ms / lib_ms)), flush=True)
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
