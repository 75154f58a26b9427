"""Runs the port's mesh code over NCCL on several cards of one host, each
result held against the same function without a mesh on the rank's own
card.

    PYTHONPATH=src python tools/mesh_cards.py [--cards 4]

Starts one process a card (``torch.multiprocessing``, a NCCL group on
``127.0.0.1`` at a free port, a 180 s collective timeout), builds a
``("data", "model")`` mesh of shape (cards // 2, 2) and runs:

* ``tests/_torch_dist.py``'s ``_fn`` on both pipelines, on the
  ``"hopper"`` and ``"eager"`` backends, under ``dp`` / ``fsdp`` /
  ``tp``, two buckets, three calls each (the later two CUDA graph
  replays): the largest max|Δ| to the run without a mesh, captures,
  compiles and ``report()["sharding"]["collectives"]``;
* the reduced TinyLlama (2 layers, vocab 128) served by
  ``ServeEngine`` (2 replicas of 2 slots) under ``dp`` on a
  ``("data",)`` mesh of all the cards and under ``tp`` on the 2-D mesh:
  whether the streams equal the engine's without a mesh.

Prints every rank's results and exits non-zero where a rank raised, a
result exceeds 1e-5 of max|ref|, captures differ from compiles or the
streams differ.  Needs ``cards`` CUDA devices.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

TOL = 1e-5


def _rank(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180),
                            device_id=torch.device("cuda", rank))
    import disc_torch
    import _torch_dist as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    out = {}
    try:
        mesh = make_mesh((world // 2, 2), ("data", "model"))
        w1, w2 = (torch.from_numpy(w).cuda() for w in T.weights())
        for pipeline in ("dhlo", "jit"):
            specs = T._specs() if pipeline == "dhlo" else \
                [None, None, (disc_torch.Dim("B", max=64), 16)]
            for backend in ("hopper", "eager"):
                opts = dict(policy=T._granule1(), pipeline=pipeline,
                            backend=backend)
                base = disc_torch.compile(
                    T._fn, specs=specs,
                    options=disc_torch.CompileOptions(**opts))
                for prof in ("dp", "fsdp", "tp"):
                    sh = disc_torch.compile(
                        T._fn, specs=specs,
                        options=disc_torch.CompileOptions(
                            mesh=mesh, sharding_profile=prof, **opts))
                    worst = 0.0
                    for _ in range(3):
                        for x in T.xs():
                            xt = torch.from_numpy(x).cuda()
                            a, b = base(w1, w2, xt), sh(w1, w2, xt)
                            if hasattr(b, "full_tensor"):
                                b = b.full_tensor()
                            n = x.shape[0]
                            worst = max(worst, ((a[:n] - b[:n]).abs().max()
                                                / a[:n].abs().max()).item())
                    rep = sh.report()
                    out[f"{pipeline} {backend} {prof}"] = dict(
                        rel=worst, captures=rep["graphs"]["captures"],
                        compiles=rep["compiles"]["total"],
                        collectives=rep["sharding"]["collectives"])
        cfg, model, params = T.tiny_model()
        params = torch.utils._pytree.tree_map(lambda t: t.cuda(), params)

        def serve(**kw):
            eng = ServeEngine(model, params, ServeConfig(
                max_seq=64, max_batch=2, replicas=2, **kw))
            eng.submit(T.requests(cfg.vocab, [9, 5, 12, 7]))
            return eng.run_until_done()

        base = serve()
        for label, kw in (
                (f"dp ({world},)", dict(mesh=make_mesh((world,), ("data",)),
                                        sharding_profile="dp")),
                (f"tp ({world // 2}, 2)", dict(mesh=mesh,
                                               sharding_profile="tp"))):
            out[f"serve {label}"] = dict(streams_equal=serve(**kw) == base)
    except Exception:  # noqa: BLE001 — reported by the parent
        out["error"] = traceback.format_exc()
    q.put((rank, out))
    dist.barrier()
    dist.destroy_process_group()


def _ok(res: dict) -> bool:
    if "error" in res:
        return False
    for key, r in res.items():
        if key.startswith("serve"):
            if not r["streams_equal"]:
                return False
        elif r["rel"] > TOL or r["captures"] != r["compiles"]:
            return False
    return True


def main(argv=None) -> int:
    import queue

    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.cards or args.cards % 2:
        print(f"mesh_cards: needs an even {args.cards} CUDA devices, has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank, args=(r, args.cards, port, q))
             for r in range(args.cards)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + 700
    while len(got) < args.cards and time.monotonic() < deadline:
        try:
            rank, res = q.get(timeout=5)
            got[rank] = res
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    for rank in sorted(got):
        for key, res in got[rank].items():
            print(f"[rank {rank}] {key}: {res}", flush=True)
    ok = len(got) == args.cards and all(_ok(r) for r in got.values())
    print(f"[mesh_cards] {len(got)} of {args.cards} ranks reported, "
          f"{'all held' if ok else 'FAILED'}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
