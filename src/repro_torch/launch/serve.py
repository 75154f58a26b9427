"""Serving launcher: DISC-bucketed continuous batching on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_11b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_11b \\
        --reduced --device cpu --max-seq 128 --max-batch 2   # plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \\
        --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek_v2_236b --reduced

Weights are random, drawn from a seeded ``torch.Generator``; requests
come from :class:`~repro_torch.data.pipeline.VarLenRequestStream`.  The
model, its cache (KV rows, recurrent state, MLA's latent, or both for the
hybrid) and every kernel run on the card unless ``--device cpu`` is
given.  A model whose weights do not fit the card (DBRX at its 40
layers: 263 GB in bf16; DeepSeek-V2 at its 60: 483 GB) is refused before
anything is allocated: this launcher runs one card (a mesh of cards
takes ``ServeConfig(mesh=...)``).  ``--dry-run`` runs nothing: it traces
the full config's ``decode_32k`` cell on the 16x16 mesh on the CPU
(:func:`repro_torch.launch.dryrun.lower_cell`) and prints its result as
JSON.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_11b \\
        --dry-run
"""
import argparse
import dataclasses
import json

import torch

from ..api import ServeConfig, ServeEngine
from ..api.options import resolve_device
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import VarLenRequestStream
from ..models.common import dtype_of
from ..models.registry import get_model
from ..obs.clock import CLOCK as _clock


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the full config's decode_32k cell on the "
                         "16x16 mesh and walk it; no execution")
    args = ap.parse_args(argv)

    if args.dry_run:
        from .dryrun import lower_cell
        out = lower_cell(args.arch, "decode_32k", multi_pod=False)
        print(json.dumps(out))
        return out

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), max_seq=args.max_seq)
    engine_cfg = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                             device=args.device)
    model = get_model(cfg)
    device = resolve_device(args.device)  # no card: NoDeviceError
    if device.type == "cuda":
        need = cfg.n_params() * dtype_of(cfg).itemsize
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: {need / 1e9:.1f} GB of weights "
                f"({cfg.n_params() / 1e9:.2f} B parameters) against the "
                f"card's {have / 1e9:.1f} GB; serving it at full size "
                f"arrives with the port's multi-GPU slice (--reduced runs "
                f"on one card)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    engine = ServeEngine(model, params, engine_cfg)
    stream = VarLenRequestStream(vocab=cfg.vocab, min_len=4,
                                 max_len=args.max_seq // 2, seed=args.seed)
    reqs = stream.sample(args.requests)
    t0 = _clock()
    engine.submit(reqs)
    done = engine.run_until_done()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = _clock() - t0
    print(f"{len(done)}/{args.requests} requests in {dt:.1f}s; "
          f"{engine.stats['tokens_generated']} tokens; "
          f"prefill compiles {engine.stats['prefill_compiles']}")


if __name__ == "__main__":
    main()
