"""Training launcher: the train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_11b \\
        --steps 50 --reduced --device cpu       # the plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_11b \\
        --steps 5 --batch 4 --seq 2048 --warmup 2   # full width, the card

Weights are random, drawn from a seeded ``torch.Generator``; batches come
from :class:`~repro_torch.data.pipeline.SyntheticLMStream` (a pure
function of its seed and the step, so a resumed run sees the batches it
would have seen).  The model, the optimizer state and every kernel run
on the card unless ``--device cpu`` is given (``--dry-run`` traces the
full config's ``train_4k`` cell on the CPU instead and prints its
result as JSON).  Features: microbatching,
gradient compression, checkpoints every ``--ckpt-every`` steps (written
by a thread) and resume from the newest one in ``--ckpt``, the
supervisor's heartbeats.  :func:`run` is the loop, callable with the
parsed flags; it returns the losses, grad norms, step times and the
card's peak memory.
"""
import argparse
import contextlib
import dataclasses
import json
import tempfile

import numpy as np
import torch

from ..api.options import resolve_device
from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                     save_checkpoint, wait_for_writers)
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import SyntheticLMStream
from ..ft.supervisor import Supervisor
from ..models.registry import get_model
from ..obs.clock import CLOCK as _clock
from ..train.step import TrainConfig, make_train_step, train_state_init

__all__ = ["parser", "run", "main"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="width-reduced config (CPU-runnable)")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the full config's train_4k cell on the "
                         "16x16 mesh and walk it; no execution")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["bf16", "topk"],
                    default=None)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args) -> dict:
    """The training loop of :func:`main` over parsed flags; returns
    ``{"losses", "grad_norms", "step_seconds", "peak_bytes", "start",
    "state", "model"}`` (``peak_bytes``: the card's
    ``max_memory_allocated`` over the run, None on the CPU).  With
    ``--dry-run`` it runs nothing and returns the full config's
    ``train_4k`` cell traced on the single-pod mesh
    (:func:`repro_torch.launch.dryrun.lower_cell`), on the CPU."""
    if args.dry_run:
        from .dryrun import lower_cell
        return lower_cell(args.arch, "train_4k", multi_pod=False,
                          microbatches=args.microbatches)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), max_seq=args.seq)
    device = resolve_device(args.device)  # no card: NoDeviceError
    model = get_model(cfg)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=args.warmup,
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       grad_compression=args.grad_compression)
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=args.batch,
                               seq_len=args.seq, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = train_state_init(model, gen, tcfg, device)
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, journal = restore_checkpoint(args.ckpt, state)
        start = journal.get("data_step", 0)
        print(f"resumed from step {start}")

    norms = []  # each step's global grad norm, on the device until the end
    step_fn = make_train_step(model, tcfg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, seconds = [], []
    metrics = None
    with contextlib.ExitStack() as stack:
        workdir = args.ckpt or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="disc_train_"))
        sup = Supervisor(workdir, hosts=["host0"], model_axis=1)
        for step in range(start, args.steps):
            t0 = _clock()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in stream.batch_at(step).items()}
            if cfg.family == "encdec":
                rng = np.random.RandomState(step)
                batch["frames"] = torch.from_numpy(
                    rng.randn(args.batch, cfg.encoder_len, cfg.d_model)
                    .astype(np.float32)).to(device)
            state, metrics = step_fn(state, batch)
            norms.append(metrics["grad_norm"])
            loss = float(metrics["loss"])  # waits for the step
            dt = _clock() - t0
            losses.append(loss)
            seconds.append(dt)
            sup.record_step(step, "host0", dt)
            if step % 10 == 0:
                print(f"step {step:4d}  loss {loss:.4f}  {dt:.2f}s/step")
            if args.ckpt and step and step % args.ckpt_every == 0:
                save_checkpoint(args.ckpt, step, state,
                                journal={"data_step": step}, blocking=False)
        wait_for_writers()
    if metrics is not None:
        print(f"final loss {float(metrics['loss']):.4f}")
    return dict(losses=losses, grad_norms=[float(n) for n in norms],
                step_seconds=seconds, start=start, state=state, model=model,
                peak_bytes=torch.cuda.max_memory_allocated(device)
                if cuda else None)


def main(argv=None):
    args = parser().parse_args(argv)
    out = run(args)
    if args.dry_run:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
