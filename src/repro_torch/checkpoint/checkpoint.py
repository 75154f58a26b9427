"""Checkpoints with atomic step directories, the JAX package's
``checkpoint/checkpoint.py`` on one device.

* **atomicity**: a step is written to ``step_<k>.tmp`` and renamed to
  ``step_<k>`` only after ``leaves.npz`` and ``manifest.json`` are
  written, so a crashed writer never corrupts the latest checkpoint;
* **the reference's layout**: leaves are saved as whole arrays under the
  reference's keys (``"/".join`` of dict keys, sequence indices and
  NamedTuple field names) in the reference's layout (a per-layer list
  stacked into ``(L, ...)`` leaves, ``models/convert.py``), so a
  checkpoint written by either package restores in the other;
* **journal**: ``manifest.json`` holds the caller's journal (the data
  cursor) so that the data pipeline resumes deterministically;
* **async**: ``save_checkpoint(..., blocking=False)`` returns once the
  leaves are staged in host memory; a writer thread persists them.

A bfloat16 leaf is stored as numpy stores the reference's: a 2-byte void
(``V2``).  Restore reads such a leaf into a bfloat16 target by viewing its
bits, never by a cast (numpy has no cast from ``V2``).

**Under a mesh** a DTensor leaf is saved whole (every rank gathers it,
rank 0 writes), and ``restore_checkpoint(..., shardings=)`` re-lays each
restored leaf onto the current mesh as a DTensor — the elastic restore:
a state saved from one world size restores on another with identical
values.  A DTensor in ``state_like`` keeps its layout.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import is_bf16_bits, tree_to_numpy

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "wait_for_writers"]

_WRITERS: list = []


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> Dict[str, np.ndarray]:
    """Every leaf of a numpy tree by its reference key."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(prefix): np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, prefix + (str(k),)))
    return flat


def save_checkpoint(ckpt_dir, step: int, state, *,
                    journal: Optional[Dict] = None, blocking: bool = True,
                    keep: int = 3) -> pathlib.Path:
    """Write ``state`` (a tree of tensors: dicts, lists, NamedTuples) as
    step ``step`` of ``ckpt_dir``, keeping the newest ``keep`` steps.  The
    leaves are copied to host memory before this returns; with
    ``blocking=False`` a thread writes them (:func:`wait_for_writers`)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # staged to host NOW; a DTensor leaf whole (a collective every rank
    # joins), written by rank 0 only
    flat = _flatten_with_paths(tree_to_numpy(_whole(state)))
    if not _writes():
        return ckpt_dir / f"step_{step}"

    def _write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "leaves.npz", **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(flat),
            "journal": journal or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
    else:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        _WRITERS.append(th)
    return ckpt_dir / f"step_{step}"


def _whole(tree):
    """``tree`` with every DTensor leaf gathered whole."""
    from torch.utils._pytree import tree_map

    from ..kernels.sharded import is_dtensor
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def _writes() -> bool:
    """This process writes checkpoints: rank 0 of a process group, or a
    process without one."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(
        (int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
         if not p.name.endswith(".tmp")))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def wait_for_writers() -> None:
    for th in list(_WRITERS):
        th.join()
        _WRITERS.remove(th)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device: bfloat16
    bits by a view, anything else by a cast."""
    arr = np.array(arr)  # an owned, contiguous copy (0-d kept)
    if is_bf16_bits(arr):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a "
                         f"target of shape {tuple(like.shape)}")
    return t.to(like.device)


def _restore(like: Any, flat: Dict[str, np.ndarray],
             prefix: Tuple[str, ...], index: Tuple[int, ...]) -> Any:
    """``like``'s tree with every tensor leaf read from ``flat``: a
    per-layer list's element ``i`` reads index ``i`` of the stacked leaf
    (the key skips the list)."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(v, flat, prefix + (k,), index)
                            for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _restore(v, flat, prefix + (str(k),), index)
                for k, v in like.items()}
    if isinstance(like, list) and like and isinstance(like[0], dict):
        return [_restore(v, flat, prefix, index + (i,))
                for i, v in enumerate(like)]
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(v, flat, prefix + (str(i),), index)
                          for i, v in enumerate(like))
    if not isinstance(like, torch.Tensor):
        return like
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    t = _leaf(arr[index] if index else arr, like)
    from ..kernels.sharded import is_dtensor
    if is_dtensor(like):
        from ..dist.spmd import shard_tensor
        t = shard_tensor(t, like.device_mesh, tuple(like.placements))
    return t


def restore_checkpoint(ckpt_dir, state_like, *, step: Optional[int] = None,
                       shardings=None) -> Tuple[Any, Dict]:
    """Restore step ``step`` (None: the latest) into the structure, dtypes
    and devices of ``state_like``; returns ``(state, journal)``.

    ``shardings`` (a tree congruent with ``state_like`` of
    :class:`~repro_torch.dist.spmd.NamedSharding`, or None leaves)
    re-lays each restored leaf onto its mesh as a DTensor, the spec
    fitted to the leaf's shape: the elastic restore."""
    wait_for_writers()
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "leaves.npz") as z:
        flat = {k: z[k] for k in z.files}
    state = _restore(state_like, flat, (), ())
    if shardings is not None:
        state = _relay(state, shardings)
    return state, manifest["journal"]


def _relay(x, s):
    """``x``'s tensor leaves laid out per the congruent ``s`` tree."""
    from ..dist.spmd import fit_spec, placements_for, shard_tensor

    if s is None:
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_relay(a, b) for a, b in zip(x, s)))
    if isinstance(x, dict):
        return {k: _relay(v, s[k]) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_relay(a, b) for a, b in zip(x, s))
    if not isinstance(x, torch.Tensor):
        return x
    spec = fit_spec(tuple(x.shape), s.spec, s.mesh)
    return shard_tensor(x, s.mesh, placements_for(spec, s.mesh))
