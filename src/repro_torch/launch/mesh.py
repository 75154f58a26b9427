"""Mesh construction — general factory + production presets.

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device.

:func:`make_mesh` builds a ``torch.distributed.device_mesh.DeviceMesh``
of any shape over any axis names on the initialized default process
group (every rank calls it, in the same order); :func:`make_production_mesh`
keeps the production shapes as presets on top of it (16×16 single-pod,
2×16×16 two-pod).

Ranks are processes: start ``prod(shape)`` of them with ``torchrun
--nproc-per-node=N`` (or ``torch.distributed.init_process_group`` with
its address, world size and rank) before building the mesh.  A one-rank
mesh may start its own one-rank group (a ``HashStore``; ``nccl`` on the
card, ``gloo`` for ``device_type="cpu"``).  The device type is ``cuda``
unless the caller asks for ``cpu``; nothing moves a mesh to the CPU, or
puts CUDA tensors on ``gloo``, by itself.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..errors import NoDeviceError

__all__ = ["make_mesh", "make_production_mesh", "MESH_AXES",
           "PRODUCTION_SHAPES"]

MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}

#: preset name -> (shape, axes)
PRODUCTION_SHAPES = {
    "single": ((16, 16), MESH_AXES["single"]),
    "multi": ((2, 16, 16), MESH_AXES["multi"]),
}

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _one_rank_group(device_type: str) -> None:
    """A one-rank default group of its own, on an in-process store."""
    dist.init_process_group(_BACKEND[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda"):
    """A mesh of ``shape`` over ``axes`` on the first ``prod(shape)``
    ranks of the default process group (or on the explicit ``devices``,
    a list of global ranks).  Without an explicit list ``prod(shape)``
    must equal the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} dims but {len(axes)} "
            f"axis names {axes}")
    if device_type not in _BACKEND:
        raise ValueError(f"make_mesh: device_type {device_type!r} "
                         f"(expected 'cuda' or 'cpu')")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            f"make_mesh was asked for a mesh of CUDA devices (the "
            f"default), but no CUDA device is present; pass "
            f"device_type='cpu' for a gloo mesh of CPU ranks on purpose")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"mesh {shape} needs {n} ranks, but no process group is "
                f"initialized: start {n} processes with torchrun "
                f"--nproc-per-node={n} (or init_process_group with "
                f"world_size={n}) before make_mesh")
        _one_rank_group(device_type)
    backend = dist.get_backend()
    want = _BACKEND[device_type]
    if backend not in (want, "fake"):
        raise ValueError(
            f"make_mesh(device_type={device_type!r}) on a {backend!r} "
            f"process group: {device_type} tensors need {want!r}")
    world = dist.get_world_size()
    if devices is None:
        if n != world:
            raise RuntimeError(
                f"mesh {shape} needs {n} ranks, the process group has "
                f"{world}: start {n} processes with torchrun "
                f"--nproc-per-node={n}")
        ranks = list(range(n))
    else:
        ranks = [int(r) for r in devices][:n]
        if len(ranks) < n or any(not 0 <= r < world for r in ranks):
            raise RuntimeError(
                f"mesh {shape} needs {n} ranks out of the process "
                f"group's {world}, got {list(devices)}: start more "
                f"processes with torchrun --nproc-per-node={n}")
    if device_type == "cuda":
        # one card a rank, by its rank on this host
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return make_mesh(shape, axes, device_type=device_type)
