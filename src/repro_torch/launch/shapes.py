"""Assigned input-shape cells and per-arch applicability (DESIGN §4), the
JAX package's ``launch/shapes.py`` for the port.

Shape cells (LM transformers: seq_len x global_batch):
  train_4k    : seq 4,096   batch 256  -> train_step
  prefill_32k : seq 32,768  batch 32   -> prefill (forward)
  decode_32k  : seq 32,768  batch 128  -> serve_step (1 new token, KV=seq)
  long_500k   : seq 524,288 batch 1    -> serve_step; sub-quadratic only

``long_500k`` runs only for SSM/hybrid archs (rwkv6-3b, zamba2-7b); the
8 full-attention archs skip it (recorded skip).  whisper-tiny is enc-dec:
decode cells run against its decoder with the static 1500-frame encoder
memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCH_IDS
from ..models.common import ArchConfig, dtype_of

__all__ = ["ShapeCell", "SHAPE_CELLS", "cells_for_arch", "input_specs",
           "all_cells"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

_SUBQUADRATIC = {"rwkv6_3b", "zamba2_7b"}


def cells_for_arch(arch_id: str) -> List[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in _SUBQUADRATIC:
        cells.append("long_500k")
    return cells


def all_cells() -> List[Tuple[str, str]]:
    return [(a, c) for a in ARCH_IDS for c in cells_for_arch(a)]


def input_specs(cfg: ArchConfig, cell: ShapeCell,
                mode: Optional[object] = None) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of one cell: fake tensors of
    ``mode`` (a ``FakeTensorMode``; a new one when None), so nothing is
    allocated.  Modality frontends are stubs: whisper gets precomputed
    frame embeddings, llava gets anyres patch embeddings (image tokens
    count toward seq_len)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if mode is None:
        mode = FakeTensorMode()
    b, s = cell.global_batch, cell.seq_len
    act_dt = dtype_of(cfg)

    def sds(shape, dtype):
        with mode:
            return torch.empty(tuple(shape), dtype=dtype)

    if cell.kind in ("train", "prefill"):
        batch = {}
        s_text = s
        if cfg.family == "vlm":
            n_img = min(cfg.max_image_tokens, s // 2)
            n_img = (n_img // 576) * 576 or 576   # whole anyres tiles
            s_text = s - n_img
            batch["image_embeds"] = sds((b, n_img, cfg.d_model), act_dt)
        if cfg.family == "encdec":
            batch["frames"] = sds((b, cfg.encoder_len, cfg.d_model), act_dt)
        batch["tokens"] = sds((b, s_text), torch.int32)
        if cell.kind == "train":
            batch["labels"] = sds((b, s_text), torch.int32)
            batch["mask"] = sds((b, s_text), torch.float32)
        return batch
    # decode: one new token against a cache filled to seq_len
    batch = {"tokens": sds((b, 1), torch.int32),
             "lens": sds((b,), torch.int32)}
    if cfg.family == "encdec":
        batch["enc_out"] = sds((b, cfg.encoder_len, cfg.d_model), act_dt)
    return batch
