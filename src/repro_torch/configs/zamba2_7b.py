"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336,
ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

The JAX package's config as it stands: 32 heads of hd 112 (MHA), 112
Mamba-2 heads of N = P = 64 (``d_in = 2 * d_model``), one shared
attention block every 6 Mamba blocks (13 invocations over 81 layers, the
remainder going to the last group), 12.84 B parameters by ``n_params()``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=1048576,
)
