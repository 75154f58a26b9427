"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — Finch, data-dependent decay.  [arXiv:2404.05892; hf]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / ssm_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    ssm_state=64,
    ssm_head_dim=64,
    attn_kind="none",
    dtype="bf16",
    norm="layernorm",
    remat="full",
    max_seq=1048576,         # O(1) state: long-context capable
)
