"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]

The JAX package's config as it stands: one KV head for 48 query heads of
hd 128 (a group of 48 in the flash-attention kernel's decode form), a
GELU MLP and LayerNorm.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,            # MQA
    d_ff=24576,
    vocab=49152,
    dtype="bf16",
    act="gelu",
    norm="layernorm",
    remat="full",
    max_seq=32768,
)
