"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5-arch.  [hf:Qwen/CodeQwen1.5-7B; hf]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=65536,
)
