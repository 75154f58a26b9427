"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron.  [arXiv:2407.14679; hf]

``sharding_profile="fsdp"`` is carried as a field only: the port runs
on one device until its multi-GPU slice.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    sharding_profile="fsdp",   # ZeRO-3 train layout for 4B
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=32768,
)
