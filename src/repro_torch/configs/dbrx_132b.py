"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 fine-grained.
[hf:databricks/dbrx-base; unverified]

The JAX package's config as it stands: 48 query heads over 8 KV heads of
hd 128 (a GQA group of 6), 16 routed experts of width 10752 with the top
4 taken per token, no shared expert, capacity_factor 1.25 (the
``ArchConfig`` default), 131.6 B parameters by ``n_params()``: 3.26 B per
layer, 1.23 B in the embedding and the head.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=32768,
)
