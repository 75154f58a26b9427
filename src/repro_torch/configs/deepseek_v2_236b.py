"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (GQA kv=128) d_ff=1536
vocab=102400, MoE 160 experts top-6, MLA kv_lora=512, 2 shared experts.
[arXiv:2405.04434; hf]

The JAX package's config as it stands: multi-head latent attention
(128 heads of hd 128 plus a 64-wide rope part, so q / k rows of 192 and v
rows of 128; a 512-wide compressed latent cache beside a 64-wide rope
key cache), 160 routed experts of width 1536 with the top 6 taken per
token, 2 shared experts (one of width 2 x 1536), capacity_factor 1.25
(the ``ArchConfig`` default), 241.7 B parameters by ``n_params()``
(483 GB in bf16): 4.01 B per layer, 1.05 B in the embedding and the
head.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,              # fine-grained expert width
    vocab=102400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    d_expert=1536,
    mla_kv_lora=512,
    mla_rope_dim=64,
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=32768,
)
