"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; the vision tower is a STUB (input_specs
supplies precomputed patch embeddings; variable image-token counts are the
canonical DISC dynamic-shape workload).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The language model is the dense transformer with the image tokens'
embeddings (B, S_img, D) prepended to the text's (``transformer.forward``
``extra_embeds``); up to 5 anyres tiles of 576 patches.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    max_image_tokens=2880,   # anyres: up to 5 tiles x 576 patches
    dtype="bf16",
    act="silu",
    norm="rmsnorm",
    remat="full",
    max_seq=32768,
)
