"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec; conv frontend is a STUB (input_specs supplies precomputed frame
embeddings, 1500 x 384).  [arXiv:2212.04356; unverified]

The JAX package's config as it stands: 4 decoder and 4 encoder layers,
6 heads of hd 64 (no GQA), GELU and LayerNorm; the encoder reads a
static 1500 frames.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,              # decoder layers
    n_encoder_layers=4,
    encoder_len=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    dtype="bf16",
    act="gelu",
    norm="layernorm",
    remat="none",
    max_seq=32768,
)
