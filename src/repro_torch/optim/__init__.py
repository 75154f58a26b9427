"""AdamW, the learning-rate schedule and gradient compression (PyTorch),
the counterparts of the JAX package's ``optim/``."""
from .adamw import OptState, adamw_init, adamw_update  # noqa: F401
from .compress import compress_grads, decompress_grads  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
