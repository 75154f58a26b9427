"""Checkpoints with atomic step directories (PyTorch), the counterpart of
the JAX package's ``checkpoint/``."""
from .checkpoint import (latest_step, restore_checkpoint,  # noqa: F401
                         save_checkpoint, wait_for_writers)
