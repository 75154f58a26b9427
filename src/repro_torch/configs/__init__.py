"""Architecture configs ported so far (exact public-literature dimensions).

``get_config("tinyllama_11b")`` returns the config; the other architectures
of the JAX package's ``repro.configs`` arrive with their model families.
"""
from importlib import import_module

ARCH_IDS = ["tinyllama_11b"]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"config {arch_id!r} is not ported yet; ported: "
                       f"{ARCH_IDS}")
    mod = import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG
