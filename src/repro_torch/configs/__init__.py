"""Architecture configs of the port (exact public-literature dimensions).

``get_config(arch_id)`` returns the config of every architecture of the
JAX package's ``repro.configs``, by its id or its dashed alias; an id the
port lacks raises.  ``NOT_PORTED`` names the architectures still waiting
for a slice of their own, and the slice each waits for: none now.
"""
from importlib import import_module

ARCH_IDS = ["dbrx_132b", "minitron_4b", "codeqwen15_7b", "tinyllama_11b",
            "granite_20b", "rwkv6_3b", "whisper_tiny", "zamba2_7b",
            "llava_next_34b", "deepseek_v2_236b"]

#: architectures of the JAX package not ported yet, and the slice each
#: waits for
NOT_PORTED: dict = {}

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS + list(NOT_PORTED)}


def get_config(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id in NOT_PORTED:
        raise KeyError(f"config {arch_id!r} is not ported yet: it waits "
                       f"for {NOT_PORTED[arch_id]}; ported: {ARCH_IDS}")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"config {arch_id!r} is not ported yet; ported: "
                       f"{ARCH_IDS}")
    mod = import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG
