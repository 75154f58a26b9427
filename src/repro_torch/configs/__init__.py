"""Architecture configs ported so far (exact public-literature dimensions).

``get_config(arch_id)`` returns the config of every architecture of the
JAX package's ``repro.configs`` but ``deepseek_v2_236b``, whose MLA
attention (q/k dim 192, v dim 128; the absorbed decode at 576 / 512)
the flash-attention kernel does not take yet: it raises, naming that
slice.
"""
from importlib import import_module

ARCH_IDS = ["dbrx_132b", "minitron_4b", "codeqwen15_7b", "tinyllama_11b",
            "granite_20b", "rwkv6_3b", "whisper_tiny", "zamba2_7b",
            "llava_next_34b"]

#: architectures of the JAX package not ported yet, and the slice each
#: waits for
NOT_PORTED = {"deepseek_v2_236b": "its MLA attention (ROADMAP Queue 1 "
                                  "item 6)"}

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
