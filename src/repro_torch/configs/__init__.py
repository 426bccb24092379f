"""Architecture registry of the port: every arch of the reference.

``get_arch(id)`` returns the ArchDef; an unknown id raises ``KeyError``.
"""

from repro_torch.configs import (
    gemma3_12b,
    granite_20b,
    granite_moe_1b_a400m,
    mamba2_130m,
    phi3_vision_42b,
    phi35_moe_42b_a66b,
    qwen15_110b,
    starcoder2_3b,
    whisper_medium,
    zamba2_7b,
)
from repro_torch.configs.base import ArchDef

ARCHS = {
    m.ARCH.arch_id: m.ARCH
    for m in (
        granite_moe_1b_a400m,
        phi35_moe_42b_a66b,
        granite_20b,
        qwen15_110b,
        starcoder2_3b,
        gemma3_12b,
        mamba2_130m,
        zamba2_7b,
        phi3_vision_42b,
        whisper_medium,
    )
}

# the reference's archs that the port does not carry yet (none left)
NOT_PORTED: dict = {}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(ARCHS)}")
