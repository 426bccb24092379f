"""Architecture registry of the port: the archs whose blocks are ported.

``get_arch(id)`` returns the ArchDef; an assigned arch that is not ported
yet raises and names its ROADMAP item.
"""

from repro_torch.configs import (
    gemma3_12b,
    granite_20b,
    granite_moe_1b_a400m,
    mamba2_130m,
    phi35_moe_42b_a66b,
    qwen15_110b,
    starcoder2_3b,
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
    )
}

# the reference's other assigned archs, and what they wait for
NOT_PORTED = {
    "zamba2-7b": "ROADMAP A8c (the shared-attention path)",
    "phi-3-vision-4.2b": "ROADMAP A8d (the vision path)",
    "whisper-medium": "ROADMAP A8e (models/encdec.py)",
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(ARCHS)}")
