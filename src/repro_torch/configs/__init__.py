"""Architecture registry of the port: the archs whose blocks are ported.

``get_arch(id)`` returns the ArchDef; an assigned arch that is not ported
yet raises and names its ROADMAP item.
"""

from repro_torch.configs import mamba2_130m, starcoder2_3b
from repro_torch.configs.base import ArchDef

ARCHS = {m.ARCH.arch_id: m.ARCH for m in (starcoder2_3b, mamba2_130m)}

# the reference's other assigned archs, and what they wait for
NOT_PORTED = {
    "granite-moe-1b-a400m": "ROADMAP A8 (models/moe.py)",
    "phi3.5-moe-42b-a6.6b": "ROADMAP A8 (models/moe.py)",
    "granite-20b": "ROADMAP A8 (its config)",
    "qwen1.5-110b": "ROADMAP A8 (its config)",
    "gemma3-12b": "ROADMAP A8 (its config)",
    "phi-3-vision-4.2b": "ROADMAP A8 (the vision path)",
    "zamba2-7b": "ROADMAP A8 (the shared-attention path)",
    "whisper-medium": "ROADMAP A8 (models/encdec.py)",
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: {NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(ARCHS)}")

