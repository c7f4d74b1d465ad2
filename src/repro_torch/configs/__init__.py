"""Architecture registry of the port: the reference's ids, each module
exporting ``FULL`` (the published config) and ``SMOKE`` (a reduced
same-family config for CPU tests).  The port carries all ten: the four
dense token-input archs, the VLM (qwen2-vl: embeddings front end and
M-RoPE), RWKV-6, the two MoE archs, the hybrid Mamba arch (jamba) and
the encoder-decoder arch (whisper).  ``get`` of an id outside
``PORTED`` raises :class:`NotPortedError`.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.base import ArchConfig, NotPortedError

ARCH_IDS = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-3-8b": "granite_3_8b",
    "deepseek-67b": "deepseek_67b",
    "olmo-1b": "olmo_1b",
    "qwen3-8b": "qwen3_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-large-v3": "whisper_large_v3",
}

#: the module names of the archs this port carries
PORTED = ("granite_3_8b", "olmo_1b", "qwen3_8b", "deepseek_67b", "rwkv6_3b",
          "qwen2_moe_a2_7b", "llama4_scout_17b_a16e", "jamba_v0_1_52b",
          "whisper_large_v3", "qwen2_vl_72b")


def get(name: str, smoke: bool = False) -> ArchConfig:
    """``FULL`` (or ``SMOKE``) config of arch ``name`` (an id or a module
    name)."""
    mod = ARCH_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in PORTED:
        if mod not in ARCH_IDS.values():
            raise KeyError(f"unknown arch {name!r}; have {list(ARCH_IDS)}")
        raise NotPortedError(
            f"arch {name!r} is not yet ported to repro_torch (ported: "
            f"{', '.join(PORTED)})")
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.SMOKE if smoke else m.FULL


def list_archs() -> List[str]:
    """Every arch id of the reference, ported or not."""
    return list(ARCH_IDS)
