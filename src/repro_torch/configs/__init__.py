"""Architecture registry (port of ``repro.configs``): ``get(arch_id)``.

Only the dense decoder LMs are ported. The MoE, diffusion and vision ids
of the JAX registry are known here but raise ``NotImplementedError``
until their model families are ported (ROADMAP.md, item 17)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import LM_SHAPES, Arch

_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
}

#: ids of the JAX registry whose model families are not ported yet
NOT_PORTED = ("deepseek-moe-16b", "arctic-480b", "flux-dev", "dit-l2",
              "convnext-b", "resnet-152", "efficientnet-b7", "resnet-50")

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> Arch:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: only the dense LMs are "
            f"(ROADMAP.md item 17: MoE, DiT, MMDiT and the vision models)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH


__all__ = ["Arch", "LM_SHAPES", "ARCH_IDS", "NOT_PORTED", "get"]
