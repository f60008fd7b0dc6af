"""Models of the port: the dense decoder LM for serving
(``transformer``) on the shared ``layers`` (port of ``repro.models``;
MoE, DiT, MMDiT and the vision models wait for later slices)."""

from repro_torch.models import layers, transformer

__all__ = ["layers", "transformer"]
