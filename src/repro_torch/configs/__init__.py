"""Architecture registry: one module per assigned architecture.

``get(name)`` returns the exact full-size ArchConfig; ``get_smoke(name)``
returns the reduced same-family config used by the CPU smoke tests.
"""

from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs.archs import ARCHS, SMOKE, get, get_smoke, list_archs

__all__ = ["ARCHS", "SMOKE", "get", "get_smoke", "list_archs", "shapes"]
