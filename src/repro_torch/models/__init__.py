"""Composable model stack for the assigned architectures (a port of
``repro.models``): attention, MLP and MoE blocks in a grouped stack, the
decoder LM with prefill and decode, and the bridge that carries the
reference's parameters across. The RG-LRU and SSD blocks are not ported
yet."""

from repro_torch.models import attention, blocks, bridge, lm, mlp, moe
from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig

__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SSMConfig",
    "attention",
    "blocks",
    "bridge",
    "lm",
    "mlp",
    "moe",
]
