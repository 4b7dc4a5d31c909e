"""Composable model stack for the assigned architectures (a port of
``repro.models``): attention, MLP, MoE, RG-LRU and SSD blocks in a grouped
stack, the decoder LM with its loss, prefill and decode, and the bridge
that carries the reference's parameters, caches and optimizer states
across."""

from repro_torch.models import attention, blocks, bridge, lm, mlp, moe, rglru, ssd
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
    "rglru",
    "ssd",
]
