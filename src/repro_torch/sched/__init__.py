"""Laminar-as-a-framework-feature: serving admission (a port of
``repro.sched``)."""

from repro_torch.sched.paging import PageAllocator
from repro_torch.sched.serving import LaminarServingScheduler, Request, ServeConfig

__all__ = ["PageAllocator", "LaminarServingScheduler", "Request", "ServeConfig"]
