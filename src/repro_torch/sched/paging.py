"""Logical KV-page allocator: resource atoms for the serving control plane.

Pages are the serving-side analogue of Laminar's resource atoms: each replica
exposes a fixed page pool; requests declare page demands; the allocator is a
bitmap with the same feasibility semantics as the cluster engine (dispersed
pages — KV blocks need not be contiguous). Host-side numpy: the control plane
runs on the host in real serving systems; only the data plane runs on the
device. A line-for-line port of ``repro.sched.paging``.
"""

from __future__ import annotations

import numpy as np


class PageAllocator:
    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self.free = np.ones(self.num_pages, dtype=bool)

    @property
    def free_pages(self) -> int:
        return int(self.free.sum())

    def alloc(self, n: int):
        """Allocate n pages; returns index array or None if infeasible."""
        idx = np.nonzero(self.free)[0]
        if len(idx) < n:
            return None
        take = idx[:n]
        self.free[take] = False
        return take

    def release(self, pages) -> None:
        self.free[np.asarray(pages, dtype=int)] = True

    def utilization(self) -> float:
        return 1.0 - self.free_pages / max(self.num_pages, 1)
