"""LC303 fixture: cluster launches past the H100's limits.

Each plan is the one-cluster launch of ``survival_scan`` at the Exp5 shapes
with one fault:

  * ``cluster_16_portable`` — 16 CTAs a cluster without the non-portable
    attribute: the card takes at most 8 then;
  * ``cluster_32`` — 32 CTAs a cluster, past the 16 the H100 takes at all;
  * ``cluster_smem_over`` — the shared memory of 262 144 nodes over the 16
    CTAs: 16 384 nodes a CTA need 264 KiB, past the 227 KiB of a block.
"""

import dataclasses

from repro_torch.analysis.kernel_contract import audit_launch_plan
from repro_torch.kernels.survival_scan import plan as sp

GOOD = sp.plan(65536, 5000, True)
(LAUNCH,) = GOOD.launches


def _with(**kw):
    return dataclasses.replace(GOOD, launches=(dataclasses.replace(LAUNCH, **kw),))


PLANS = {
    "cluster_16_portable": _with(cluster_nonportable=False),
    "cluster_32": _with(grid=32, cluster=32),
    "cluster_smem_over": _with(dynamic_smem=sp.smem_bytes(4 * 65536)),
}


def cluster_16_portable():
    return audit_launch_plan(PLANS["cluster_16_portable"], name="survival_scan[portable 16]")


def cluster_32():
    return audit_launch_plan(PLANS["cluster_32"], name="survival_scan[cluster 32]")


def cluster_smem_over():
    return audit_launch_plan(PLANS["cluster_smem_over"], name="survival_scan[smem]")


LAMINAR_CHECK_TARGETS = [cluster_16_portable, cluster_32, cluster_smem_over]
