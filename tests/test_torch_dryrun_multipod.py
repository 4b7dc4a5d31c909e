"""gemma2-9b x train_4k on the reference's multi-pod mesh (2, 16, 16), at
smoke width, through the port's dry-run (``repro_torch.launch.dryrun``).

The cell once failed there only ("Sharding propagation failed for
aten.mm.default" on the tied head's weight gradient, then on a post-norm
block's output projection): the softcap's and the post-norms' gradients
came back with the sequence split over "model", and a weight gradient's
contraction over the flattened tokens met a strided split. The smaller fake
meshes of ``tests/test_torch_dryrun.py`` do not show it. In a file of its
own so that the test runner gives it a worker of its own (~40 s).
"""

from __future__ import annotations

from repro_torch.launch import dryrun


def test_gemma2_train_on_the_multi_pod_mesh():
    rec = dryrun.run_cell("gemma2-9b", "train_4k", True, verbose=False, smoke=True)
    assert rec["status"] == "ok", rec
    assert rec["devices"] == 2 * 16 * 16
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["count"] > 0
