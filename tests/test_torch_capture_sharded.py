"""The zone-sharded engine's compiled run (``ZoneShardedEngine.simulate``
through ``repro_torch.core.scan``) on two gloo ranks, on the CPU.

On CUDA every rank captures one sharded tick, its five collectives
included, as a CUDA graph and replays it; on the CPU the same in-place body
runs in a loop. Here, on two gloo ranks in two processes
(``parallel.local.spawn_ranks``), 40 ticks of 64 nodes in two zones (a zone
a rank):

  * that body equals ``make_step`` with the rank's mesh plane driven by
    hand, bit for bit: the series, every leaf of the final state and where
    the provider's generator ends; Exp5's settings with Airlock off and on,
    and storm (disruption, bursts); both ranks hold the same result;
  * ``MeshPlane._gather``'s one ``all_gather_into_tensor`` equals the list
    form ``all_gather`` it replaced;
  * two seeds whose zones differ but whose (Z, M) shapes are equal, through
    one engine: each equals its own eager run, and the engine keeps a
    compiled tick for each geometry (a cache keyed on shapes alone would
    replay the first seed's block tables for the second).

The live JAX sharded engine holds the same body on two ranks in
``test_torch_shard.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
from _torch_capture_workers import sharded_cases

from repro_torch.parallel.local import spawn_ranks

TICKS = 40
CASES = ("kernel-oom", "airlock", "storm")


@functools.lru_cache(maxsize=None)
def _ranks():
    """Both ranks' results, one spawn for the whole file."""
    return spawn_ranks(sharded_cases, 2, (CASES, TICKS), device="cpu")


def _equal_runs(r):
    assert np.array_equal(r["ts"], r["eager_ts"])
    assert len(r["state"]) == len(r["eager_state"])
    for a, b in zip(r["state"], r["eager_state"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(r["gen"], r["eager_gen"])
    assert r["compiled"] == 1
    assert r["ts"].shape == (TICKS, 11) and r["ts"][-1, 1] > 0  # tasks started


def _same_on_both_ranks(a, b):
    assert np.array_equal(a["ts"], b["ts"])
    for x, y in zip(a["state"], b["state"]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("case", CASES)
def test_sharded_body_equals_make_step(case):
    r0, r1 = (out[case] for out in _ranks())
    _equal_runs(r0)
    _equal_runs(r1)
    _same_on_both_ranks(r0, r1)


def test_all_gather_into_tensor_equals_the_list_form():
    for out in _ranks():
        g = out["gather"]
        assert np.array_equal(g["into_tensor"], g["list"])
        assert g["list"][:, 0, 0].tolist() == [1000, 1024, 1048, 2000, 2024, 2048]  # rank r's rows


def test_two_geometries_through_one_engine():
    for out in _ranks():
        a, b = out["geometry"]
        assert a["zcount"].tolist() != b["zcount"].tolist()
        assert sorted(a["zcount"].tolist()) == sorted(b["zcount"].tolist())  # equal shapes
        _equal_runs(a)
        _equal_runs(b)
        assert out["geometry_compiled"] == 2
    _same_on_both_ranks(_ranks()[0]["geometry"][1], _ranks()[1]["geometry"][1])
