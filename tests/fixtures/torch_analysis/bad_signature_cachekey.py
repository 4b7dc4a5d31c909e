"""LC201 fixture: the reference's historical scenario cache-key bug, against the port.

The reference once keyed compiled runners by the scenario's name alone, so
two scenarios differing only in their MMPP burst shape shared one program.
In the port the key of a captured tick is ``ScenarioConfig.signature()``;
this fixture swaps in the name-only key and checks that the trace plane
flags the field it misses. ``schedule.mmpp_hi_factor`` does shape the port's
recorded op trace (the burst factor of tick 0 is a scalar argument of the
draws' rate), which ``tests/test_torch_analysis.py`` checks first.
"""

from repro_torch.analysis.trace_audit import (
    _base_state,
    audit_config,
    audit_signature_coverage,
    fingerprint,
    record_tick,
)
from repro_torch.workloads.scenario import SCENARIOS


def cachekey_omits_mmpp_fields():
    cfg = audit_config()
    base = _base_state(cfg)
    return audit_signature_coverage(
        SCENARIOS["bursty"],
        ("schedule.mmpp_hi_factor",),
        lambda sc: fingerprint(record_tick(cfg, sc, base)[0]),
        signature_fn=lambda sc: (sc.name,),  # the bug: name-only cache key
        subject="ScenarioConfig[bursty, name-only key]",
    )


LAMINAR_CHECK_TARGETS = [cachekey_omits_mmpp_fields]
