"""laminar-check for the PyTorch port: its own contracts, three planes.

One CLI (``python -m repro_torch.analysis``), the rule ids of the JAX
package's ``repro.analysis``, their meaning in the port:

  * trace  — :mod:`repro_torch.analysis.trace_audit`: record the aten ops
    of one tick and the making of its draws on the CPU (the hot-path
    entries stubbed by their plans' outputs) and check host syncs, dtypes,
    CPU-vs-CUDA output parity and that the scenario cache key covers every
    field that shapes the recorded ops;
  * kernel — :mod:`repro_torch.analysis.kernel_contract`: check each
    hand-written kernel's launch plan (coverage, bounds, the H100's
    per-block budget, outputs against the ``_ref`` twin) at the reference
    geometries and the main paths' shapes; it holds the plan interpreter;
  * lint   — :mod:`repro_torch.analysis.lint`: AST rules over
    ``src/repro_torch`` (host syncs and numpy in the tick, kernel entries
    without a twin or a test, config mutation).

Imports neither JAX nor the JAX package.
"""

from repro_torch.analysis.findings import RULES, Finding, Rule, filter_suppressed

__all__ = ["Finding", "Rule", "RULES", "filter_suppressed"]
