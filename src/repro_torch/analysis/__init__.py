"""repro_torch.analysis — AST invariant checker over the port's own source.

The tier-1 tests prove the invariants hold at the callsites they cover;
this package makes the same invariants hold *everywhere*, at the AST:
fork/pickle safety for pool initargs, lock discipline for shared
attributes, device hygiene, exception discipline, and the schema/trace
constructor conventions. ``python -m repro_torch.analysis check`` is
the port's gate (``tests/test_torch_analysis.py`` runs it on the tree).

A copy of ``repro.analysis`` (imports rewritten to ``repro_torch.*``)
with these deliberate divergences:

* **Default roots.** ``engine.DEFAULT_ROOTS`` is ``("src/repro_torch",
  "chip_smoke.py", "tools")``, the port and what drives it; the
  reference scans ``("src", "benchmarks", "examples")``.
* **Default baseline.** ``baseline.DEFAULT_BASELINE`` is
  ``analysis-baseline-torch.json``, so the port's ``baseline``
  subcommand never rewrites the reference's ``analysis-baseline.json``.
* **Device hygiene in place of jit hygiene.** ``rules/jit.py`` checks
  ``jax.jit`` and ``pallas_call`` bodies, which the port does not have;
  its counterpart ``rules/device.py`` checks the same class of hazard
  (device-state discipline, hidden host round trips) as PyTorch/CUDA
  code shows it: ``torch-thread-no-device``, ``torch-cuda-in-fork`` and
  ``torch-host-sync-in-loop``. The CLI's description and this docstring
  name device hygiene accordingly.

The suppression grammar is the reference's (``# repro: ignore[rule-id]
-- why``), so one comment is read by both checkers; each ignores ids it
does not know.
"""
from repro_torch.analysis.engine import (Finding, analyze_paths,
                                         analyze_source, summarize)

__all__ = ["Finding", "analyze_paths", "analyze_source", "summarize"]
