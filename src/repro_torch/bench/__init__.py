"""Unified benchmark subsystem (see DESIGN.md §bench), ported.

The measurement backbone: a scenario registry spanning the paper's whole
protocol matrix, a sweep harness that emits schema-validated RunRecord
JSON plus derived decision reports, and a noise-aware record-set compare
gate for CI. ``python -m repro_torch.bench`` (``cli.py``) is its
command line; a sweep runs on the card unless ``--device cpu`` is given.
"""
from repro_torch.bench.compare import (CompareEntry, CompareResult,
                                       attribute_result, compare_paths,
                                       compare_records, summary_markdown)
from repro_torch.bench.harness import (DEFAULT_OUT, SweepResult,
                                       render_report, run_sweep)
from repro_torch.bench.history import (HistoryRun, HistoryStore,
                                       attribute_stages)
from repro_torch.bench.registry import (PROFILES, BenchSelectionError,
                                        Profile, Scenario, build_registry,
                                        scenario_names, select_scenarios)

__all__ = [
    "CompareEntry", "CompareResult", "attribute_result", "compare_paths",
    "compare_records", "summary_markdown",
    "DEFAULT_OUT", "SweepResult", "render_report", "run_sweep",
    "HistoryRun", "HistoryStore", "attribute_stages",
    "PROFILES", "BenchSelectionError", "Profile", "Scenario",
    "build_registry", "scenario_names", "select_scenarios",
]
