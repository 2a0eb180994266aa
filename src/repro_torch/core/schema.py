"""Raw-result schema — the JSON the paper's artifact stores per run.

Every benchmark emits RunRecords; every table/figure is regenerated from
records (recorded paper matrix or live measurements), never hand-entered
downstream.

Version 2 adds explicit validation and a payload envelope: record files
carry ``schema_version`` plus a host fingerprint, and every record is
checked field-by-field on both save and load, so a malformed bench run
fails at the emitter — not three PRs later inside a compare gate.
A record can also represent an *explicitly skipped* scenario
(``meta.status == "skipped"``): the scenario matrix stays complete in
every profile, and downstream aggregation filters on status.
"""
from __future__ import annotations

import dataclasses
import json
import platform
import sys
import time
from typing import Dict, List

from repro_torch.common.hw import host_fingerprint

SCHEMA_VERSION = 2

# The evaluation-protocol vocabulary. "single_thread" and "dataloader" are
# the paper's pair; the rest are this repo's extensions (batched decode and
# the online service's two load models).
PROTOCOLS = ("single_thread", "dataloader", "batched",
             "service_closed", "service_open")
MODES = ("", "thread", "process")
STATUSES = ("ok", "skipped", "error")


class SchemaError(ValueError):
    """A record or payload violates the RunRecord schema."""


@dataclasses.dataclass
class RunRecord:
    platform: str                  # e.g. "AMD Zen 4" or "live-host"
    decoder: str
    protocol: str                  # one of PROTOCOLS
    workers: int                   # 0 for single-thread protocol
    mode: str                      # "", "thread", "process"
    throughput_mean: float         # images/s
    throughput_std: float
    samples: List[float] = dataclasses.field(default_factory=list)
    num_images: int = 0
    skip_indices: List[int] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def skips(self) -> int:
        return len(self.skip_indices)

    @property
    def status(self) -> str:
        return self.meta.get("status", "ok")

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def scenario(self) -> str:
        """Stable compare key: explicit scenario name when the bench
        harness emitted one, else the protocol coordinates."""
        return self.meta.get("scenario") or "/".join(
            (self.protocol, self.decoder, f"w{self.workers}",
             self.mode or "-"))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "RunRecord":
        return RunRecord(**validate_record(d))


# ------------------------------------------------------------- validation
_FIELDS = {
    "platform": str,
    "decoder": str,
    "protocol": str,
    "workers": int,
    "mode": str,
    "throughput_mean": (int, float),
    "throughput_std": (int, float),
    "samples": list,
    "num_images": int,
    "skip_indices": list,
    "meta": dict,
}


def validate_record(d: dict) -> dict:
    """Check one JSON record against the schema; returns ``d`` unchanged.

    Raises SchemaError naming the offending field — the error message is
    the debugging surface when a bench emitter drifts from the schema.
    """
    if not isinstance(d, dict):
        raise SchemaError(f"record must be an object, got {type(d).__name__}")
    unknown = set(d) - set(_FIELDS)
    if unknown:
        raise SchemaError(f"unknown record fields {sorted(unknown)}")
    for name, typ in _FIELDS.items():
        if name not in d:
            if name in ("samples", "skip_indices", "meta", "num_images"):
                continue               # defaulted fields
            raise SchemaError(f"missing field {name!r}")
        val = d[name]
        if isinstance(typ, tuple):
            if not isinstance(val, typ) or isinstance(val, bool):
                raise SchemaError(
                    f"field {name!r}: expected number, got {val!r}")
        elif not isinstance(val, typ) or (typ is int and
                                          isinstance(val, bool)):
            raise SchemaError(
                f"field {name!r}: expected {typ.__name__}, got {val!r}")
    if d["protocol"] not in PROTOCOLS:
        raise SchemaError(
            f"field 'protocol': {d['protocol']!r} not in {PROTOCOLS}")
    if d["mode"] not in MODES:
        raise SchemaError(f"field 'mode': {d['mode']!r} not in {MODES}")
    if d["workers"] < 0:
        raise SchemaError(f"field 'workers': must be >= 0, got {d['workers']}")
    if d["throughput_mean"] < 0 or d["throughput_std"] < 0:
        raise SchemaError("throughput fields must be >= 0")
    for s in d.get("samples", []):
        if not isinstance(s, (int, float)) or isinstance(s, bool):
            raise SchemaError(f"field 'samples': non-numeric entry {s!r}")
    for i in d.get("skip_indices", []):
        if not isinstance(i, int) or isinstance(i, bool):
            raise SchemaError(f"field 'skip_indices': non-int entry {i!r}")
    status = d.get("meta", {}).get("status", "ok")
    if status not in STATUSES:
        raise SchemaError(f"meta.status {status!r} not in {STATUSES}")
    stage_s = d.get("meta", {}).get("stage_s")
    if stage_s is not None:
        # traced sweeps attach a per-stage wall-time breakdown; keep it
        # machine-checkable so downstream stage attribution can trust it
        if not isinstance(stage_s, dict):
            raise SchemaError(
                f"meta.stage_s: expected object, got {stage_s!r}")
        for k, v in stage_s.items():
            if not isinstance(k, str):
                raise SchemaError(f"meta.stage_s: non-string stage {k!r}")
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                raise SchemaError(
                    f"meta.stage_s[{k!r}]: expected non-negative "
                    f"number, got {v!r}")
    return d


def host_metadata() -> dict:
    """The host a record file was written on; ``fingerprint`` is
    ``repro_torch.common.hw.host_fingerprint()``, which names the device
    the calling context selected (the card, or the CPU when asked for)."""
    import os
    return {
        "python": sys.version.split()[0],
        "machine": platform.machine(),
        "processor": platform.processor() or "unknown",
        "cpus": os.cpu_count(),
        "time": time.time(),
        "fingerprint": host_fingerprint(),
    }


def save_records(records: List[RunRecord], path: str, *,
                 extra: Dict = None) -> None:
    payload = {"schema_version": SCHEMA_VERSION,
               "host": host_metadata(),
               "records": [validate_record(r.to_json()) for r in records]}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_payload(path: str) -> dict:
    """Full envelope (host, schema_version, extras) + validated records.

    Accepts both v1 files (no schema_version) and v2, and a bare record
    list — compare tooling reads fixtures from all three shapes.
    """
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, list):
        d = {"schema_version": 1, "host": {}, "records": d}
    if "records" not in d:
        raise SchemaError(f"{path}: payload has no 'records' key")
    d.setdefault("schema_version", 1)
    d["records"] = [validate_record(r) for r in d["records"]]
    return d


def load_records(path: str) -> List[RunRecord]:
    return [RunRecord(**r) for r in load_payload(path)["records"]]
