"""Paper Table 1: the protocol-selection guide, encoded + self-checked."""
from __future__ import annotations

from repro_torch.core import decision


def run(quick: bool = True):
    g = decision.PROTOCOL_GUIDE
    ok = (decision.required_protocol("feed_dataloader")
          == "dataloader throughput"
          and decision.required_protocol("worker_count")
          == "worker sweep per CPU"
          and decision.required_protocol("safe_default")
          == "skip/failure accounting"
          and "single_thread" in decision.required_protocol(
              "fastest_component"))
    return [("table1.protocol_guide", 0.0,
             f"questions={len(g)} encoding_ok={ok}")]
