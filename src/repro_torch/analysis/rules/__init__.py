"""Rule registry: every invariant the checker enforces, by id."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from repro_torch.analysis.rules.base import Rule
from repro_torch.analysis.rules.device import (TorchCudaInFork,
                                               TorchHostSyncInLoop,
                                               TorchThreadNoDevice)
from repro_torch.analysis.rules.exceptions import ExceptSwallow
from repro_torch.analysis.rules.fork_safety import (ForkInitargsBytes,
                                                    ForkInitializerClosure)
from repro_torch.analysis.rules.locks import LockUnguardedWrite
from repro_torch.analysis.rules.schema_trace import (SchemaRawRecord,
                                                     TraceSpanNoWith)

_ALL: Sequence[Type[Rule]] = (
    ForkInitargsBytes,
    ForkInitializerClosure,
    LockUnguardedWrite,
    TorchThreadNoDevice,
    TorchCudaInFork,
    TorchHostSyncInLoop,
    ExceptSwallow,
    SchemaRawRecord,
    TraceSpanNoWith,
)

RULES: Dict[str, Type[Rule]] = {cls.id: cls for cls in _ALL}
assert len(RULES) == len(_ALL), "duplicate rule id"


def resolve_rules(only: Optional[Sequence[str]] = None
                  ) -> List[Type[Rule]]:
    """Rule classes to run; ``only`` is a selector (str/list/None).

    Unknown rule ids raise ``core.selectors.SelectorError`` — a typo'd
    ``--only`` must fail the run, not silently check nothing.
    """
    from repro_torch.core.selectors import parse_selector
    tokens = parse_selector(only, valid=RULES, what="rule")
    if tokens is None:
        return list(_ALL)
    picked = dict.fromkeys(tokens)         # dedupe, keep registry order
    return [cls for cls in _ALL if cls.id in picked]
