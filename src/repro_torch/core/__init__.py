# The paper's primary contribution: the loader-aware evaluation protocol
# for ML input-pipeline components — protocols (single-thread vs
# DataLoader vs worker sweep), statistical policy, robustness/skip
# accounting, and the operational decision tiers, plus the recorded
# paper matrix the analysis is validated against.
from repro_torch.core import (decision, paper_data, protocols,  # noqa: F401
                              report, schema, selectors, stats)
