"""The paper-table views of the port (``python -m repro_torch.bench
tables``), one module per view under the reference's file names
(``benchmarks/``): each has ``run(quick)`` returning
``(name, us_per_call, derived)`` rows. The live rows of every view read
one shared sweep (``common.sweep_records``) on the device the caller
selected.
"""
from repro_torch.bench.views import (fig3_tf_penalty, kernels_bench,
                                     roofline, service_bench, table1_guide,
                                     table2_protocol, table3_workers,
                                     table4_tiers, table5_guide)

#: the reference's views, in its order (``benchmarks/run.py`` TABLES)
VIEWS = {
    "table1": table1_guide, "table2": table2_protocol,
    "table3": table3_workers, "table4": table4_tiers,
    "table5": table5_guide, "fig3": fig3_tf_penalty,
    "kernels": kernels_bench, "roofline": roofline,
    "service": service_bench,
}

__all__ = ["VIEWS"]
