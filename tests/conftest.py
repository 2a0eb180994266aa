import os
import sys

# NOTE: no XLA device-count flags here — smoke tests and benches must see
# the real single CPU device. Dry-run tests spawn subprocesses that set
# their own flags (jax locks device count at first init).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest

from repro.jpeg.corpus import Corpus, build_corpus

# The 8-device-mesh subprocess tests compile reduced-but-real models under
# XLA_FLAGS device-count forcing — multi-minute XLA compiles that dwarf the
# rest of the suite on small CI hosts. They stay collected but only run
# when explicitly requested.
requires_slow = pytest.mark.skipif(
    os.environ.get("REPRO_RUN_SLOW") != "1",
    reason="multi-minute 8-device compile test; set REPRO_RUN_SLOW=1")


@pytest.fixture(scope="session")
def corpus() -> Corpus:
    return build_corpus(12, seed=7)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips without one "
        "(run on the card: python -m pytest -m gpu tests/test_torch_gpu.py)")
