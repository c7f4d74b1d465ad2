import os
import sys

# Allow `pytest tests/` without PYTHONPATH=src (the canonical invocation still
# sets it).  NOTE: never set XLA_FLAGS device-count overrides here -- smoke
# tests and benchmarks must see the single real CPU device; only
# launch/dryrun.py (run as its own process) forces 512 placeholder devices.
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if os.path.abspath(_SRC) not in [os.path.abspath(p) for p in sys.path]:
    sys.path.insert(0, os.path.abspath(_SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
        "without one")
