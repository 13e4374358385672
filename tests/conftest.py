import os
import sys

# Tests run on the real single CPU device — the 512-device flag is set ONLY
# inside repro.launch.dryrun (its own subprocess).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA; skips elsewhere")
