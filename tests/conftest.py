import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

try:  # pragma: no cover - prefer the real package when present
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_stub

    _hypothesis_stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel on an NVIDIA GPU; skips where there is "
        "none (on the card: python -m pytest -m cuda tests/test_torch_cuda.py)")
