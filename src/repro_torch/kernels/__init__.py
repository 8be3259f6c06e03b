"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version beside it and a public wrapper in ``ops.py``.  Kernels
are built at first use (``build.py``), never at import."""
