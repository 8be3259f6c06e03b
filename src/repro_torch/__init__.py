"""PyTorch + CUDA port of the ``repro`` serving stack.

The package mirrors ``repro``'s module layout (``configs``, ``models``,
``kernels``, ``serve``, ``launch``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and numpy
only: modules of ``repro`` that it needs are kept as its own copies.

Every entry point takes a ``device`` whose default is ``"cuda"``; without
a card that default raises instead of running on the CPU.  Kernel
wrappers run their plain PyTorch version only for tensors that lie on the
CPU.  See ``README.md`` beside this file.
"""
