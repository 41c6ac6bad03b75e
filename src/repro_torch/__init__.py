"""PyTorch + CUDA port of the PEMSVM package ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package is held against
it by the ``tests/test_torch_*.py`` suite and imports neither JAX nor
anything under ``repro``. Importing it needs only CPU PyTorch: the CUDA
kernels are compiled with ``nvcc`` on first use (``kernels/_build.py``).

Ported so far: LIN-EM-CLS on one device with the ``scan`` and ``loop``
drivers, and its three kernels (``fused_stats``, ``fused_estep``,
``syrk_tri``). ROADMAP.md lists what is still to come.
"""
