"""PyTorch + CUDA port of the PEMSVM package ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package is held against
it by the ``tests/test_torch_*.py`` suite and imports neither JAX nor
anything under ``repro``. Importing it needs only CPU PyTorch: the CUDA
kernels are compiled with ``nvcc`` on first use (``kernels/_build.py``).

Ported so far: LIN-EM-CLS and LIN-MC-CLS (the Gibbs sampler, with the
'host', 'fused_predraw' and 'fused' noise sources and ``n_chains``) on one
device with the ``scan`` and ``loop`` drivers, the slice of ``jax.random``
they need (``core/prng.py``), and three kernels: ``fused_stats`` (em_hinge
and mc_hinge, noise operands or the in-kernel counter RNG, multichain),
``fused_estep`` and ``syrk_tri``. ROADMAP.md lists what is still to come.
"""
