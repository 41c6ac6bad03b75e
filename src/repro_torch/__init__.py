"""PyTorch + CUDA port of the PEMSVM package ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package is held against
it by the ``tests/test_torch_*.py`` suite and imports neither JAX nor
anything under ``repro``. Importing it needs only CPU PyTorch: the CUDA
kernels are compiled with ``nvcc`` on first use (``kernels/_build.py``).

Ported so far: LIN-EM-CLS and LIN-MC-CLS (the Gibbs sampler, with the
'host', 'fused_predraw' and 'fused' noise sources and ``n_chains``) on one
device with the ``scan`` and ``loop`` drivers, the slice of ``jax.random``
they need (``core/prng.py``), the Nystrom kernel SVM KRN-{EM,MC}-CLS
(``NystromSVM``), and seven kernels: ``fused_stats`` (em_hinge and
mc_hinge, noise operands or the in-kernel counter RNG, multichain),
``fused_estep``, ``syrk_tri``, ``rbf_gram``, ``nystrom_phi``,
``nystrom_score`` and ``nystrom_fused_stats``. ROADMAP.md lists what is
still to come.
"""
from .core import NystromSVM, PEMSVM, SVMConfig, lam_from_C  # noqa: F401
