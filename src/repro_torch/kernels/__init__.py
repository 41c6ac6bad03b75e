"""Hand-written Hopper kernels for the iteration statistic.

  * fused_stats — margin, gamma (omega), b and Sigma in one pass over X
    (em_hinge, em_svr; mc_hinge, mc_svr from noise operands or the
    counter seed; C chains).
  * fused_estep — margin, gamma and b in one pass (the K > 1536 route).
  * syrk_tri    — Sigma = X^T diag(w) X over lower-triangle tiles only.
  * weighted_gram — the same Sigma over the dense tile grid (the paper's
    Table 9 statistic, public in ``ops``; no solver calls it).
  * rbf_gram    — RBF Gram blocks (the landmark Gram of a Nystrom fit).
  * nystrom_phi — the Nystrom featurizer, scorer and featurize-and-
    accumulate statistic (phi = k(X, landmarks) @ proj).

Each kernel is CUDA C++ for sm_90a under ``csrc/``, built on first use
(``_build``). Its wrapper launches it for a CUDA tensor and runs the plain
PyTorch version (``ref``) for a CPU tensor. ``ops`` is the dispatch layer
the solver calls; ``epilogues`` and ``rng`` are the plain versions of the
device code the kernel runs per row (``csrc/epilogues.cuh``,
``csrc/rng.cuh``). Nothing CUDA-specific happens at import time.
"""
from . import epilogues, ops, ref, rng  # noqa: F401
