"""Baselines the paper compares against (Tables 4, 5 and 8), in PyTorch:
port of ``repro/baselines``.

  * Pegasos — primal estimated sub-gradient solver (Shalev-Shwartz 2007),
    its mini-batches drawn by ``core.prng.randint`` as the reference's
    ``jax.random.randint`` draws them.
  * DCD     — dual coordinate descent, the LibLinear "LL-Dual" algorithm
    (Hsieh et al. 2008) for the L1-loss linear SVM; its whole sweep is one
    CUDA launch (``kernels/dcd.py``).

Both run on ``cuda:0`` unless given ``device``.
"""
from .dcd import DCDSVM  # noqa: F401
from .pegasos import PegasosSVM  # noqa: F401
