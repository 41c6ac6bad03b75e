"""The solver facade: SVMConfig / PEMSVM / FitResult and lam_from_C, the
Nystrom kernel SVM (NystromSVM, PhiSpec), and the multiclass and exact-Gram
kernel modules PEMSVM steps through (``multiclass``, ``kernel``), and
MaxMarginHead, the composite max-margin model over a backbone."""
from . import kernel, multiclass  # noqa: F401
from .head import MaxMarginHead, last_token_pool, mean_pool  # noqa: F401
from .linear import PhiSpec, SVMData  # noqa: F401
from .nystrom import (NystromSVM, nystrom_features,  # noqa: F401
                      nystrom_projection)
from .solver import FitResult, PEMSVM, SVMConfig, lam_from_C  # noqa: F401
