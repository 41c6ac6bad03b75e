"""The solver facade: SVMConfig / PEMSVM / FitResult and lam_from_C."""
from .linear import SVMData  # noqa: F401
from .solver import FitResult, PEMSVM, SVMConfig, lam_from_C  # noqa: F401
