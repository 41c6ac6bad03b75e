"""Serving: the SVM scoring path (``svm_serve.py``). The LM prefill and
decode steps are ROADMAP queue 1 item 13."""
from .svm_serve import (DEFAULT_TILE, DeadlineExceeded,  # noqa: F401
                        ServableModel, ServeLoop, ServeRejected,
                        SVMScorer, WeightPager, phi_never_materialized)
