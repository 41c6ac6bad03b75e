"""Serving substrate: LM prefill/decode steps and samplers
(``serve_step.py``, ``sampler.py``) and the SVM scoring path
(``svm_serve.py``)."""
from .serve_step import generate, make_decode_step, make_prefill_step  # noqa: F401
from .svm_serve import (DEFAULT_TILE, DeadlineExceeded,  # noqa: F401
                        ServableModel, ServeLoop, ServeRejected,
                        SVMScorer, WeightPager, phi_never_materialized)
