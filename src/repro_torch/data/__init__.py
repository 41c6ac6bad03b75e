"""Synthetic generators shaped like the paper's datasets, and the feature
padding of the 2-D fit."""
from .pipeline import pad_features_to  # noqa: F401
from .synthetic import (make_alpha_like, make_blobs,  # noqa: F401
                        make_circles, make_mnist8m_like, make_year_like)
