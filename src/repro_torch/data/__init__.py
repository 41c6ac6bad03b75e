"""Synthetic generators shaped like the paper's datasets."""
from .synthetic import (make_alpha_like, make_blobs,  # noqa: F401
                        make_circles, make_year_like)
