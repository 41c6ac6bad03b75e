"""Synthetic generators shaped like the paper's datasets."""
from .synthetic import make_alpha_like, make_blobs, make_circles  # noqa: F401
