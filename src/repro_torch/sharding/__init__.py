"""Divisibility-aware sharding rules for the production mesh, and the
layout that stands in for GSPMD on the ranks (``layout.py``)."""
from .rules import (AbstractMesh, ShardingCtx, param_spec,  # noqa: F401
                    param_specs)
