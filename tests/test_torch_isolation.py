"""The port stands alone: importing every module of ``repro_torch`` pulls
in no JAX and nothing of the JAX package, and no port source (nor the
chip scripts at the root, nor the port's examples ``examples/torch_*.py``)
names them in an import."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 15, out
    assert out[1].strip() == "[]", out[1]


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)[.\s])",
    re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *(ROOT / "examples").glob("torch_*.py"),
     ROOT / "chip_smoke.py",
     ROOT / "chip_nystrom_numerics.py", ROOT / "chip_head_numerics.py",
     ROOT / "chip_krn_numerics.py", ROOT / "chip_decode_sync.py"]))
def test_source_names_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.search(text), _IMPORT.search(text).group(0)


_ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
"""


@pytest.mark.parametrize("module", ["repro_torch.core.stats",
                                    "repro_torch.core.distributed",
                                    "repro_torch.data.pipeline"])
def test_mesh_modules_import_alone(module):
    """The modules of the multi-device fit (the reduction, the mesh axes,
    the port's own pad_features_to) import on their own and pull in no JAX
    and nothing of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _ALONE, module], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]", out
