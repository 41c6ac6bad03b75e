"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``), each in a subprocess of its own with a timeout and one
thread, and print what their reference counterparts print.

Bands: the quickstart converges and scores >= 0.95 on its held-out rows
(as the reference's quickstart is expected to); the kernel variants and
the Nystrom example separate the circles (>= 0.9, where a linear rule
scores ~0.5); the max-margin head over the reduced backbone converges and
scores >= 0.8 held out.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name: str, timeout: int = 240) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _num(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return float(m.group(1))


def test_quickstart():
    out = _run("torch_quickstart.py")
    assert "device        : cpu" in out
    assert "converged     : True" in out
    assert _num(r"test accuracy : ([\d.]+)", out) >= 0.95
    assert _num(r"MC accuracy   : ([\d.]+)", out) >= 0.95


def test_svm_variants():
    out = _run("torch_svm_variants.py")
    for opt in ("LIN-EM-CLS", "LIN-MC-CLS", "LIN-EM-SVR", "LIN-MC-MLT"):
        assert opt in out, out
    assert _num(r"KRN-EM-CLS  acc=([\d.]+)", out) >= 0.9
    assert _num(r"KRN-MC-CLS  acc=([\d.]+)", out) >= 0.9
    assert _num(r"LIN-EM-SVR  rmse=([\d.]+)", out) < 1.0


def test_nystrom_kernel_svm():
    out = _run("torch_nystrom_kernel_svm.py")
    assert _num(r"acc=([\d.]+)", out) >= 0.9


def test_lm_feature_svm():
    out = _run("torch_lm_feature_svm.py")
    assert "converged=True" in out
    assert _num(r"test acc=([\d.]+)", out) >= 0.8


@pytest.mark.parametrize("name", ["torch_train_lm.py", "torch_serve_lm.py"])
def test_lm_wrappers_call_the_port(name):
    text = (ROOT / "examples" / name).read_text()
    launcher = "train" if "train" in name else "serve"
    assert f'"repro_torch.launch.{launcher}"' in text
