"""MLA (reduced deepseek-v2) and xLSTM (reduced xlstm-350m) on a 2 x 2 ('data', 'model') mesh of four gloo
ranks against the reference's models under ``jit`` on its own 2 x 2
host mesh, float32, the same parameters (``tests/torch_mesh_util.py``):
mLSTM and sLSTM gather their block input over 'model' (they need the
whole sequence); MLA's latent cache is held batch over DP and
sequence over 'model', its decode combined over 'model'; the recurrent
states batch over DP and whole over 'model'.

Forward, prefill (logits and gathered caches), 4 decode steps within
1e-4 of max|ref|; one train step: loss and every gathered gradient leaf
within 1e-4, the update with rtol 1e-3, ``grad_norm`` within 1e-5
relative. The Mamba hybrid is tests/test_torch_mesh_hybrid.py.
"""
import pytest

from torch_mesh_util import check_model, model_runs

ARCHS = ("deepseek-v2-236b", "xlstm-350m")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return model_runs(ARCHS, tmp_path_factory.mktemp("mesh_families"))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_on_mesh_matches_reference(runs, arch):
    check_model(*runs, arch)
