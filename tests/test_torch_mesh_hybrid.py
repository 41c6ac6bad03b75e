"""The Mamba hybrid (reduced jamba-v0.1-52b: Mamba and attention blocks,
MoE every other layer) on a 2 x 2 ('data', 'model') mesh of four gloo
ranks against the reference's model under ``jit`` on its own 2 x 2
host mesh, float32, the same parameters (``tests/torch_mesh_util.py``):
Mamba's conv and scan gather their block input over 'model', run on the
whole sequence and keep their own rows; its decode states are held
batch over DP and whole over 'model'.

Forward, prefill (logits and gathered caches and states), 4 decode
steps within 1e-4 of max|ref|; one train step: loss and every gathered
gradient leaf within 1e-4, the update with rtol 1e-3, ``grad_norm``
within 1e-5 relative.
"""
import pytest

from torch_mesh_util import check_model, model_runs

ARCHS = ("jamba-v0.1-52b",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return model_runs(ARCHS, tmp_path_factory.mktemp("mesh_hybrid"))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_on_mesh_matches_reference(runs, arch):
    check_model(*runs, arch)
