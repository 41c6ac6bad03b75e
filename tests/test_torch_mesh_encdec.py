"""The encoder-decoder (reduced whisper-small) and the VLM (reduced
qwen2-vl-72b, M-RoPE's three position streams) on a 2 x 2 ('data',
'model') mesh of four gloo ranks against the reference's models under
``jit`` on its own 2 x 2 host mesh, float32, the same parameters
(``tests/torch_mesh_util.py``): whisper's encoder and decoder
self-attentions as the sequence-parallel island, the encoder output
gathered over 'model' for the cross-attention, the self caches held as
GQA's and the cross caches batch over DP.

Forward, prefill (logits and gathered caches), 4 decode steps within
1e-4 of max|ref|; one train step: loss and every gathered gradient leaf
within 1e-4 of max|g| (whisper's key bias has an exactly zero gradient,
held within 1e-4 of the tree's largest), the update with rtol 1e-3,
``grad_norm`` within 1e-5 relative.
"""
import pytest

from torch_mesh_util import check_model, model_runs

ARCHS = ("whisper-small", "qwen2-vl-72b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return model_runs(ARCHS, tmp_path_factory.mktemp("mesh_encdec"))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_on_mesh_matches_reference(runs, arch):
    check_model(*runs, arch)
