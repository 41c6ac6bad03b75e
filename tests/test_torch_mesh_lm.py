"""The dense and MoE LMs on a 2 x 2 ('data', 'model') mesh of four gloo
ranks against the reference's model under ``jit`` on its own 2 x 2 host
mesh, float32, the same parameters: reduced smollm (9 heads in the full
config, which do not divide 'model') and reduced granite-moe at its
config's capacity factor 1.25, where each data shard routes and drops
by its own capacity (the reference's island), so the mesh is not the
one-device MoE spread over ranks.

Reduced smollm runs twice, built with ``seq_parallel_attn`` False (the
reference's default) and True ("+sp"): the port runs its island either
way, and both are held to the reference built the same way.

``hidden_seq``, prefill logits and caches (gathered), 4 decode steps'
logits within 1e-4 of max|ref|; one train step's loss and every gathered
gradient leaf within 1e-4 of max|g|, the parameters after the update
with rtol 1e-3, ``grad_norm`` within 1e-5 relative (the reference's
jitted mesh step, ``tests/torch_mesh_util.py``); each rank's parameter
and AdamW bytes, and what serving holds, at most 0.3 of one device's.
"""
import numpy as np
import pytest

from torch_mesh_util import check_model, model_runs

ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "smollm-135m+sp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return model_runs(ARCHS, tmp_path_factory.mktemp("mesh_lm"))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_on_mesh_matches_reference(runs, arch):
    check_model(*runs, arch)


def test_moe_capacity_is_per_data_shard(runs):
    """At 1.25 the reduced granite drops assignments, and the mesh's
    hidden states are the reference's mesh (per-shard capacity), not
    its one-device model's."""
    import jax
    import jax.numpy as jnp

    from conftest import reduce_cfg
    from repro.configs import get_config
    from repro.models import build_model
    from torch_mesh_util import CHUNKS, model_inputs
    ref, ranks = runs
    a = "granite-moe-1b-a400m"
    cfg = reduce_cfg(get_config(a), dtype="float32")
    one = build_model(cfg, **CHUNKS)
    pre = f"{a}|p|"
    flat = {k[len(pre):]: ref[k] for k in ref if k.startswith(pre)}
    params = {}
    for path, v in flat.items():
        *ps, name = path.split("/")
        node = params
        for p in ps:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(v)
    inp = model_inputs(a, cfg.vocab, cfg.d_model, 0, cfg.family)
    h1 = np.asarray(jax.jit(one.hidden_seq)(
        params, {"tokens": jnp.asarray(inp["tokens"])}))
    gap = np.abs(h1 - ref[f"{a}|hidden"]).max() / np.abs(h1).max()
    assert gap > 1e-2, gap                   # one device drops otherwise
    for r in ranks:
        assert np.abs(r[f"{a}|hidden"] - h1).max() / np.abs(h1).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_at_most_three_tenths(runs, arch):
    """Each rank holds its blocks of the parameters and of m and v:
    at most 0.3 of one device's bytes (3 x 4 bytes a parameter)."""
    ref, ranks = runs
    total = sum(ref[k].size for k in ref if k.startswith(f"{arch}|p|"))
    for r in ranks:
        share = float(r[f"{arch}|bytes"][0]) / (3 * 4 * total)
        assert share <= 0.3, share
        # serving holds the blocks and the cast copy's blocks (float32
        # here: the same storage), nothing whole
        share = float(r[f"{arch}|serve_bytes"][0]) / (4 * total)
        assert share <= 0.3, share
