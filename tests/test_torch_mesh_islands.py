"""The mesh islands of the port's LM (``models/attention.py``,
``models/mlp.py``) on four gloo ranks (2 x 2 ('data', 'model')) against
the reference's ``shard_map`` islands on four emulated JAX devices, both
fed the same numpy inputs, float32:

  * ``seq_parallel_attention`` at H = 3 (the heads do not divide
    'model', the reference's reason for the island), causal and not, the
    batch dividing DP and not: within 2e-4 of max|ref| (the reference's
    own island tests' band);
  * ``decode_attn_island`` at a ``pos`` inside a shard and at both sides
    of a shard's edge, the batch dividing (sequence over 'model') and not
    (over (data, model): the 2-D context-parallel form): outputs within
    2e-4, every rank's cache shard bitwise the reference's block;
  * the MoE island on reduced granite-moe (E = 8, top-2) at the config's
    factor 1.25, where each data shard drops by its own capacity, and at
    E / k, which drops nothing: within 1e-5 of max|ref|, and each rank's
    kept assignments (route and keep, per data shard and model rank)
    equal as integers to the reference's.
"""
import numpy as np
import pytest

from torch_mesh_util import finish, rel, run_ranks, start_reference

SP_CASES = [(4, 1, True), (4, 1, False), (3, 1, True), (4, 3, False)]
DEC_CASES = [(4, 5), (4, 15), (4, 16), (3, 7), (3, 8), (3, 13)]
FACTORS = (1.25, 4.0)
S, H, DH = 32, 3, 8

_REF = """
import functools
from repro.configs import get_config
from repro.models import attention as A, mlp as M
from conftest import reduce_cfg
inp = dict(np.load(sys.argv[1]))
for i, (B, KVH, causal) in enumerate({sp}):
    q, k, v = (jnp.asarray(inp[f"sp{{i}}_{{n}}"]) for n in "qkv")
    out[f"sp{{i}}"] = np.asarray(jax.jit(functools.partial(
        A.seq_parallel_attention, ctx, causal=causal, q_chunk=8,
        kv_chunk=8))(q, k, v))
for i, (B, pos) in enumerate({dec}):
    a = {{n: jnp.asarray(inp[f"dec{{i}}_{{n}}"])
         for n in ("q", "kc", "vc", "kn", "vn")}}
    o, kc, vc = jax.jit(functools.partial(A.decode_attn_island, ctx))(
        a["q"], a["kc"], a["vc"], jnp.int32(pos), a["kn"], a["vn"])
    out[f"dec{{i}}"], out[f"dec{{i}}_kc"], out[f"dec{{i}}_vc"] = (
        np.asarray(o), np.asarray(kc), np.asarray(vc))
cfg = reduce_cfg(get_config("granite-moe-1b-a400m"), n_experts=8,
                 dtype="float32")
p = M.init_moe(jax.random.PRNGKey(3), cfg)
for k_, v_ in p.items():
    out[f"moe_p_{{k_}}"] = np.asarray(v_)
x = jnp.asarray(np.random.default_rng(5).normal(size=(4, 16, cfg.d_model)),
                jnp.float32)
out["moe_x"] = np.asarray(x)
E, K = cfg.n_experts, cfg.top_k
for f in {factors}:
    out[f"moe{{f}}"] = np.asarray(jax.jit(functools.partial(
        M.moe_apply, cfg, ctx, capacity_factor=f))(p, x))
    for d in range(2):             # the island's routes and keeps, by hand
        xt = x[2 * d:2 * d + 2].reshape(-1, cfg.d_model)
        T = xt.shape[0]
        C = max(1, int(T * K * f) // E)
        _, eidx = M._route(xt, p["router"], K)
        for m in range(2):
            e_rel = eidx.reshape(-1) - m * (E // 2)
            ins = (e_rel >= 0) & (e_rel < E // 2)
            oh = jax.nn.one_hot(jnp.where(ins, e_rel, E // 2), E // 2 + 1,
                                dtype=jnp.int32)[:, :E // 2]
            pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
            out[f"keep{{f}}_{{d}}{{m}}"] = np.asarray(ins & (pos < C))
            out[f"eidx{{f}}_{{d}}"] = np.asarray(eidx)
np.savez(sys.argv[2], **out)
""".format(sp=SP_CASES, dec=DEC_CASES, factors=FACTORS)

_PORT = """
import torch
from repro_torch.configs import get_config
from repro_torch.models import attention as A, mlp as M
from repro_torch.sharding.layout import Layout
from conftest import reduce_cfg
lay = Layout(ctx, {{}})
inp = dict(np.load(f"{{out}}/inputs.npz"))
ref = dict(np.load(f"{{out}}/ref.npz"))
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
for i, (B, KVH, causal) in enumerate({sp}):
    rows = lay.rows(B, {S}, gather_params=False)
    q, k, v = (rows.own_rows(T(inp[f"sp{{i}}_{{n}}"])) for n in "qkv")
    o = A.seq_parallel_attention(rows, q, k, v, causal=causal, q_chunk=8,
                                 kv_chunk=8)
    res[f"sp{{i}}"] = rows.gather_rows(o).numpy()
for i, (B, pos) in enumerate({dec}):
    rows = lay.rows(B, 1, gather_params=False)
    axes = A.cache_seq_axes(rows, {S})
    n = {S} // lay.size(axes)
    a = {{k: rows.own_batch(T(inp[f"dec{{i}}_{{k}}"]))
         for k in ("q", "kc", "vc", "kn", "vn")}}
    kc, vc = (a[k].narrow(1, lay.index(axes) * n, n).clone()
              for k in ("kc", "vc"))
    o = A.decode_attn_island(rows, axes, a["q"], kc, vc, pos, a["kn"],
                             a["vn"])
    res[f"dec{{i}}"] = rows.gather_batch(o).numpy()
    res[f"dec{{i}}_kc"], res[f"dec{{i}}_vc"] = kc.numpy(), vc.numpy()
    res[f"dec{{i}}_at"] = np.array([rows.b0, rows.B_l,
                                   lay.index(axes) * n, n])
cfg = reduce_cfg(get_config("granite-moe-1b-a400m"), n_experts=8,
                 dtype="float32")
p = {{k[6:]: T(v) for k, v in ref.items() if k.startswith("moe_p_")}}
rows = lay.rows(4, 16, gather_params=False)
x = rows.own_rows(T(ref["moe_x"]))
E, K = cfg.n_experts, cfg.top_k
E_loc = E // 2
for f in {factors}:
    y = M.moe_apply(cfg, p, x, capacity_factor=f, rows=rows)
    res[f"moe{{f}}"] = rows.gather_rows(y).numpy()
    xt = rows.gather_seq(x).reshape(-1, cfg.d_model)
    _, eidx = M._route(xt, p["router"], K)
    keep, _, _ = M._slots(eidx, lay.index(("model",)) * E_loc, E_loc,
                          M.capacity(cfg, xt.shape[0], f))
    res[f"keep{{f}}"], res[f"eidx{{f}}"] = keep.numpy(), eidx.numpy()
res["coords"] = np.array([lay.index(("data",)), lay.index(("model",))])
""".format(sp=SP_CASES, dec=DEC_CASES, factors=FACTORS, S=S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("islands")
    rng = np.random.default_rng(0)
    inp = {}
    for i, (B, KVH, _) in enumerate(SP_CASES):
        inp[f"sp{i}_q"] = rng.normal(size=(B, S, H, DH))
        inp[f"sp{i}_k"] = rng.normal(size=(B, S, KVH, DH))
        inp[f"sp{i}_v"] = rng.normal(size=(B, S, KVH, DH))
    for i, (B, _) in enumerate(DEC_CASES):
        inp[f"dec{i}_q"] = rng.normal(size=(B, 1, 4, DH))
        inp[f"dec{i}_kc"] = rng.normal(size=(B, S, 2, DH))
        inp[f"dec{i}_vc"] = rng.normal(size=(B, S, 2, DH))
        inp[f"dec{i}_kn"] = rng.normal(size=(B, 1, 2, DH))
        inp[f"dec{i}_vn"] = rng.normal(size=(B, 1, 2, DH))
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(out / "inputs.npz", **inp)
    finish(start_reference(_REF, [out / "inputs.npz", out / "ref.npz"]))
    return dict(np.load(out / "ref.npz")), run_ranks(_PORT, out)


@pytest.mark.parametrize("i", range(len(SP_CASES)))
def test_seq_parallel_attention(runs, i):
    ref, ranks = runs
    for r in ranks:
        assert rel(r[f"sp{i}"], ref[f"sp{i}"]) < 2e-4


@pytest.mark.parametrize("i", range(len(DEC_CASES)))
def test_decode_attn_island(runs, i):
    ref, ranks = runs
    for r in ranks:
        assert rel(r[f"dec{i}"], ref[f"dec{i}"]) < 2e-4
        b0, bl, s0, n = r[f"dec{i}_at"]
        for c in ("kc", "vc"):
            np.testing.assert_array_equal(
                r[f"dec{i}_{c}"], ref[f"dec{i}_{c}"][b0:b0 + bl, s0:s0 + n])


@pytest.mark.parametrize("f", FACTORS)
def test_moe_island(runs, f):
    ref, ranks = runs
    for r in ranks:
        assert rel(r[f"moe{f}"], ref[f"moe{f}"]) < 1e-5
        d, m = r["coords"]
        np.testing.assert_array_equal(r[f"eidx{f}"],
                                      ref[f"eidx{f}_{d}"].reshape(-1, 2))
        np.testing.assert_array_equal(r[f"keep{f}"].astype(np.int32),
                                      ref[f"keep{f}_{d}{m}"].astype(np.int32))
    # per-shard capacity shows: at 1.25 some assignment is dropped
    if f == 1.25:
        assert not all(ref[f"keep{f}_{d}{m}"][
            (ref[f"eidx{f}_{d}"].reshape(-1) // 4) == m].all()
            for d in range(2) for m in range(2))
