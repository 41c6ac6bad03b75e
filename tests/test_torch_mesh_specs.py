"""The port's sharding rules and spec builders (``repro_torch.sharding``,
``repro_torch.launch.specs``) against the reference's, exactly, without
ranks: both packages' rules read only the mesh's axis names and sizes
(the reference's on a ``jax.sharding.AbstractMesh``, the port's on its
``AbstractMesh``).

  * ``param_specs`` of all ten configs at full size on (2, 2) and
    (16, 16) ('data', 'model') and (2, 16, 16) ('pod', 'data', 'model');
  * ``batch_specs``, ``cache_specs`` and ``opt_state_specs`` for every
    config x ``SHAPES`` entry on the same meshes;
  * mirrors of tests/test_misc_substrate.py's sharding tests and
    tests/test_launch_specs.py's regressions.

Specs compare entry by entry, a 1-tuple of axes read as its one axis
(``PartitionSpec`` normalizes them so). Both rule sets get the same
shapes: the port's ``param_shapes`` (held against ``jax.eval_shape`` of
the reference's init by the family tests).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh as RAbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.launch import specs as rsp
from repro.sharding import ShardingCtx as RCtx
from repro.sharding import param_specs as r_param_specs
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import specs as sp
from repro_torch.models.model import param_shapes
from repro_torch.sharding import (AbstractMesh, ShardingCtx, param_spec,
                                  param_specs)

ARCHS = list_archs()
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_ten_configs():
    assert len(ARCHS) == 10


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ctxs(mesh_name):
    shape, axes = MESHES[mesh_name]
    return (rsp.make_ctx(RAbstractMesh(shape, axes)),
            sp.make_ctx(AbstractMesh(shape, axes)))


def _nest(flat, leaf):
    out = {}
    for path, v in flat.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(v)
    return out


def _leaves(tree):
    """Leaves in the reference's order: dict keys sorted, tuples in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, sp.Struct) \
            and not (tree and all(isinstance(e, (str, type(None), tuple))
                                  for e in tree) and _is_spec(tree)):
        return [x for e in tree for x in _leaves(e)]
    return [tree]


def _is_spec(t):
    return all(e is None or isinstance(e, str)
               or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
               for e in t)


def _ref_spec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    rctx, ctx = _ctxs(mesh_name)
    shapes = param_shapes(get_config(arch))
    want = r_param_specs(rctx, _nest(
        shapes, lambda s: jax.ShapeDtypeStruct(s, jnp.float32)))
    got = param_specs(ctx, _nest(shapes, lambda s: sp.Struct(s, None)))
    w = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
         for path, leaf in jax.tree_util.tree_flatten_with_path(
             want, is_leaf=lambda x: isinstance(x, P))[0]}
    flat_got = {}

    def walk(prefix, node):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(path, v)
            else:
                flat_got[path] = v
    walk("", got)
    assert sorted(w) == sorted(flat_got)
    for path in w:
        assert _norm(flat_got[path]) == _norm(tuple(w[path])), path
        assert _norm(param_spec(ctx, path, shapes[path])) == \
            _norm(tuple(w[path]))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape_name,
                                                   mesh_name):
    rctx, ctx = _ctxs(mesh_name)
    rcfg, cfg = rget_config(arch), get_config(arch)
    rshape, shape = RSHAPES[shape_name], SHAPES[shape_name]
    for labels in (False, True):
        rs, rsh = rsp.batch_specs(rcfg, rshape, rctx, with_labels=labels)
        ps, psh = sp.batch_specs(cfg, shape, ctx, with_labels=labels)
        assert sorted(rs) == sorted(ps)
        for k in rs:
            assert tuple(rs[k].shape) == ps[k].shape, k
            assert jnp.dtype(rs[k].dtype).name == \
                str(ps[k].dtype).removeprefix("torch."), k
            assert _norm(tuple(rsh[k])) == _norm(psh[k]), k
    rs, rsh = rsp.cache_specs(rcfg, rshape, rctx)
    ps, psh = sp.cache_specs(cfg, shape, ctx)
    r_structs = jax.tree.leaves(rs)
    p_structs = _leaves(ps)
    assert [tuple(x.shape) for x in r_structs] == \
        [x.shape for x in p_structs]
    assert [jnp.dtype(x.dtype).name for x in r_structs] == \
        [str(x.dtype).removeprefix("torch.") for x in p_structs]
    assert [_norm(tuple(x)) for x in _ref_spec_leaves(rsh)] == \
        [_norm(x) for x in _leaves(psh)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_mirror_params(arch, mesh_name):
    rctx, ctx = _ctxs(mesh_name)
    pstructs, pspecs = sp.param_struct_specs(get_config(arch), ctx)
    ostructs, ospecs = sp.opt_state_specs(pstructs, pspecs)
    assert ostructs["m"] is pstructs and ostructs["v"] is pstructs
    assert ospecs["m"] is pspecs and ospecs["v"] is pspecs
    assert ostructs["step"] == sp.Struct((), __import__("torch").int32)
    assert ospecs["step"] == ()
    # the reference's: the same mirror, step replicated
    rps = r_param_specs(rctx, _nest(
        param_shapes(get_config(arch)),
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32)))
    _, rospecs = rsp.opt_state_specs(None, rps)
    assert rospecs["step"] == P()
    assert [_norm(tuple(x)) for x in _ref_spec_leaves(rospecs["m"])] == \
        [_norm(x) for x in _leaves(ospecs["m"])]


# ------------------------------------- mirrors of the reference's tests
@pytest.fixture(scope="module")
def ctx1():
    """A 1 x 1 mesh: everything divides, so the rules' orientation
    shows (the reference's ``ctx1``)."""
    return ShardingCtx(mesh=AbstractMesh((1, 1), ("data", "model")),
                       dp_axes=("data",), tp_axis="model", fsdp_axis="data")


def test_param_spec_divisibility_filter(ctx1):
    assert param_spec(ctx1, "layers/attn/wq", (4, 64, 64)) == \
        (None, "data", "model")
    assert param_spec(ctx1, "layers/attn/wo", (4, 64, 64)) == \
        (None, "model", "data")
    assert param_spec(ctx1, "layers/moe/moe_up", (4, 8, 64, 32)) == \
        (None, "model", "data", None)
    assert param_spec(ctx1, "embed/table", (100, 64)) == ("model", "data")


def test_spec_drops_non_divisible():
    ctx = ShardingCtx(mesh=AbstractMesh((1,), ("data",)), dp_axes=("data",),
                      tp_axis=None, fsdp_axis="data")
    assert ctx.spec((5, 3), "data", None)[0] == "data"
    assert ctx.axis_size("data") == 1
    two = ShardingCtx(mesh=AbstractMesh((2, 2), ("data", "model")))
    assert two.spec((5, 4), "data", "model") == (None, "model")
    # granite-moe's odd vocab keeps the table's rows whole
    assert param_spec(two, "embed/table", (49_155, 2048)) == \
        (None, "model")
    # off the mesh every spec is replicated and a layout point is x
    off = ShardingCtx()
    assert param_spec(off, "layers/attn/wq", (4, 64, 64)) == \
        (None, None, None)
    import torch
    x = torch.ones(2, 3, 4)
    assert off.shard_batch(x) is x and off.constrain(x, "data", None,
                                                      None) is x


def test_cache_spec_never_shards_period_dim(ctx1):
    cfg = get_config("qwen2-vl-72b")
    _, shards = sp.cache_specs(cfg, SHAPES["decode_32k"], ctx1)
    for leaf in _leaves(shards):
        assert leaf[0] is None, f"period dim sharded: {leaf}"


def test_cache_spec_seq_over_model(ctx1):
    cfg = get_config("deepseek-67b")
    _, shards = sp.cache_specs(cfg, SHAPES["decode_32k"], ctx1)
    leaf = _leaves(shards)[0]
    # (periods, B, S, KVH, dh): B over dp, S over tp
    assert _norm(leaf)[1] == "data" and leaf[2] == "model", leaf


def test_batch_specs_cover_modalities(ctx1):
    for arch, key in [("yi-34b", "tokens"), ("qwen2-vl-72b", "embeds"),
                      ("whisper-small", "frames")]:
        specs, _ = sp.batch_specs(get_config(arch), SHAPES["train_4k"], ctx1,
                                  with_labels=True)
        assert key in specs and "labels" in specs
        B = SHAPES["train_4k"].global_batch
        assert specs["labels"].shape == (B, 4096)


def test_serve_param_dtype_override(ctx1):
    import torch
    pstructs, _ = sp.param_struct_specs(get_config("smollm-135m"), ctx1,
                                        dtype="bfloat16")
    assert all(x.dtype == torch.bfloat16 for x in _leaves(pstructs))


def test_make_ctx_axes():
    one = sp.make_ctx(AbstractMesh((2, 2), ("data", "model")))
    multi = sp.make_ctx(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert one.dp_axes == ("data",) and multi.dp_axes == ("pod", "data")
    assert multi.tp_axis == "model" and multi.fsdp_axis == "data"
    assert multi.axis_size(multi.dp_axes) == 32
    ref = rsp.make_ctx(RAbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert ref.dp_axes == multi.dp_axes


def test_param_shapes_layer_dim_is_the_configs():
    """``param_shapes`` draws one period and sets the stacked leaves'
    layer dim: the whole stack's shapes, as a reduced config drawn whole
    shows."""
    from conftest import reduce_cfg
    from repro_torch.core import prng
    from repro_torch.models.model import _flat, _init_tree
    for arch in ("jamba-v0.1-52b", "whisper-small", "xlstm-350m"):
        cfg = dataclasses.replace(reduce_cfg(get_config(arch)),
                                  n_layers=3 * get_config(arch).layer_period)
        whole = _flat(_init_tree(prng.PRNGKey(0, device="meta"), cfg))
        assert param_shapes(cfg) == {k: tuple(v.shape)
                                     for k, v in whole.items()}
