"""Training and the head on a 2 x 2 ('data', 'model') mesh of four gloo
ranks, on the CPU:

  * ``ShardedBatcher(mesh=)``: each rank's rows bitwise the reference's
    addressable shards on its 2 x 2 host mesh (the shard on the device
    at the rank's coordinates), through a ``seek`` mid-iteration;
  * ``launch.train.train(mesh=)``, 3 steps of reduced smollm in float32:
    the losses within 1e-5 (relative) of the one-device trainer's; a run
    killed after step 2 and resumed is bitwise the uninterrupted mesh
    run; the one-device ``Checkpointer`` restores the mesh's snapshot
    (the one-device layout, written by rank 0 alone) bitwise and the
    one-device trainer continues from it; the CLI's ``--mesh production``
    on four ranks refuses with the ranks it needs;
  * ``MaxMarginHead`` on the mesh, its features from the mesh model
    (tests/test_torch_head.py's task and backbone) and ``PEMSVM`` over
    the mesh's data axis: features within 1e-4 of max|ref| of the
    one-device head's, weights after two iterations within 1e-3 of
    max|w|, at convergence iterations within 3 and accuracy within 0.01
    (that file's bands).
"""
import dataclasses

import numpy as np
import pytest

from conftest import reduce_cfg
from torch_mesh_util import finish, rel, run_ranks, start_reference

SEQ, BATCH, STEPS = 32, 4, 3

_REF = """
from repro.data import ShardedBatcher
stream = np.load(sys.argv[1])
b = ShardedBatcher(stream, 4, 16, mesh=mesh, batch_axes=("data",), seed=7)
it = iter(b)
got = [next(it) for _ in range(3)]
b.seek(20)
got.append(next(it))
pos = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
for i, (t, l) in enumerate(got):
    for name, arr in (("t", t), ("l", l)):
        for sh in arr.addressable_shards:
            d, m = pos[sh.device.id]
            out[f"b{i}{name}_{d}{m}"] = np.asarray(sh.data)
np.savez(sys.argv[2], **out)
"""

_PORT = """
import dataclasses
from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.configs import get_config
from repro_torch.core import MaxMarginHead, SVMConfig, mean_pool
from repro_torch.data import ShardedBatcher
from repro_torch.launch import train as T
from repro_torch.models import build_model
from conftest import reduce_cfg
coords = (mesh.get_coordinate()[0], mesh.get_coordinate()[1])
res["coords"] = np.array(coords)
stream = np.load(f"{out}/stream.npy")
b = ShardedBatcher(stream, 4, 16, mesh=mesh, batch_axes=("data",), seed=7,
                   device="cpu")
it = iter(b)
got = [next(it) for _ in range(3)]
b.seek(20)
got.append(next(it))
for i, (t, l) in enumerate(got):
    res[f"b{i}t"], res[f"b{i}l"] = t.numpy(), l.numpy()

cfg = reduce_cfg(get_config("smollm-135m"), dtype="float32")
kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, device="cpu", mesh=mesh,
          log=lambda *a: None)

def flat(run):
    m, st = run["model"], run["state"]
    full = {"params": m.full(st["params"]),
            "opt": {"m": m.full(st["opt"]["m"]), "v": m.full(st["opt"]["v"]),
                    "step": st["opt"]["step"]}}
    names, leaves, _ = _tree_flatten_with_names(full)
    return dict(zip(names, [x.numpy() for x in leaves]))

run = T.train(cfg, ckpt_dir=f"{out}/full", **kw)
res["losses"] = np.array(run["losses"])
for k, v in flat(run).items():
    res["full|" + k] = v
host = T._host_state(run["model"], run["state"])   # what a snapshot holds
res["host_none"] = np.array(host is None)
if host is not None:
    for n, x in zip(*_tree_flatten_with_names(host)[:2]):
        res["host|" + n] = x.numpy()
        res["host_dev|" + n] = np.array(str(x.device))

# the mesh's init: each rank's blocks of the one-device draw, bitwise
for a in ("smollm-135m", "granite-moe-1b-a400m", "jamba-v0.1-52b",
          "whisper-small"):
    c = reduce_cfg(get_config(a), dtype="float32")
    mine = build_model(c, ctx, device="cpu").init(3)
    want = build_model(c, ctx, device="cpu")
    want = want.shard(build_model(c, device="cpu").init(3))
    got = dict(zip(*_tree_flatten_with_names(mine)[:2]))
    res["init|" + a] = np.array(sorted(got) == sorted(
        _tree_flatten_with_names(want)[0]) and all(
        torch.equal(got[n], x) for n, x in zip(
            *_tree_flatten_with_names(want)[:2])))
T.train(cfg, ckpt_dir=f"{out}/kill", ckpt_every=2, stop_at=2, **kw)
again = T.train(cfg, ckpt_dir=f"{out}/kill", **kw)
res["resumed_from"] = np.array(again["start_step"])
res["resumed_losses"] = np.array(again["losses"])
for k, v in flat(again).items():
    res["kill|" + k] = v
try:
    T.main(["--mesh", "production", "--device", "cpu"])
    res["production"] = np.array("no error")
except ValueError as e:
    res["production"] = np.array(str(e))

hcfg = reduce_cfg(get_config("smollm-135m"), n_layers=2, vocab=64,
                  dtype="float32")
model = build_model(hcfg, ctx, device="cpu", q_chunk=16, kv_chunk=16)
model.init(0)
fn = lambda t: mean_pool(model.hidden_seq({"tokens": t}).float())
task = np.load(f"{out}/task.npz")
toks, y = task["toks"], task["y"]
for name, skw in (("two", dict(max_iters=2, min_iters=2)),
                  ("full", dict(max_iters=40))):
    head = MaxMarginHead(SVMConfig(lam=0.1, **skw), fn, mesh=mesh,
                         data_axes=("data",), device="cpu",
                         feature_batch=96)
    r = head.fit(toks, y)
    res[name + "_w"], res[name + "_it"] = r.weights, np.array(r.n_iters)
    res[name + "_acc"] = np.array(head.score(toks, y))
res["feats"] = head.extract(toks)
""".replace("STEPS", str(STEPS)).replace("BATCH", str(BATCH)).replace(
    "SEQ", str(SEQ))


def _task():
    rng = np.random.default_rng(0)
    N, S = 400, 16
    toks = np.where(rng.random((N, 1)) > 0.5,
                    rng.integers(0, 24, (N, S)),
                    rng.integers(40, 64, (N, S))).astype(np.int32)
    return toks, np.where(toks.mean(1) < 32, 1.0, -1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    stream = np.random.default_rng(1).integers(0, 500, 4000).astype(np.int32)
    np.save(out / "stream.npy", stream)
    toks, y = _task()
    np.savez(out / "task.npz", toks=toks, y=y)
    ref = start_reference(_REF, [out / "stream.npy", out / "ref.npz"])
    ranks = run_ranks(_PORT, out, timeout=400)
    finish(ref)
    return out, dict(np.load(out / "ref.npz")), ranks


def test_batcher_rows_are_the_references_shards(runs):
    _, ref, ranks = runs
    for r in ranks:
        d, m = r["coords"]
        for i in range(4):
            for n in "tl":
                np.testing.assert_array_equal(r[f"b{i}{n}"],
                                              ref[f"b{i}{n}_{d}{m}"])


def _cfg():
    from repro_torch.configs import get_config
    return reduce_cfg(get_config("smollm-135m"), dtype="float32")


def test_mesh_trainer_losses_match_one_device(runs):
    from repro_torch.launch import train as T
    _, _, ranks = runs
    one = T.train(_cfg(), steps=STEPS, batch=BATCH, seq=SEQ, device="cpu",
                  log=lambda *a: None)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])


def test_mesh_kill_and_resume_is_bitwise(runs):
    _, _, ranks = runs
    for r in ranks:
        assert int(r["resumed_from"]) == 2
        np.testing.assert_array_equal(r["resumed_losses"], r["losses"][2:])
        keys = [k for k in r if k.startswith("full|")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(r["kill|" + k[5:]], r[k], err_msg=k)


def test_one_device_restores_the_mesh_snapshot(runs):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
    from repro_torch.launch import train as T
    out, _, ranks = runs
    ck = Checkpointer(str(out / "full"))
    assert ck.latest_step() == STEPS
    state = ck.restore(T._state_like(_cfg()), device="cpu")
    names, leaves, _ = _tree_flatten_with_names(state)
    for n, x in zip(names, leaves):
        np.testing.assert_array_equal(x.numpy(), ranks[0]["full|" + n],
                                      err_msg=n)
    logs = []
    more = T.train(_cfg(), steps=STEPS + 1, batch=BATCH, seq=SEQ,
                   device="cpu", ckpt_dir=str(out / "full"), log=logs.append)
    assert f"restored checkpoint at step {STEPS}" in logs
    assert len(more["losses"]) == 1 and np.isfinite(more["losses"][0])


def test_snapshot_is_gathered_to_rank_zero_alone(runs):
    """A snapshot's tree is the whole state on rank 0's host, gathered
    leaf by leaf; the other ranks hold none of it."""
    _, _, ranks = runs
    assert not bool(ranks[0]["host_none"])
    keys = [k for k in ranks[0] if k.startswith("full|")]
    for k in keys:
        np.testing.assert_array_equal(ranks[0]["host|" + k[5:]],
                                      ranks[0][k], err_msg=k)
        assert str(ranks[0]["host_dev|" + k[5:]]) == "cpu"
    for r in ranks[1:]:
        assert bool(r["host_none"])
        assert not [k for k in r if k.startswith("host|")]


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_mesh_init_keeps_the_one_device_blocks(runs, arch):
    """``Model.init`` on the mesh (each layer drawn, its blocks kept,
    the layer freed) holds the blocks of the one-device draw, bitwise."""
    _, _, ranks = runs
    for r in ranks:
        assert bool(r["init|" + arch])


def test_production_mesh_refuses_on_four_ranks(runs):
    _, _, ranks = runs
    for r in ranks:
        msg = str(r["production"])
        assert "256 ranks" in msg and "has 4" in msg, msg


def test_head_on_the_mesh_model(runs):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import MaxMarginHead, SVMConfig, mean_pool
    from repro_torch.models import build_model
    _, _, ranks = runs
    toks, y = _task()
    cfg = reduce_cfg(get_config("smollm-135m"), n_layers=2, vocab=64,
                     dtype="float32")
    model = build_model(cfg, device="cpu", q_chunk=16, kv_chunk=16)
    model.init(0)
    torch.set_num_threads(1)

    def fn(t):
        return mean_pool(model.hidden_seq({"tokens": t}).float())

    two = MaxMarginHead(SVMConfig(lam=0.1, max_iters=2, min_iters=2), fn,
                        device="cpu")
    feats = two.extract(toks)
    one = two.fit(toks, y)
    head = MaxMarginHead(SVMConfig(lam=0.1, max_iters=40), fn, device="cpu")
    full = head.fit(toks, y)
    for r in ranks:
        assert rel(r["feats"], feats) <= 1e-4
        assert rel(r["two_w"], one.weights) <= 1e-3
        np.testing.assert_array_equal(r["two_w"], ranks[0]["two_w"])
        assert abs(int(r["full_it"]) - full.n_iters) <= 3
        assert abs(float(r["full_acc"]) - head.score(toks, y)) <= 0.01


def test_config_is_the_heads():
    """The head's backbone is tests/test_torch_head.py's."""
    from repro_torch.configs import get_config
    cfg = reduce_cfg(get_config("smollm-135m"), n_layers=2, vocab=64,
                     dtype="float32")
    assert cfg == dataclasses.replace(
        get_config("smollm-135m"), n_layers=2, d_model=64, vocab=64,
        d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16, dtype="float32")
