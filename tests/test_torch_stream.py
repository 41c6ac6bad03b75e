"""The port's stream driver (``driver="stream"``, ``fit_chunks``,
``fit_libsvm``) and its data path against the JAX package, on the CPU.

Exact: ``make_dna_like`` (Table 5's shape); ``FaultPolicy``'s fields and
defaults; ``retrying_chunks``' sleep schedule, yielded chunks and
``RetryStats`` for the same seed, jitter and failure sequence (an injected
``sleep``); ``ChunkPrefetcher``'s contract (errors forwarded, an early stop
that does not hang, ``depth < 1`` refused with the reference's message,
``max_resident_bytes = nbytes * (depth + 2)``); the chunk placer's
assembly (bias column, padded tail) against the host assembly of the
reference's ``fit``; the resident set-up built on the device against the
host-built padded, biased matrix, also for a mesh rank's slice.

Chunk bodies (CLS, SVR, MLT and its objective; EM, MC 'host', 'fused' and
'fused_predraw', multichain, phi-space) against the reference's, evaluated
eagerly (the port is held to the reference's eager form, ROADMAP section
3), on one padded chunk with its row offset: S and b within 1e-5 max|ref|
(the inherited padding tolerance), loss and sums within rtol 1e-5. For
the counter modes the reference is given the port's normal floats, which
agree only to a few ulp (as in tests/test_torch_mlt.py).

Whole fits on the reference's problem (tests/test_streaming.py): the
port's stream fit against the port's scan fit at the reference test's
bounds, and against the reference's stream fit with the bands the port's
whole-fit tests use (EM: objective trace 2e-2, EM-SVR 5e-2; weights 5e-2;
score 0.01; MC: weights 0.15, score 0.02). LIN-MC-CLS is held on its first
iteration there (the reference fails its own stream-vs-scan test of that
option under the installed jax, ROADMAP section 3).

The MC chains are held at the reference's bounds inside their exactness
window (the reference's own argument): the stream and scan statistics
differ only by float32 reassociation (a 100-row chunk's matmuls sum in
another order than the 1,024-row ones; at chunk_rows = N the two fits are
bitwise equal), but the Gibbs map doubles such a difference every
iteration. On LIN-MC-CLS the last samples are 3.6e-7 apart after 1
iteration, 2.2e-6 after 4, 2.9e-4 after 8 and 5.9e-3 after 16, so at the
reference's 16 iterations the posterior means sit 3.6e-3 apart (MC-SVR
1.1e-3), beyond its 2e-4; the window is 4 iterations. MC-MLT starts at
W = 0, where every row with y != y_d sits at the gamma clamp and a one-ulp
change moves gamma by orders of magnitude (tests/test_torch_mlt.py): its
samples are 4.1e-4 apart after 1 iteration and 1.7e-3 after 4, so its
window is the first iteration (the reference's 6 give 1.07e-3 against
its 1e-3). Three chains (rng 'fused') are 2.6e-7 apart after 1 iteration
and 4.0e-3 after 2 (one gamma flipping branch in the inverse-Gaussian
sampler); their objective traces are 2.6e-4 apart after 4 (held to
1e-3). At the reference's iteration counts the MC fits are held on their
first objective (rtol 1e-5; MC-MLT's flat start leaves it 5.0e-5 apart,
held to 1e-4) and their score.

Then chunk-size invariance, a masked tail, the Nystrom stream fit against
its resident fit, ``peak_input_bytes``, one host sync an iteration, the
libsvm file path, one loader retry bitwise, and the refusals.
"""
import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.rng as jrng
from repro.core import PEMSVM as JaxSVM
from repro.core import SVMConfig as JaxConfig
from repro.core import linear as jlin
from repro.core import multiclass as jmlt
from repro.core import svr as jsvr
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.runtime.policy import FaultPolicy as JaxPolicy
from repro_torch.core import NystromSVM, PEMSVM, PhiSpec, SVMConfig, prng
from repro_torch.core import distributed
from repro_torch.core import linear as tlin
from repro_torch.core import multiclass as tmlt
from repro_torch.core import svr as tsvr
from repro_torch.core.linear import SVMData
from repro_torch.data import pipeline as tpipe
from repro_torch.data import save_libsvm
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import rng as trng
from repro_torch.runtime import FaultPolicy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep torch to two intra-op threads: the suite runs six workers at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _T(a):
    return torch.from_numpy(np.array(a))


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# --------------------------------------------------------------- exact
@pytest.mark.parametrize("n,k,seed", [(1000, 800, 1), (257, 31, 0),
                                      (64, 8, 5)])
def test_make_dna_like_bitwise(n, k, seed):
    Xr, yr = jsyn.make_dna_like(n, k, seed=seed)
    Xt, yt = tsyn.make_dna_like(n, k, seed=seed)
    assert Xt.dtype == Xr.dtype and yt.dtype == yr.dtype
    np.testing.assert_array_equal(Xt, Xr)
    np.testing.assert_array_equal(yt, yr)


def test_fault_policy_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JaxPolicy)}
    port = {f.name: f.default for f in dataclasses.fields(FaultPolicy)}
    assert port == ref
    assert FaultPolicy().loader_retries == 3
    with pytest.raises(AssertionError):
        FaultPolicy(loader_retries=-1)


def _flaky(fail_at: dict, n: int = 10):
    """factory(skip) over n one-array chunks; chunk i raises IOError
    fail_at[i] times in all (over every re-created source) first."""
    left = dict(fail_at)

    def factory(skip):
        def gen():
            for i in range(skip, n):
                if left.get(i, 0) > 0:
                    left[i] -= 1
                    raise IOError(f"chunk {i} unreadable")
                yield (np.full(3, i, np.float32),)
        return gen()
    return factory


def _retry_run(mod, fail_at, **kw):
    naps = []
    stats = mod.RetryStats()
    got = []
    err = None
    try:
        for c in mod.retrying_chunks(_flaky(fail_at), sleep=naps.append,
                                     stats=stats, **kw):
            got.append(int(c[0][0]))
    except IOError as e:
        err = str(e)
    return got, naps, dataclasses.astuple(stats), err


@pytest.mark.parametrize("fail_at,kw", [
    ({3: 1}, dict(retries=3, backoff=0.05)),
    ({0: 2, 5: 1, 9: 3}, dict(retries=3, backoff=0.01, jitter=0.5,
                              seed=7)),
    ({2: 3, 4: 1}, dict(retries=3, backoff=0.2, jitter=1.0, seed=3)),
    ({1: 1, 2: 1, 3: 1}, dict(retries=1, backoff=0.0, jitter=2.0)),
    ({4: 5}, dict(retries=3, backoff=0.05, jitter=0.3, seed=11)),
    ({6: 1}, dict(retries=0)),
])
def test_retrying_chunks_schedule_matches_reference(fail_at, kw):
    """The same chunks, the same sleeps (float for float), the same
    RetryStats and the same exhaustion for the same seed, jitter and
    failure sequence."""
    want = _retry_run(jpipe, fail_at, **kw)
    got = _retry_run(tpipe, fail_at, **kw)
    assert got == want
    if kw.get("retries", 3) and not any(v > kw["retries"]
                                        for v in fail_at.values()):
        assert got[0] == list(range(10)) and got[3] is None


def test_retrying_chunks_foreign_exception_propagates():
    def bad(done):
        def gen():
            yield (np.zeros(1),)
            raise ValueError("not an IO problem")
        return gen()

    with pytest.raises(ValueError):
        list(tpipe.retrying_chunks(bad, retries=5, backoff=0.0,
                                   sleep=lambda s: None))


def _ten_chunks(n=10, width=4):
    for i in range(n):
        yield (np.full((width,), i, np.float32),)


def test_prefetcher_forwards_worker_errors():
    def chunks():
        yield (np.zeros((4,), np.float32),)
        yield (np.ones((4,), np.float32),)
        raise IOError("disk vanished mid-file")

    got = []
    with pytest.raises(IOError, match="disk vanished"):
        for c in tpipe.ChunkPrefetcher(chunks(), depth=2):
            got.append(c)
    assert len(got) == 2


def test_prefetcher_early_stop_does_not_hang():
    """A consumer that stops after one chunk of an endless source returns
    at once, and the worker thread ends."""
    def endless():
        i = 0
        while True:
            yield (np.full((8,), i, np.float32),)
            i += 1

    before = threading.active_count()
    t0 = time.perf_counter()
    for _ in tpipe.ChunkPrefetcher(endless(), depth=2):
        break
    assert time.perf_counter() - t0 < 5.0
    deadline = time.perf_counter() + 5.0
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("depth", [0, -1])
def test_prefetcher_refuses_depth_below_one(depth):
    with pytest.raises(ValueError) as want:
        jpipe.ChunkPrefetcher(_ten_chunks(), depth=depth)
    with pytest.raises(ValueError) as got:
        tpipe.ChunkPrefetcher(_ten_chunks(), depth=depth)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_order_and_resident_bytes(depth):
    pf = tpipe.ChunkPrefetcher(_ten_chunks(width=6), depth=depth)
    assert pf.max_resident_bytes == 0
    out = [int(c[0][0]) for c in pf]
    assert out == list(range(10))
    assert pf.max_resident_bytes == 6 * 4 * (depth + 2)
    ref = jpipe.ChunkPrefetcher(_ten_chunks(width=6), depth=depth)
    list(ref)
    assert pf.max_resident_bytes == ref.max_resident_bytes


def test_prefetcher_stress_many_consumers():
    """Eight prefetchers drained at once with a short switch interval:
    each sees its own chunks, in order, none lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = {}
    try:
        def run(j):
            src = ((np.full((3,), 1000 * j + i, np.float32),)
                   for i in range(200))
            results[j] = [int(c[0][0]) for c in
                          tpipe.ChunkPrefetcher(src, depth=1 + j % 3)]
        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for j in range(8):
        assert results[j] == [1000 * j + i for i in range(200)]


@pytest.mark.parametrize("bias,pad", [(True, None), (False, None),
                                      (True, 8)])
def test_cpu_placer_assembles_like_the_host(bias, pad):
    """The chunk of ``_fit_stream_arrays``: the reference's host bias
    column, feature padding and row padding, bit for bit."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(150, 5)).astype(np.float32)
    t = rng.normal(size=150).astype(np.float32)
    Xb = np.concatenate([X, np.ones((150, 1), np.float32)], 1) if bias else X
    Xb = tpipe.pad_features_to(Xb, pad)
    Xp, tp, mp = distributed.pad_rows(Xb, t, 1, multiple=64)
    placer = tpipe.DevicePlacer("cpu", 64, Xb.shape[1], 5 if bias else None)
    for i0 in range(0, 150, 64):
        got = placer.place(placer.stage((X[i0:i0 + 64], t[i0:i0 + 64],
                                         None), 0), 0)
        for a, b in zip(got, (Xp, tp, mp)):
            np.testing.assert_array_equal(a.numpy(), b[i0:i0 + 64])


@pytest.mark.parametrize("kw,shards,index", [
    (dict(), 1, 0), (dict(add_bias=False), 1, 0), (dict(pad_features=8), 1, 0),
    (dict(), 4, 2), (dict(), 4, 3), (dict(task="MLT", num_classes=3), 1, 0),
])
def test_resident_setup_is_the_host_assembly(kw, shards, index):
    """``_prepare`` builds on the device what the parent built on the host:
    np.concatenate of the bias column, pad_features_to, then the row
    padding of ``distributed.shard_rows`` (a mesh rank: its slice)."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(203, 7)).astype(np.float32)
    y = (rng.integers(0, 3, 203) if kw.get("task") == "MLT"
         else rng.choice([-1.0, 1.0], 203)).astype(np.float32)
    svm = PEMSVM(SVMConfig(**kw), device="cpu")
    target = svm._targets(y)
    if shards > 1:
        svm._axes = distributed.MeshAxes(("data",), None, shards, index,
                                         tuple(range(shards)))
    data, state = svm._prepare(X, target)
    Xh = X
    if svm.config.add_bias:
        Xh = np.concatenate([Xh, np.ones((203, 1), np.float32)], 1)
    Xh = tpipe.pad_features_to(Xh, svm.config.pad_features)
    want = distributed.shard_rows(svm._axes, Xh, target)
    for a, b in zip(data, want):
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert state.shape[-1] == Xh.shape[1]


# -------------------------------------------------------- chunk bodies
def _chunk(seed, n=96, k=9, pad=17, task="CLS", M=3, raw=False):
    """One padded chunk (n valid rows, ``pad`` padded ones) as the stream
    driver hands it over: bias column = mask unless ``raw``."""
    rng = np.random.default_rng(seed)
    # Quarter-integer rows and (below) eighth-integer weights: every
    # margin is exact in float32 in both packages, so what is compared is
    # the statistic, not two matmuls' summation orders amplified by 1/gamma.
    X = (rng.integers(-4, 5, size=(n + pad, k)) / 4).astype(np.float32)
    X[n:] = 0.0
    if not raw:
        X[:, -1] = 1.0
        X[n:, -1] = 0.0
    if task == "MLT":
        y = rng.integers(0, M, n + pad).astype(np.int32)
    elif task == "SVR":
        y = (rng.integers(-8, 9, n + pad) / 4).astype(np.float32)
    else:
        y = rng.choice([-1.0, 1.0], n + pad).astype(np.float32)
    y[n:] = 0
    mask = np.zeros(n + pad, np.float32)
    mask[:n] = 1.0
    return X, y, mask


def _port_normal(b0, b1):
    z = trng.normal_from_bits(_T(np.asarray(b0).astype(np.int64)),
                              _T(np.asarray(b1).astype(np.int64)))
    return jnp.asarray(z.numpy())


def _phi_pair(seed, m=12, d=8):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(m, d)).astype(np.float32)
    P = (rng.normal(size=(m, m)) / m).astype(np.float32)
    return L, P


def _compare_dicts(got, want, scale_keys=("S", "b")):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.shape == v.shape, k
        if k in scale_keys:
            assert np.abs(g - v).max() <= 1e-5 * np.abs(v).max(), k
        else:
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


_CHUNK_CASES = [
    ("CLS", "EM", "host", 1, False), ("CLS", "MC", "host", 1, False),
    ("CLS", "MC", "fused", 1, False), ("CLS", "MC", "fused_predraw", 1, False),
    ("CLS", "MC", "fused", 3, False), ("CLS", "EM", "host", 1, True),
    ("CLS", "MC", "host", 1, True), ("SVR", "EM", "host", 1, False),
    ("SVR", "MC", "host", 1, False), ("SVR", "MC", "fused", 1, False),
    ("SVR", "MC", "fused", 3, False), ("SVR", "EM", "host", 1, True),
]


@pytest.mark.parametrize("task,mode,rng,chains,phi", _CHUNK_CASES)
def test_chunk_body_matches_reference(task, mode, rng, chains, phi,
                                      monkeypatch):
    """cls_chunk_stats / svr_chunk_stats on one padded chunk at row offset
    row0 = 4,096 against the reference's."""
    X, y, mask = _chunk(3, raw=phi, task=task)
    K = 13 if phi else X.shape[1]
    g = np.random.default_rng(4)
    w = (g.integers(-3, 4, size=(chains, K) if chains > 1 else K) / 8
         ).astype(np.float32)
    if rng != "host":
        monkeypatch.setattr(jrng, "normal_from_bits", _port_normal)
    L, P = _phi_pair(5, m=12, d=X.shape[1])
    kw = dict(mode=mode, eps=1e-6, rng=rng, n_chains=chains, chain0=1)
    if task == "SVR":
        kw["eps_ins"] = 0.3
    tphi = (_T(L), _T(P)) if phi else None
    jphi = (jnp.asarray(L), jnp.asarray(P)) if phi else None
    jspec = jlin.PhiSpec(sigma=2.0, kind="rbf", add_bias=True) if phi else None
    tspec = PhiSpec(sigma=2.0, kind="rbf", add_bias=True) if phi else None
    jfn = jsvr.svr_chunk_stats if task == "SVR" else jlin.cls_chunk_stats
    tfn = tsvr.svr_chunk_stats if task == "SVR" else tlin.cls_chunk_stats
    _, jkey = jax.random.split(jax.random.PRNGKey(9))
    tkey = prng.split(prng.PRNGKey(9))[1]
    with jax.disable_jit():
        want = jfn(jlin.SVMData(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(mask)), jnp.asarray(w), jkey,
                   jnp.int32(4096), backend=None, phi=jphi, phi_spec=jspec,
                   **kw)
    got = tfn(SVMData(_T(X), _T(y), _T(mask)), _T(w),
              tkey if mode == "MC" else None, 4096, backend=None, phi=tphi,
              phi_spec=tspec, **kw)
    _compare_dicts(got, want)


@pytest.mark.parametrize("mode,rng,phi", [
    ("EM", "host", False), ("MC", "host", False), ("MC", "fused", False),
    ("EM", "host", True)])
def test_mlt_chunk_bodies_match_reference(mode, rng, phi, monkeypatch):
    """mlt_class_chunk_stats for every class and mlt_chunk_obj on one
    padded chunk, the W half updated."""
    M = 3
    X, y, mask = _chunk(6, task="MLT", M=M, raw=phi)
    L, P = _phi_pair(7, m=10, d=X.shape[1])
    K = 11 if phi else X.shape[1]
    W = (np.random.default_rng(8).integers(-3, 4, size=(M, K)) / 8
         ).astype(np.float32)
    if rng != "host":
        monkeypatch.setattr(jrng, "normal_from_bits", _port_normal)
    jphi = (jnp.asarray(L), jnp.asarray(P)) if phi else None
    tphi = (_T(L), _T(P)) if phi else None
    jspec = jlin.PhiSpec(sigma=2.5, kind="rbf", add_bias=True) if phi else None
    tspec = PhiSpec(sigma=2.5, kind="rbf", add_bias=True) if phi else None
    jdata = jlin.SVMData(jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
    tdata = SVMData(_T(X), _T(y), _T(mask))
    _, jkey = jax.random.split(jax.random.PRNGKey(2))
    tkey = prng.split(prng.PRNGKey(2))[1] if mode == "MC" else None
    for cls in range(M):
        with jax.disable_jit():
            want = jmlt.mlt_class_chunk_stats(
                jdata, jnp.asarray(W), jkey, jnp.int32(8192), jnp.int32(cls),
                num_classes=M, mode=mode, eps=1e-6, backend=None, phi=jphi,
                phi_spec=jspec, rng=rng, chain0=0)
        got = tmlt.mlt_class_chunk_stats(
            tdata, _T(W), tkey, 8192, cls, num_classes=M, mode=mode,
            eps=1e-6, backend=None, phi=tphi, phi_spec=tspec, rng=rng)
        _compare_dicts(got, want)
    with jax.disable_jit():
        want = jmlt.mlt_chunk_obj(jdata, jnp.asarray(W), jphi, jspec, None)
    _compare_dicts(tmlt.mlt_chunk_obj(tdata, _T(W), tphi, tspec, None), want)


# ----------------------------------------------------------- whole fits
def _problem(task, seed=0, N=1024, K=16, M=3):
    """The reference's stream-test problem (tests/test_streaming.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, K)).astype(np.float32)
    w_true = rng.normal(size=K)
    if task == "SVR":
        y = (X @ w_true).astype(np.float32)
    elif task == "MLT":
        y = np.argmax(X @ rng.normal(size=(M, K)).T, 1).astype(np.int32)
    else:
        y = np.where(X @ w_true + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return X, y


# The reference test's options, iterations and bounds.
_OPTIONS = [
    ("LIN-EM-CLS", {}, 30, 1e-4),
    ("LIN-EM-SVR", dict(eps_ins=0.3), 30, 1e-4),
    ("LIN-EM-MLT", dict(num_classes=3), 16, 1e-4),
    ("LIN-MC-CLS", dict(burnin=8), 16, 2e-4),
    ("LIN-MC-SVR", dict(eps_ins=0.3, burnin=8), 16, 2e-4),
    ("LIN-MC-MLT", dict(num_classes=3, burnin=2, eps=1e-1), 6, 1e-3),
]
# Iterations an MC chain stays in its exactness window (module docstring).
_WINDOW = {"LIN-MC-CLS": 4, "LIN-MC-SVR": 4, "LIN-MC-MLT": 1}
MC_WINDOW = 4


def _opt_kw(kw, iters):
    kw = {"eps": 1e-2, **kw}
    kw["max_iters"] = kw["min_iters"] = iters
    return kw


def _scan_and_stream(options, kw, X, y):
    scan = PEMSVM(SVMConfig.from_options(options, **kw), device="cpu")
    strm = PEMSVM(SVMConfig.from_options(options, driver="stream",
                                         chunk_rows=100, **kw),
                  device="cpu")
    return scan, scan.fit(X, y), strm, strm.fit(X, y)


@pytest.fixture(scope="module")
def port_fits():
    out = {}
    for options, kw, iters, _ in _OPTIONS:
        X, y = _problem(options.split("-")[-1])
        out[options] = (*_scan_and_stream(options, _opt_kw(kw, iters), X, y),
                        X, y)
        if options in _WINDOW:
            n = _WINDOW[options]
            short = dict(_opt_kw(kw, n), burnin=n // 2)
            out[options, "window"] = _scan_and_stream(options, short, X, y)
    return out


@pytest.mark.parametrize("options,kw,iters,bound", _OPTIONS)
def test_stream_fit_matches_port_scan(port_fits, options, kw, iters, bound):
    scan, rs, strm, rt, X, y = port_fits[options]
    _, ws, _, wt = port_fits.get((options, "window"), (None, rs, None, rt))
    assert _rel_max(wt.weights, ws.weights) <= bound, (
        options, _rel_max(wt.weights, ws.weights))
    np.testing.assert_allclose(rt.objective[0], rs.objective[0],
                               rtol=1e-4 if options == "LIN-MC-MLT" else 1e-5)
    assert abs(strm.score(X, y) - scan.score(X, y)) < 1e-3
    assert rt.n_iters == rs.n_iters == iters
    assert rt.n_host_syncs == rt.n_iters
    assert set(rt.aux_history) == set(rs.aux_history)


@pytest.mark.parametrize("options,kw,iters,_bound", _OPTIONS)
def test_stream_fit_matches_reference_stream(port_fits, options, kw, iters,
                                             _bound):
    _, _, strm, rt, X, y = port_fits[options]
    kw = _opt_kw(kw, iters)
    if options == "LIN-MC-CLS":
        # its first iteration only (see the module docstring)
        r1 = JaxSVM(JaxConfig.from_options(
            options, driver="stream", chunk_rows=100,
            **{**kw, "max_iters": 1, "min_iters": 1})).fit(X, y)
        np.testing.assert_allclose(rt.objective[0], r1.objective[0],
                                   rtol=1e-5)
        for k in ("gamma_mean", "n_sv"):
            np.testing.assert_allclose(rt.aux_history[k][0],
                                       r1.aux_history[k][0], rtol=1e-5)
        return
    ref = JaxSVM(JaxConfig.from_options(options, driver="stream",
                                        chunk_rows=100, **kw))
    if options.endswith("MLT"):
        with jax.disable_jit():
            rr = ref.fit(X, y)
    else:
        rr = ref.fit(X, y)
    mc = "-MC-" in options
    assert rt.n_iters == rr.n_iters
    assert _rel(rt.weights, rr.weights) <= (0.15 if mc else 5e-2)
    assert abs(strm.score(X, y) - ref.score(X, y)) <= (0.02 if mc else 0.01)
    if not mc:
        o, orr = np.asarray(rt.objective), np.asarray(rr.objective)
        band = 5e-2 if options.endswith("SVR") else 2e-2
        assert np.max(np.abs(o - orr) / np.abs(orr)) <= band
    assert rt.peak_input_bytes == rr.peak_input_bytes


def test_stream_chunk_size_invariance():
    X, y = _problem("CLS")
    traces = []
    for cr in (64, 100, 300, 2048):
        res = PEMSVM(SVMConfig(driver="stream", chunk_rows=cr, eps=1e-2,
                               max_iters=10, min_iters=10),
                     device="cpu").fit(X, y)
        traces.append(np.array(res.objective))
    for t in traces[1:]:
        np.testing.assert_allclose(t, traces[0], rtol=1e-4)


def test_stream_masked_tail_chunk():
    X, y = _problem("CLS", N=1000)  # 1000 = 7 * 128 + 104: a padded tail
    a, b = (PEMSVM(SVMConfig(driver="stream", chunk_rows=cr, eps=1e-2,
                             max_iters=8, min_iters=8),
                   device="cpu").fit(X, y) for cr in (128, 100))
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-4, atol=1e-5)


def test_stream_early_stop_and_aux_match_loop():
    X, y = _problem("CLS")
    loop = PEMSVM(SVMConfig(driver="loop", eps=1e-2, max_iters=100),
                  device="cpu").fit(X, y)
    strm = PEMSVM(SVMConfig(driver="stream", chunk_rows=128, eps=1e-2,
                            max_iters=100), device="cpu").fit(X, y)
    assert strm.converged and loop.converged
    assert strm.n_iters == loop.n_iters == strm.n_host_syncs
    assert set(strm.aux_history) == {"objective", "gamma_mean", "n_sv"}
    np.testing.assert_allclose(strm.aux_history["n_sv"],
                               loop.aux_history["n_sv"])


@pytest.mark.parametrize("prefetch,chunk_rows", [(1, 48), (2, 48), (4, 100)])
def test_stream_peak_residency(prefetch, chunk_rows):
    """(prefetch + 2) chunks of X, target and mask, independent of N."""
    K = 17
    chunk_bytes = chunk_rows * K * 4 + 2 * chunk_rows * 4
    for N in (2048, 4096):
        X, y = _problem("CLS", N=N, K=16)
        res = PEMSVM(SVMConfig(driver="stream", chunk_rows=chunk_rows,
                               prefetch=prefetch, max_iters=2, min_iters=2),
                     device="cpu").fit(X, y)
        assert res.peak_input_bytes == (prefetch + 2) * chunk_bytes
    assert res.peak_input_bytes < 4096 * K * 4 / 5


def test_stream_multichain_matches_scan():
    X, y = _problem("CLS")
    for iters in (1, MC_WINDOW):
        kw = dict(algorithm="MC", rng="fused", n_chains=3, eps=1e-2,
                  max_iters=iters, min_iters=iters, burnin=0)
        rs = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
        rt = PEMSVM(SVMConfig(driver="stream", chunk_rows=100, **kw),
                    device="cpu").fit(X, y)
        assert rt.chain_weights.shape == (3, 17)
        np.testing.assert_allclose(rt.objective[0], rs.objective[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(rt.objective, rs.objective, rtol=1e-3)
    rt1 = PEMSVM(SVMConfig(driver="stream", chunk_rows=100,
                           **dict(kw, max_iters=1, min_iters=1)),
                 device="cpu").fit(X, y)
    rs1 = PEMSVM(SVMConfig(**dict(kw, max_iters=1, min_iters=1)),
                 device="cpu").fit(X, y)
    assert _rel_max(rt1.chain_weights, rs1.chain_weights) <= 2e-4


def _messy_libsvm(path, X, y):
    save_libsvm(path, X, y)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("# generated by test\n\n")
        for i, ln in enumerate(lines):
            f.write(ln + ("  # sv" if i % 7 == 0 else "") + "\n")
            if i % 11 == 0:
                f.write("   \n")


def test_stream_fit_libsvm_end_to_end(tmp_path):
    X, y = _problem("CLS", N=600, K=10)
    p = str(tmp_path / "toy.libsvm")
    _messy_libsvm(p, X, y)
    kw = dict(eps=1e-2, max_iters=12, min_iters=12)
    resident = PEMSVM(SVMConfig(**kw), device="cpu").fit(X, y)
    svm = PEMSVM(SVMConfig(driver="stream", chunk_rows=64, **kw),
                 device="cpu")
    streamed = svm.fit_libsvm(p, n_features=10)
    assert _rel_max(streamed.weights, resident.weights) <= 1e-4
    ref = JaxSVM(JaxConfig(driver="stream", chunk_rows=64, **kw)
                 ).fit_libsvm(p, n_features=10)
    assert _rel_max(streamed.weights, ref.weights) <= 5e-2
    assert svm.predict(X[:5]).shape == (5,)


def test_fit_libsvm_resident_driver_loads_and_fits(tmp_path):
    X, y = _problem("CLS", N=200, K=6)
    p = str(tmp_path / "toy.libsvm")
    save_libsvm(p, X, y)
    a = PEMSVM(SVMConfig(max_iters=5, min_iters=5), device="cpu").fit_libsvm(
        p, n_features=6)
    b = PEMSVM(SVMConfig(max_iters=5, min_iters=5), device="cpu").fit(X, y)
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-4, atol=1e-5)


def test_fit_chunks_mlt_and_svr_targets():
    """fit_chunks on full-width chunks, MLT labels and SVR targets, equal
    to the array stream fit."""
    for task, kw in (("MLT", dict(num_classes=3)), ("SVR", dict(eps_ins=0.3))):
        X, y = _problem(task, N=500)
        cfg = SVMConfig(task=task, driver="stream", chunk_rows=64,
                        max_iters=4, min_iters=4, **kw)
        Xb = np.concatenate([X, np.ones((500, 1), np.float32)], 1)
        Xp, tp, mp = distributed.pad_rows(Xb, np.asarray(
            y, np.int32 if task == "MLT" else np.float32), 1, multiple=64)

        def chunks():
            for i0 in range(0, Xp.shape[0], 64):
                yield Xp[i0:i0 + 64], tp[i0:i0 + 64], mp[i0:i0 + 64]

        a = PEMSVM(cfg, device="cpu").fit_chunks(chunks, 17)
        b = PEMSVM(cfg, device="cpu").fit(X, y)
        np.testing.assert_array_equal(a.weights, b.weights)


def test_one_loader_retry_is_bitwise_the_clean_fit():
    """A chunk source that raises IOError once, mid-pass: one retry,
    restarted past the chunks already folded, and the fault-free fit's
    weights bit for bit."""
    X, y = _problem("CLS", N=700)
    Xb = np.concatenate([X, np.ones((700, 1), np.float32)], 1)
    Xp, tp, mp = distributed.pad_rows(Xb, y.astype(np.float32), 1,
                                      multiple=64)
    failed = [False]

    def chunks(fail):
        def gen():
            for j, i0 in enumerate(range(0, Xp.shape[0], 64)):
                if fail and j == 5 and not failed[0]:
                    failed[0] = True
                    raise IOError("transient read error")
                yield Xp[i0:i0 + 64], tp[i0:i0 + 64], mp[i0:i0 + 64]
        return gen

    cfg = SVMConfig(driver="stream", chunk_rows=64, max_iters=4,
                    min_iters=4)
    clean = PEMSVM(cfg, device="cpu").fit_chunks(chunks(False), 17)
    flaky = PEMSVM(cfg, device="cpu").fit_chunks(chunks(True), 17)
    assert failed[0]
    assert clean.loader_retries == 0 and flaky.loader_retries == 1
    assert flaky.loader_backoff_s == pytest.approx(0.05)
    np.testing.assert_array_equal(flaky.weights, clean.weights)


@pytest.mark.parametrize("options,kw,iters,bound", [
    ("KRN-EM-CLS", {}, 20, 1e-4),
    ("KRN-EM-SVR", dict(eps_ins=0.3), 20, 1e-4),
    ("KRN-MC-CLS", dict(burnin=MC_WINDOW // 2), MC_WINDOW, 2e-3),
    ("KRN-MC-SVR", dict(eps_ins=0.3, burnin=MC_WINDOW // 2), MC_WINDOW,
     2e-3),
    ("KRN-EM-MLT", dict(num_classes=3), 8, 1e-4),
])
def test_nystrom_stream_matches_resident(options, kw, iters, bound):
    """The reference's Nystrom stream-vs-resident bounds (its
    tests/test_nystrom.py), on the port; the MC chains over the exactness
    window (module docstring) in place of its 12 iterations."""
    task = options.split("-")[-1]
    rng = np.random.default_rng(7)
    X = rng.normal(size=(1536, 16)).astype(np.float32)
    wt = rng.normal(size=16)
    y = np.where(np.tanh(X @ wt) + 0.3 * rng.normal(size=1536) > 0,
                 1.0, -1.0).astype(np.float32)
    if task == "SVR":
        y = np.tanh(X @ np.random.default_rng(8).normal(size=16)
                    ).astype(np.float32)
    elif task == "MLT":
        y = np.argmax(np.abs(X @ rng.normal(size=(3, 16)).T), 1
                      ).astype(np.int32)
    kw = {"lam": 1.0, "sigma": 3.0, "eps": 1e-2, **kw}
    kw["max_iters"] = kw["min_iters"] = iters
    resident = NystromSVM(SVMConfig.from_options(options, **kw),
                          n_landmarks=48, device="cpu")
    streamed = NystromSVM(SVMConfig.from_options(
        options, driver="stream", chunk_rows=192, **kw), n_landmarks=48,
        device="cpu")
    rr = resident.fit(X, y)
    rs = streamed.fit(X, y)
    np.testing.assert_array_equal(streamed._landmarks, resident._landmarks)
    assert _rel_max(rs.weights, rr.weights) <= bound
    np.testing.assert_allclose(rs.objective[0], rr.objective[0], rtol=1e-4)
    assert abs(streamed.score(X, y) - resident.score(X, y)) < 1e-2
    assert rs.peak_input_bytes == 4 * (192 * 16 * 4 + 2 * 192 * 4)


def test_nystrom_stream_masked_tail_equals_divisible():
    """A chunking with a masked tail (phi(0) != 0, so the mask is what
    zeroes those rows) equals a divisible one."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1200, 6)).astype(np.float32)
    y = np.where(X[:, 0] * X[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    fits = []
    for cr in (240, 256):   # 1200 = 5 * 240; 256 leaves a padded tail
        ny = NystromSVM(SVMConfig(formulation="KRN", driver="stream",
                                  chunk_rows=cr, lam=1.0, sigma=2.0,
                                  eps=1e-2, max_iters=8, min_iters=8),
                        n_landmarks=40, device="cpu")
        fits.append(ny.fit(X, y))
    assert _rel_max(fits[1].weights, fits[0].weights) <= 1e-4


def test_stream_refusals():
    X, y = _problem("CLS", N=64, K=4)
    with pytest.raises(NotImplementedError, match="NystromSVM"):
        PEMSVM(SVMConfig(formulation="KRN", driver="stream"), device="cpu")
    svm = PEMSVM(SVMConfig(driver="stream"), device="cpu")
    with pytest.raises(NotImplementedError, match="world > 1"):
        svm.fit_libsvm("/nonexistent.libsvm", n_features=4, rank=0, world=2)
    svm.mesh = object()           # as a mesh fit would hold one
    with pytest.raises(NotImplementedError, match="single-process"):
        svm.fit(X, y)
    with pytest.raises(ValueError, match="stream driver's entry point"):
        PEMSVM(SVMConfig(), device="cpu").fit_chunks(lambda: iter(()), 5)
    with pytest.raises(NotImplementedError, match="item 11"):
        PEMSVM(SVMConfig(driver="stream"), device="cpu").fit_chunks(
            lambda: iter(()), 5, resume_from="ckpt")
    donor = PEMSVM(SVMConfig(driver="stream", max_iters=2),
                   device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="warm_start.stats is None"):
        PEMSVM(SVMConfig(driver="stream", decay=0.5), device="cpu").fit(
            X, y, warm_start=donor)
    with pytest.raises(ValueError, match="yielded no chunks"):
        PEMSVM(SVMConfig(driver="stream"), device="cpu").fit_chunks(
            lambda: iter(()), 5)
    with pytest.raises(ValueError, match="labels must be"):
        PEMSVM(SVMConfig(driver="stream"), device="cpu").fit(X, 2 * y)
