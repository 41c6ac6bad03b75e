"""Shared test fixtures. NOTE: no XLA device-count flags here — smoke
tests and benches must see 1 device; multi-device tests run in
subprocesses (test_distributed.py)."""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _install_hypothesis_fallback():
    """Property tests use hypothesis when available; on bare images we
    substitute a deterministic sampler with the same tiny API surface
    (given/settings + integers/floats/lists) so the suite still collects
    and exercises each property on seeded random examples."""
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass
    import random
    import types

    class _Strategy:
        def __init__(self, gen):
            self._gen = gen

        def sample(self, rng):
            return self._gen(rng)

    def integers(lo=0, hi=2 ** 31 - 1):
        return _Strategy(lambda r: r.randint(lo, hi))

    def floats(lo=0.0, hi=1.0, **_):
        return _Strategy(lambda r: r.uniform(lo, hi))

    def lists(elem, min_size=0, max_size=16, **_):
        return _Strategy(
            lambda r: [elem.sample(r)
                       for _ in range(r.randint(min_size, max_size))])

    def given(*strategies, **kw_strategies):
        def deco(fn):
            # NOTE: zero-arg signature on purpose — pytest must not see
            # the property's parameters and hunt for fixtures.
            def wrapper():
                rng = random.Random(0xC0FFEE)
                for _ in range(getattr(wrapper, "_max_examples", 10)):
                    vals = [s.sample(rng) for s in strategies]
                    kvals = {k: s.sample(rng)
                             for k, s in kw_strategies.items()}
                    fn(*vals, **kvals)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def settings(max_examples=10, **_):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    hyp = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    st.integers, st.floats, st.lists = integers, floats, lists
    hyp.given, hyp.settings, hyp.strategies = given, settings, st
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_fallback()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")


def reduce_cfg(cfg, **extra):
    """Family-aware reduced config for CPU smoke tests."""
    kw = dict(n_layers=cfg.layer_period * 2, d_model=64, vocab=256,
              d_ff=128 if cfg.d_ff else 0)
    if cfg.mla:
        kw.update(n_heads=4, n_kv_heads=4, head_dim=16, kv_lora_rank=32,
                  q_lora_rank=48, qk_rope_dim=8, qk_nope_dim=16,
                  v_head_dim=16)
    else:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads
                  else 4, head_dim=16)
    if cfg.mrope:
        kw.update(mrope_sections=(2, 3, 3))
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2, moe_d_ff=32)
    if cfg.enc_dec:
        kw.update(n_enc_layers=2, enc_seq=16, n_kv_heads=4)
    kw.update(extra)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="session")
def blobs():
    from repro.data import make_blobs
    return make_blobs(1500, 20, seed=0)
