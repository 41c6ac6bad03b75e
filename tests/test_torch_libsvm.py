"""The port's libsvm text IO (``repro_torch.data.libsvm``) against the JAX
package's ``repro.data.libsvm``: the same files, the same parsed rows,
the same padded blocks and the same error messages, exactly. Every file is
written by the test under ``tmp_path``."""
import numpy as np
import pytest

from repro.data import libsvm as jlib
from repro_torch.data import libsvm as tlib


def _rows(seed=0, n=57, k=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(np.float32)
    X[rng.random((n, k)) < 0.4] = 0.0          # sparse rows, some empty
    X[3] = 0.0
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return X, y


def _messy(path, X, y):
    """A file as the reference's end-to-end test writes it: a comment
    header, blank and whitespace-only lines, trailing comments."""
    jlib.save_libsvm(path, X, y)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("# generated by test\n\n")
        for i, ln in enumerate(lines):
            f.write(ln + ("  # sv" if i % 7 == 0 else "") + "\n")
            if i % 11 == 0:
                f.write("   \n")


@pytest.mark.parametrize("labels", ["binary", "real", "int"])
def test_save_libsvm_writes_the_same_bytes(tmp_path, labels):
    X, y = _rows()
    if labels == "real":
        y = (y * 0.37 + X[:, 0]).astype(np.float32)
    elif labels == "int":
        y = (np.arange(len(y)) % 5).astype(np.int32)
    a, b = tmp_path / "ref.libsvm", tmp_path / "port.libsvm"
    jlib.save_libsvm(str(a), X, y)
    tlib.save_libsvm(str(b), X, y)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("line", [
    "1 1:0.5 3:-2", "-1", "+1 2:1e-3  4:7 # comment", "   ", "",
    "# only a comment", "0.25 1:1 1:2", "3 10:4.5", "2 3:0", "1\t2:3",
])
def test_parse_line_matches(line):
    assert tlib.parse_libsvm_line(line, 9) == jlib.parse_libsvm_line(line, 9)


@pytest.mark.parametrize("line", [
    "abc 1:2", "1 x:1", "1 3", "1 0:1", "1 -2:1", "1 1:abc", "1 1:",
    "1 :5",
])
def test_parse_errors_match(line):
    with pytest.raises(ValueError) as want:
        jlib.parse_libsvm_line(line, 12)
    with pytest.raises(ValueError) as got:
        tlib.parse_libsvm_line(line, 12)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("n_features", [None, 4, 6, 9])
def test_load_libsvm_matches(tmp_path, rank, world, n_features):
    X, y = _rows(seed=1)
    p = str(tmp_path / "d.libsvm")
    _messy(p, X, y)
    Xr, yr = jlib.load_libsvm(p, n_features, rank=rank, world=world)
    Xt, yt = tlib.load_libsvm(p, n_features, rank=rank, world=world)
    assert Xt.dtype == Xr.dtype and yt.dtype == yr.dtype
    np.testing.assert_array_equal(Xt, Xr)
    np.testing.assert_array_equal(yt, yr)


@pytest.mark.parametrize("chunk_rows", [1, 7, 16, 57, 100])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (0, 3)])
def test_iter_libsvm_blocks_match(tmp_path, chunk_rows, rank, world):
    X, y = _rows(seed=2)
    p = str(tmp_path / "d.libsvm")
    _messy(p, X, y)
    want = list(jlib.iter_libsvm(p, chunk_rows, 6, rank=rank, world=world))
    got = list(tlib.iter_libsvm(p, chunk_rows, 6, rank=rank, world=world))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # padded rows: X row 0, target 0, mask 0
    Xl, yl, ml = got[-1]
    assert np.all(Xl[ml == 0] == 0) and np.all(yl[ml == 0] == 0)


@pytest.mark.parametrize("args", [(0, 6), (4, 0), (-3, 2)])
def test_iter_libsvm_argument_errors_match(tmp_path, args):
    p = str(tmp_path / "d.libsvm")
    jlib.save_libsvm(p, *_rows())
    with pytest.raises(ValueError) as want:
        next(jlib.iter_libsvm(p, *args))
    with pytest.raises(ValueError) as got:
        next(tlib.iter_libsvm(p, *args))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", ["1 1:2 x:3\n", "nan? 1:1\n", "1 0:4\n"])
def test_malformed_file_errors_match(tmp_path, bad):
    p = str(tmp_path / "bad.libsvm")
    with open(p, "w") as f:
        f.write("1 1:1\n# c\n\n" + bad + "1 2:2\n")
    for load in (lambda m: m.load_libsvm(p, 3),
                 lambda m: list(m.iter_libsvm(p, 2, 3))):
        with pytest.raises(ValueError) as want:
            load(jlib)
        with pytest.raises(ValueError) as got:
            load(tlib)
        assert str(got.value) == str(want.value)
        assert "line 4" in str(got.value)
