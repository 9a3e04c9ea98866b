"""The port's host-data engine (``mvae_torch/data/native.py``) against the
reference's (``mvae_tpu/data/native.py``).

The port compiles ``native/host_data.cc`` itself (``kernels._build.
build_host``) into ``mvae_torch/_build/``. The reference's bindings are
pointed at that same library (its ``_LIB_PATH``), so neither package's
tests write into ``native/`` or load a library another test may be
rebuilding there: the comparison holds the two packages' bindings and
their ``epoch_batches`` to each other on one build of one source.
"""
import gzip
import struct

import numpy as np
import pytest

from mvae_torch.data import ArrayDataset, native
from mvae_torch.kernels import _build


@pytest.fixture(scope="module")
def built():
    path = _build.build_host()
    assert native.available(), native.report()
    return path


@pytest.fixture
def reference(built, monkeypatch):
    from mvae_tpu.data import native as jnative
    monkeypatch.setattr(jnative, "_LIB_PATH", built)
    jnative._lib.cache_clear()
    assert jnative.available()
    yield jnative
    jnative._lib.cache_clear()


@pytest.mark.parametrize("seed,n", [(0, 1), (123, 1000), (2**40 + 7, 60000),
                                    (2**64 - 1, 17)])
def test_permutation_matches_reference(reference, seed, n):
    a = native.permutation(seed, n)
    np.testing.assert_array_equal(a, reference.permutation(seed, n))
    np.testing.assert_array_equal(np.sort(a), np.arange(n))
    # the engine's order, not numpy's
    if n > 1:
        plain = np.random.default_rng(seed).permutation(n)
        assert not np.array_equal(a, plain)


@pytest.mark.parametrize("shape", [(100, 7, 3), (50,), (9, 784)])
def test_gather_rows_matches_reference(reference, shape):
    src = np.random.default_rng(0).random(shape).astype(np.float32)
    idx = np.array([5, 0, 8, 3, 5], np.int64)
    out = native.gather_rows(src, idx)
    np.testing.assert_array_equal(out, reference.gather_rows(src, idx))
    np.testing.assert_array_equal(out, src[idx])


def test_gather_rows_refuses_an_index_out_of_range(built):
    src = np.zeros((4, 2), np.float32)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 4]))


def _datasets():
    from mvae_tpu.data.base import ArrayDataset as JArrayDataset
    rng = np.random.default_rng(1)
    train = rng.random((103, 5)).astype(np.float32)
    test = rng.random((20, 5)).astype(np.float32)
    return (ArrayDataset("mnist", train, test, (5,), True),
            JArrayDataset("mnist", train, test, (5,), True))


def _assert_same_batches(port, ref, epoch, split):
    a = list(port.epoch_batches(epoch, 16, split))
    b = list(ref.epoch_batches(epoch, 16, split))
    assert len(a) == len(b) == (103 if split == "train" else 20) // 16
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    return a


@pytest.mark.parametrize("epoch,split", [(0, "train"), (3, "train"),
                                         (1, "test")])
def test_epoch_batches_match_reference_with_the_engine(reference, epoch,
                                                       split):
    port, ref = _datasets()
    got = _assert_same_batches(port, ref, epoch, split)
    data = port.train if split == "train" else port.test
    assert not np.array_equal(np.concatenate(got), data[:len(got) * 16])


def test_epoch_batches_match_reference_without_the_engine(monkeypatch):
    """Both packages' ``available()`` False: numpy's order in both."""
    from mvae_tpu.data import native as jnative
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    port, ref = _datasets()
    for epoch in range(3):
        _assert_same_batches(port, ref, epoch, "train")


def test_the_two_orders_differ(reference, monkeypatch):
    port, _ = _datasets()
    engine = list(port.epoch_batches(0, 16))
    monkeypatch.setattr(native, "available", lambda: False)
    plain = list(port.epoch_batches(0, 16))
    assert not all(np.array_equal(a, b) for a, b in zip(engine, plain))


@pytest.mark.parametrize("gz", [False, True])
def test_read_idx_f32_round_trips(built, tmp_path, gz):
    payload = np.arange(24, dtype=np.uint8) * 10
    raw = struct.pack(">BBBB", 0, 0, 8, 3) + struct.pack(
        ">III", 4, 3, 2) + payload.tobytes()
    path = tmp_path / ("x.idx.gz" if gz else "x.idx")
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(raw)
    else:
        path.write_bytes(raw)
    arr = native.read_idx_f32(path)
    assert arr.shape == (4, 3, 2) and arr.dtype == np.float32
    np.testing.assert_allclose(arr.ravel() * 255.0, payload, atol=1e-4)
    from mvae_torch.data import loaders
    np.testing.assert_array_equal(loaders._read_idx(path).ravel(), payload)


def test_read_idx_f32_reports_a_bad_file(built, tmp_path):
    path = tmp_path / "bad.idx"
    path.write_bytes(b"\x01\x02")
    with pytest.raises(IOError, match="rc="):
        native.read_idx_f32(path)


def test_a_failed_build_is_reported_not_swallowed(monkeypatch):
    """``available()`` is False only because the build raised, and the
    failure's message is kept (``report``); the decode then refuses."""
    def broken():
        raise RuntimeError("g++ failed for host_data.cc: no zlib.h")
    monkeypatch.setattr(_build, "build_host", broken)
    native._load.cache_clear()
    try:
        assert not native.available()
        rep = native.report()
        assert not rep["active"] and "no zlib.h" in rep["why"]
        with pytest.raises(RuntimeError, match="no zlib.h"):
            native.read_idx_f32("unused.idx")
        np.testing.assert_array_equal(native.permutation(3, 10),
                                      np.random.default_rng(3).permutation(10))
    finally:
        native._load.cache_clear()


def test_build_is_cached_by_source_and_flags(built):
    mtime = built.stat().st_mtime_ns
    assert _build.build_host() == built
    assert built.stat().st_mtime_ns == mtime
    assert built.parent == _build.BUILD_DIR
    assert native.report()["active"]
