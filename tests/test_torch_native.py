"""The port's native package (`predictionio_torch.native`): the C++
bucketizer held bit for bit to the port's numpy `bucket_ragged` (the
reference's tests/test_native.py, on the port's copies), its `max_cap`
truncation to the reference's numpy path, the library's build directory,
and console `status`'s native line."""

import unittest.mock as mock

import numpy as np
import pytest

from predictionio_torch import native
from predictionio_torch.ops import als


@pytest.fixture()
def _native():
    """Skips unless g++ built the native library; decided when a test
    runs, never while the module is collected."""
    if not native.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native library")


needs_native = pytest.mark.usefixtures("_native")


def _python_buckets(rows, cols, vals, n_rows, row_multiple=8,
                    cap_growth=1.5):
    """The port's numpy path, whatever the native library's state."""
    with mock.patch.object(native, "bucket_ragged_native",
                           return_value=None):
        return als.bucket_ragged(rows, cols, vals, n_rows, row_multiple,
                                 cap_growth=cap_growth)


def _reference_buckets(rows, cols, vals, n_rows, max_cap):
    """The reference's numpy path with `max_cap` (the port's numpy
    `bucket_ragged` has no cap)."""
    from predictionio_tpu import native as ref_native
    from predictionio_tpu.ops import als as ref_als

    with mock.patch.object(ref_native, "bucket_ragged_native",
                           return_value=None):
        return ref_als.bucket_ragged(rows, cols, vals, n_rows,
                                     max_cap=max_cap)


def synth(n, n_rows, n_cols, seed, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        raw = rng.zipf(1.5, n).astype(np.int64)
        rows = (raw % n_rows).astype(np.int32)
    else:
        rows = rng.integers(0, n_rows, n).astype(np.int32)
    cols = rng.integers(0, n_cols, n).astype(np.int32)
    vals = rng.uniform(1, 5, n).astype(np.float32)
    return rows, cols, vals


def _assert_buckets_equal(want, got):
    assert got is not None
    assert len(want) == len(got)
    for w, g in zip(want, got):
        for field in ("rows", "cols", "vals", "mask"):
            a, b = getattr(w, field), getattr(g, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)


@needs_native
class TestNativeBucketize:
    @pytest.mark.parametrize("seed,zipf", [(0, False), (1, True), (2, True)])
    @pytest.mark.parametrize("row_multiple", [8, 16])
    def test_bit_identical_to_python(self, seed, zipf, row_multiple):
        rows, cols, vals = synth(5000, 300, 200, seed, zipf)
        py = _python_buckets(rows, cols, vals, 300, row_multiple)
        nat = native.bucket_ragged_native(rows, cols, vals, 300, row_multiple)
        _assert_buckets_equal(py, nat)

    def test_bucket_ragged_takes_the_native_path(self):
        rows, cols, vals = synth(2000, 100, 80, 7, zipf=True)
        calls = []
        real = native.bucket_ragged_native

        def spy(*a, **k):
            out = real(*a, **k)
            calls.append(out is not None)
            return out

        with mock.patch.object(native, "bucket_ragged_native", spy):
            got = als.bucket_ragged(rows, cols, vals, 100)
        assert calls == [True]
        _assert_buckets_equal(_python_buckets(rows, cols, vals, 100), got)

    def test_max_cap_truncation_matches(self):
        rows, cols, vals = synth(4000, 50, 100, 3, zipf=True)
        ref = _reference_buckets(rows, cols, vals, 50, max_cap=16)
        nat = native.bucket_ragged_native(rows, cols, vals, 50, 8, 16)
        _assert_buckets_equal(ref, nat)

    def test_non_pow2_max_cap(self):
        rows, cols, vals = synth(3000, 40, 60, 4, zipf=True)
        ref = _reference_buckets(rows, cols, vals, 40, max_cap=100)
        nat = native.bucket_ragged_native(rows, cols, vals, 40, 8, 100)
        assert ([b.cols.shape[1] for b in ref]
                == [b.cols.shape[1] for b in nat])
        _assert_buckets_equal(ref, nat)

    def test_out_of_range_rows_fall_back(self):
        # row id >= n_rows: native defers to numpy so behavior is the
        # same with and without a toolchain
        rows = np.array([0, 5], dtype=np.int32)  # 5 >= n_rows=3
        cols = np.zeros(2, np.int32)
        vals = np.ones(2, np.float32)
        assert native.bucket_ragged_native(rows, cols, vals, 3) is None

    def test_empty_input(self):
        nat = native.bucket_ragged_native(
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32), 10)
        assert nat == []

    def test_single_row_all_entries(self):
        rows = np.zeros(37, np.int32)
        cols = np.arange(37, dtype=np.int32)
        vals = np.ones(37, np.float32)
        py = _python_buckets(rows, cols, vals, 1)
        nat = native.bucket_ragged_native(rows, cols, vals, 1)
        assert len(nat) == 1 and nat[0].cols.shape[1] == 40  # 8,16,24,40
        _assert_buckets_equal(py, nat)
        nat2 = native.bucket_ragged_native(rows, cols, vals, 1,
                                           cap_growth=2.0)
        assert nat2[0].cols.shape[1] == 64  # pow2 ladder

    def test_als_train_uses_native_and_matches_numpy(self):
        """als_train with the native loader gives the numpy loader's
        factors bit for bit (the buckets are equal)."""
        rng = np.random.default_rng(5)
        ui = rng.integers(0, 40, 600).astype(np.int32)
        ii = rng.integers(0, 30, 600).astype(np.int32)
        r = rng.uniform(1, 5, 600).astype(np.float32)
        cfg = als.ALSConfig(rank=4, iterations=3, reg=0.05, seed=1)
        out_native = als.als_train(ui, ii, r, 40, 30, cfg, device="cpu")
        with mock.patch.object(native, "bucket_ragged_native",
                               return_value=None):
            out_py = als.als_train(ui, ii, r, 40, 30, cfg, device="cpu")
        np.testing.assert_array_equal(out_native.user_factors,
                                      out_py.user_factors)
        np.testing.assert_array_equal(out_native.item_factors,
                                      out_py.item_factors)


class TestFallback:
    def test_env_disable(self, monkeypatch):
        monkeypatch.setenv("PIO_NATIVE", "0")
        assert native.get_lib() is None
        assert native.bucket_ragged_native(
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.ones(1, np.float32), 1) is None
        assert native.native_status().startswith("disabled (PIO_NATIVE=0)")
        rows, cols, vals = synth(500, 30, 20, 9)
        with mock.patch.object(native, "bucket_ragged_native",
                               wraps=native.bucket_ragged_native) as spy:
            got = als.bucket_ragged(rows, cols, vals, 30)
        assert spy.call_count == 1
        want = _python_buckets(rows, cols, vals, 30)
        _assert_buckets_equal(want, got)


@needs_native
class TestCapGrowthParity:
    """The C++ ladder must match numpy bit-for-bit at every growth."""

    @pytest.mark.parametrize("growth", [2.0, 1.5, 1.25])
    def test_ladder_parity(self, growth):
        rows, cols, vals = synth(5000, 300, 200, seed=11, zipf=True)
        py = _python_buckets(rows, cols, vals, 300, cap_growth=growth)
        nat = native.bucket_ragged_native(rows, cols, vals, 300,
                                          cap_growth=growth)
        _assert_buckets_equal(py, nat)


@needs_native
class TestBuild:
    def test_library_builds_under_build_torch_native(self, tmp_path,
                                                     monkeypatch):
        """The port's library lives in build/torch_native/ at the root of
        the checkout, whatever PIO_FS_BASEDIR says, and never at the
        reference's build path (the same sources would name the same
        file there)."""
        import os

        from predictionio_tpu import native as ref_native

        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert native._build_dir() == os.path.join(repo, "build",
                                                   "torch_native")
        so = native._compile()
        assert so is not None and os.path.dirname(so) == native._build_dir()
        assert native._build_dir() != ref_native._build_dir()
        assert not os.path.exists(os.path.join(tmp_path, "native"))
        assert native.get_lib()._name == so
        assert native.native_status() == "available (loaded)"

    def test_console_status_prints_the_native_line(self, tmp_path,
                                                   monkeypatch, capsys):
        from predictionio_torch.storage.registry import Storage
        from predictionio_torch.tools import console

        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        Storage.reset(None)
        assert console.main(["status"]) == 0
        out = capsys.readouterr().out
        assert "Storage status: all OK" in out
        assert ("Native fast paths (scan/bucketize/import/export/"
                "aggregate): available (loaded)") in out
        monkeypatch.setenv("PIO_NATIVE", "0")
        assert console.main(["status"]) == 0
        assert "disabled (PIO_NATIVE=0)" in capsys.readouterr().out
