"""The port's train runtime on the CPU: the on-disk bucket cache
(`ops/als.py::bucketize_cached`; the reference's tests/test_bucket_cache.py
cases, written for the port), its bucket arrays against the reference's
`bucket_ragged_split`, the grid's and the eval's reuse of a train's entry,
the fixed-order sum of split rows' segments, and the console and workflow
around `als_train`: `console train --checkpoint-dir` killed at an epoch
boundary and re-run, `--metrics-file`, `--profile-dir`, `--check-asserts`,
`console run` and `run_fake_workflow`."""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from predictionio_torch.ops import als, als_grid, spd_solve
from predictionio_torch.ops.als import ALSConfig, als_train
from predictionio_torch.storage.registry import Storage
from predictionio_torch.tools import console
from predictionio_torch.utils import checks
from predictionio_torch.workflow.core_workflow import read_model_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_JSON = os.path.join(REPO, "predictionio_torch", "templates",
                           "recommendation", "engine.json")
LOGGER = "predictionio_torch.ops.als"

CFG = ALSConfig(rank=6, iterations=2, reg=0.05, seed=0, solver="chol",
                split_cap=16)


def _data(seed=0, nnz=800, n_u=40, n_i=30):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_u, nnz).astype(np.int32),
            rng.integers(0, n_i, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32), n_u, n_i)


def _train(ui, ii, r, n_u, n_i, cfg=CFG, **kw):
    return als_train(ui, ii, r, n_u, n_i, cfg, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


# -- the bucket cache ----------------------------------------------------------

class TestBucketCache:
    def test_hit_after_miss_and_identical_factors(self, tmp_path, caplog):
        ui, ii, r, n_u, n_i = _data()
        cache = str(tmp_path / "cache")
        with caplog.at_level(logging.INFO, LOGGER):
            a = _train(ui, ii, r, n_u, n_i, bucket_cache_dir=cache)
            assert any("bucket cache miss" in m for m in caplog.messages)
            caplog.clear()
            b = _train(ui, ii, r, n_u, n_i, bucket_cache_dir=cache)
            assert any("bucket cache hit" in m for m in caplog.messages)
        np.testing.assert_array_equal(a.user_factors, b.user_factors)
        np.testing.assert_array_equal(a.item_factors, b.item_factors)

    @pytest.mark.parametrize("mutate", ["ratings", "split_cap", "growth"])
    def test_invalidation(self, tmp_path, caplog, mutate):
        ui, ii, r, n_u, n_i = _data()
        cache = str(tmp_path / "cache")
        _train(ui, ii, r, n_u, n_i, bucket_cache_dir=cache)
        cfg = CFG
        if mutate == "ratings":  # one changed event must miss
            r = r.copy()
            r[0] += 1.0
        elif mutate == "split_cap":
            cfg = dataclasses.replace(CFG, split_cap=24)
        else:
            cfg = dataclasses.replace(CFG, cap_growth=2.0)
        with caplog.at_level(logging.INFO, LOGGER):
            _train(ui, ii, r, n_u, n_i, cfg, bucket_cache_dir=cache)
        assert any("bucket cache miss" in m for m in caplog.messages)
        assert not any("bucket cache hit" in m for m in caplog.messages)

    def test_solver_hyperparameters_share_the_entry(self, tmp_path, caplog):
        ui, ii, r, n_u, n_i = _data()
        cache = str(tmp_path / "cache")
        _train(ui, ii, r, n_u, n_i, bucket_cache_dir=cache)
        with caplog.at_level(logging.INFO, LOGGER):
            _train(ui, ii, r, n_u, n_i,
                   dataclasses.replace(CFG, rank=3, reg=0.5, seed=4,
                                       implicit=True, alpha=2.0),
                   bucket_cache_dir=cache)
        assert any("bucket cache hit" in m for m in caplog.messages)

    @pytest.mark.parametrize("damage", ["corrupt", "truncated"])
    def test_damaged_entry_rebuckets(self, tmp_path, caplog, damage):
        ui, ii, r, n_u, n_i = _data()
        cache = tmp_path / "cache"
        ref = _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(cache))
        (entry,) = cache.glob("*.npz")
        entry.write_bytes(b"not an npz" if damage == "corrupt"
                          else entry.read_bytes()[:100])  # keeps PK magic
        with caplog.at_level(logging.WARNING, LOGGER):
            out = _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(cache))
        assert any("unreadable" in m for m in caplog.messages)
        np.testing.assert_array_equal(out.user_factors, ref.user_factors)

    def test_gc_keeps_newest(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_BUCKET_CACHE_KEEP", "2")
        cache = tmp_path / "cache"
        keys = []
        for seed in range(4):
            ui, ii, r, n_u, n_i = _data(seed=seed)
            _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(cache))
            keys.append({p.name for p in cache.glob("*.npz")})
            time.sleep(0.01)  # distinct mtimes
        assert len(keys[-1]) == 2
        assert keys[-1] == (keys[3] - keys[1]) | (keys[2] - keys[1])

    def test_failed_save_is_logged_and_the_train_goes_on(self, tmp_path,
                                                         caplog):
        ui, ii, r, n_u, n_i = _data()
        blocker = tmp_path / "not-a-dir"
        blocker.write_text("x")
        with caplog.at_level(logging.WARNING, LOGGER):
            out = _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(blocker))
        assert any("bucket cache save failed" in m for m in caplog.messages)
        np.testing.assert_array_equal(out.user_factors,
                                      _train(ui, ii, r, n_u, n_i).user_factors)

    def test_stale_temporary_files_are_swept(self, tmp_path):
        ui, ii, r, n_u, n_i = _data()
        cache = tmp_path / "cache"
        cache.mkdir()
        old = time.time() - 7200
        for name in ("torch-dead.tmp", "reference-dead.tmp"):
            (cache / name).write_bytes(b"x")
            os.utime(cache / name, (old, old))
        (cache / "torch-live.tmp").write_bytes(b"x")
        _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(cache))
        names = {p.name for p in cache.iterdir()}
        assert "torch-dead.tmp" not in names
        assert {"reference-dead.tmp", "torch-live.tmp"} <= names

    def test_never_loads_nor_collects_the_references_entry(
            self, tmp_path, caplog, monkeypatch):
        """PIO_FS_BASEDIR is one directory for both packages: the port's
        key carries its own tag, so the reference's entry for the same
        data is a miss here, and the port's GC leaves it alone."""
        from predictionio_tpu.ops import als as ref_als

        monkeypatch.setenv("PIO_BUCKET_CACHE_KEEP", "1")
        ui, ii, r, n_u, n_i = _data()
        cache = tmp_path / "cache"
        ref_als.bucketize_cached(ui, ii, r, n_u, n_i, 8, 16, 1.5, str(cache))
        (ref_entry,) = cache.glob("*.npz")
        with caplog.at_level(logging.INFO, LOGGER):
            _train(ui, ii, r, n_u, n_i, bucket_cache_dir=str(cache))
            _train(*_data(seed=1), bucket_cache_dir=str(cache))
        assert not any("bucket cache hit" in m for m in caplog.messages)
        assert ref_entry.exists()
        assert len([p for p in cache.glob("torch-*.npz")]) == 1

    def test_hit_arrays_equal_the_references_bucketizer(self, tmp_path):
        """A hit's buckets, bit for bit, are the reference's
        `bucket_ragged_split` at row_multiple 8, split rows included."""
        from predictionio_tpu.ops import als as ref_als

        ui, ii, r, n_u, n_i = _data(seed=2, nnz=1500)
        cache = str(tmp_path / "cache")
        args = (ui, ii, r, n_u, n_i, 8, 16, 1.5, cache)
        als.bucketize_cached(*args)
        ub, us, ib, isp = als.bucketize_cached(*args)
        assert len(us) > 0 and len(isp) > 0
        for mine, split, (rows, cols, n) in ((ub, us, (ui, ii, n_u)),
                                             (ib, isp, (ii, ui, n_i))):
            theirs, tsplit = ref_als.bucket_ragged_split(rows, cols, r, n, 8,
                                                         16)
            np.testing.assert_array_equal(split, tsplit)
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                for f in ("rows", "cols", "vals", "mask"):
                    x, y = getattr(a, f), getattr(b, f)
                    np.testing.assert_array_equal(x, y)
                    assert x.dtype == y.dtype
                assert (a.segmap is None) == (b.segmap is None)
                if a.segmap is not None:
                    np.testing.assert_array_equal(a.segmap, b.segmap)

    def test_grid_reuses_a_trains_entry(self, tmp_path, caplog):
        ui, ii, r, n_u, n_i = _data()
        cache = str(tmp_path / "cache")
        cfgs = [dataclasses.replace(CFG, reg=lam) for lam in (0.01, 0.1)]
        seq = [_train(ui, ii, r, n_u, n_i, c, bucket_cache_dir=cache)
               for c in cfgs]
        with caplog.at_level(logging.INFO, LOGGER):
            grid = als_grid.als_train_grid(ui, ii, r, n_u, n_i, cfgs,
                                           device="cpu",
                                           bucket_cache_dir=cache)
        assert any("bucket cache hit" in m for m in caplog.messages)
        for g, s in zip(grid, seq):
            np.testing.assert_allclose(g.user_factors, s.user_factors,
                                       rtol=1e-4, atol=1e-5)


def test_eval_grid_hits_the_entry_of_a_train(tmp_path, monkeypatch, caplog):
    """The Recommendation template's `train` leaves an entry under
    `ctx.algorithm_cache_dir("als")`; its `train_grid` on the same
    prepared data (an eval over (λ, α)) loads it."""
    from predictionio_torch.controller.context import WorkflowContext
    from predictionio_torch.templates.recommendation import engine as rec

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PIO_BUCKET_CACHE", "1")
    ui, ii, r, n_u, n_i = _data()
    keep = np.unique(ui.astype(np.int64) * n_i + ii, return_index=True)[1]
    pd = rec.PreparedData(
        user_ids=rec.BiMap.string_int([f"u{u}" for u in range(n_u)]),
        item_ids=rec.BiMap.string_int([f"i{i}" for i in range(n_i)]),
        user_idx=ui[keep], item_idx=ii[keep], ratings=r[keep])
    ctx = WorkflowContext(device="cpu")
    algos = [rec.ALSAlgorithm(rec.ALSAlgorithmParams(
        rank=4, numIterations=2, lambda_=lam, seed=1)) for lam in (0.01, 0.1)]
    algos[0].train(ctx, pd)
    assert len(list((tmp_path / "cache" / "als").glob("torch-*.npz"))) == 1
    with caplog.at_level(logging.INFO, LOGGER):
        models = rec.ALSAlgorithm.train_grid(ctx, pd, algos)
    assert len(models) == 2
    assert any("bucket cache hit" in m for m in caplog.messages)
    assert not any("bucket cache miss" in m for m in caplog.messages)


# -- split rows: the segments summed in a fixed order ---------------------------

def test_sum_segments_adds_in_walk_order():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((9, 3, 3)).astype(np.float32)
    table[8] = 0.0  # the zero row
    segments = np.array([[0, 4, 5, 2], [1, 3, 8, 8], [6, 7, 8, 8]])
    (got,) = als._sum_segments(torch.as_tensor(segments),
                               torch.as_tensor(table))
    for u, row in enumerate(segments):
        want = table[row[0]]
        for j in row[1:]:
            want = want + table[j]
        np.testing.assert_array_equal(got[u].numpy(), want)


def test_split_positions_plan():
    ui, ii, r, n_u, n_i = _data(seed=5, nnz=1500)
    buckets, split = als.bucket_ragged_split(ii, ui, r, n_i, 8, 16)
    positions, segments, n_seg = als._split_positions(buckets, len(split))
    walked = []  # (slot, position) of every segment row, in walk order
    for b, pos in zip(buckets, positions):
        if b.segmap is None:
            assert pos is None
            continue
        is_seg = b.segmap < len(split)
        assert (pos[~is_seg] == n_seg).all()
        walked += list(zip(b.segmap[is_seg], pos[is_seg]))
    assert sorted(p for _, p in walked) == list(range(n_seg))
    for u in range(len(split)):
        mine = [p for s, p in walked if s == u]
        assert len(mine) >= 2  # a split row has two segments at least
        assert list(segments[u, :len(mine)]) == mine
        assert (segments[u, len(mine):] == n_seg + 1).all()


@pytest.mark.parametrize("implicit", [False, True])
def test_fixed_order_combine_equals_sequential_accumulation(implicit):
    """On the CPU `index_add_` accumulates in index order: the fixed-order
    combine gives its bits, segment by segment (0 + s0 = s0)."""
    ui, ii, r, n_u, n_i = _data(seed=6, nnz=1500)
    cfg = dataclasses.replace(CFG, implicit=implicit, rank=4)
    buckets, split = als.bucket_ragged_split(ii, ui, r, n_i, 8, 16)
    opposing = torch.as_tensor(
        np.random.default_rng(1).standard_normal((n_u, 4)).astype(np.float32))
    bdev, plan = als._put_side(buckets, split, torch.device("cpu"))
    got = als._solve_buckets_device(opposing, n_i, bdev, cfg, plan)
    # the accumulation by index_add_, on the same partials
    k = 4
    acc_a = torch.zeros((len(split) + 1, k, k))
    table_a = torch.zeros((plan.n_segments + 2, k, k))
    for b, d in zip(buckets, bdev):
        if b.segmap is None:
            continue
        cols, vals, mask = d[1], d[2], d[3]
        ym = opposing[cols] * mask[..., None]
        a = ym.transpose(1, 2) @ ((ym * (cfg.alpha * vals)[..., None])
                                  if implicit else ym)
        seg = torch.as_tensor(b.segmap, dtype=torch.int64)
        acc_a.index_add_(0, seg, a)
        table_a.index_copy_(0, d[4], a)
    (combined,) = als._sum_segments(plan.segments, table_a)
    assert torch.equal(combined, acc_a[:len(split)])
    assert got.shape == (n_i, 4) and torch.isfinite(got).all()


def test_two_trains_with_split_rows_are_bitwise_equal():
    ui, ii, r, n_u, n_i = _data(seed=7, nnz=1500)
    cfg = dataclasses.replace(CFG, solver="gj", iterations=3)
    a = _train(ui, ii, r, n_u, n_i, cfg)
    b = _train(ui, ii, r, n_u, n_i, cfg)
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)


# -- the assert mode -------------------------------------------------------------

@pytest.fixture()
def assert_mode():
    checks.enable(True)
    yield
    checks.enable(False)


def _toy(nan_at=None):
    rng = np.random.default_rng(0)
    ui = rng.integers(0, 40, 500).astype(np.int32)
    ii = rng.integers(0, 30, 500).astype(np.int32)
    r = rng.uniform(1, 5, 500).astype(np.float32)
    if nan_at is not None:
        r[nan_at] = np.nan
    return ui, ii, r


def test_clean_train_passes_checked(assert_mode):
    ui, ii, r = _toy()
    res = _train(ui, ii, r, 40, 30, ALSConfig(rank=4, iterations=2))
    assert np.isfinite(res.user_factors).all()


def test_nan_rating_raises_checked(assert_mode):
    ui, ii, r = _toy(nan_at=7)
    with pytest.raises(checks.CheckFailed, match="non-finite"):
        _train(ui, ii, r, 40, 30, ALSConfig(rank=4, iterations=2))


def test_nan_rating_silent_unchecked():
    ui, ii, r = _toy(nan_at=7)
    res = _train(ui, ii, r, 40, 30, ALSConfig(rank=4, iterations=2))
    assert not np.isfinite(res.user_factors).all()


def test_grid_declines_under_the_assert_mode(assert_mode):
    from predictionio_torch.controller.context import WorkflowContext

    cfgs = [ALSConfig(rank=4, iterations=1, reg=lam) for lam in (0.1, 0.2)]
    ui, ii, r = _toy()
    assert als_grid.grid_dispatch(
        WorkflowContext(device="cpu"), cfgs, ui, ii, r, 40, 30,
        train_one=lambda i: pytest.fail("no singleton here"),
        build_model=lambda i, res: pytest.fail("the grid must decline"),
        log_prefix="test") is None


def test_set_debug_flags_arms_the_mode():
    from predictionio_torch.utils.profiling import set_debug_flags

    for flags in ({"check_asserts": True}, {"nan_check": True}):
        assert not checks.enabled()
        try:
            set_debug_flags(**flags)
            assert checks.enabled()
        finally:
            checks.enable(False)


# -- the console and the workflow ------------------------------------------------

def _write_events(path, n_users=30, n_items=20, n=500, seed=0, bad=None):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for k in range(n):
            # the bad rating comes last: the Preparator keeps a pair's
            # latest rating
            rating = (float(rng.integers(1, 6))
                      if bad is None or k < n - 1 else bad)
            f.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(n_users)}",
                "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(n_items)}",
                "properties": {"rating": rating},
                "eventTime": f"2026-01-01T00:{k // 60 % 60:02d}:"
                             f"{k % 60:02d}Z"}) + "\n")


def _factors(model_path):
    _, (model, _popular) = read_model_file(model_path)
    return model.user_factors, model.item_factors


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    monkeypatch.setenv("PIO_BUCKET_CACHE", "1")
    monkeypatch.delenv("PIO_FAULTS", raising=False)
    Storage.reset(None)
    yield tmp_path
    Storage.reset(None)


def test_console_train_killed_at_an_epoch_boundary_resumes_bitwise(
        basedir, caplog):
    events = basedir / "events.jsonl"
    _write_events(events)
    ckpt = basedir / "ckpt"
    train = ["train", "--engine-json", ENGINE_JSON, "--events", str(events),
             "--device", "cpu", "--checkpoint-dir", str(ckpt),
             "--checkpoint-every", "1"]
    env = dict(os.environ, PYTHONPATH=REPO,
               PIO_FAULTS="als.epoch_boundary:2")
    killed = subprocess.run(
        [sys.executable, "-m", "predictionio_torch.tools.console", *train,
         "--model-out", str(basedir / "killed.pio")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert killed.returncode == 137, killed.stderr[-2000:]
    assert "dying at als.epoch_boundary" in killed.stderr
    assert not (basedir / "killed.pio").exists()
    assert os.listdir(ckpt / "als") == ["step_1"]
    with caplog.at_level(logging.INFO):
        assert console.main(train + ["--model-out",
                                     str(basedir / "resumed.pio")]) == 0
    log = caplog.text
    assert "resumed from checkpoint step 1" in log
    assert "bucket cache hit" in log  # the killed run left the entry
    assert console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                         str(events), "--device", "cpu", "--model-out",
                         str(basedir / "whole.pio")]) == 0
    for got, want in zip(_factors(basedir / "resumed.pio"),
                         _factors(basedir / "whole.pio")):
        np.testing.assert_array_equal(got, want)


def test_metrics_file_one_record_an_epoch_appended(basedir):
    events = basedir / "events.jsonl"
    _write_events(events)
    metrics = basedir / "m" / "metrics.jsonl"
    argv = ["train", "--engine-json", ENGINE_JSON, "--events", str(events),
            "--device", "cpu", "--model-out", str(basedir / "m.pio"),
            "--metrics-file", str(metrics), "--batch", "nightly"]
    assert console.main(argv) == 0
    assert console.main(argv) == 0
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    iterations = 20  # the shipped engine.json's numIterations
    assert len(records) == 2 * iterations
    assert [r["step"] for r in records] == 2 * list(range(1, iterations + 1))
    assert {r["stage"] for r in records} == {"train/als"}
    assert {r["run"] for r in records} == {"nightly"}
    assert all(r["epoch_time_s"] > 0 for r in records)
    instance, _ = read_model_file(basedir / "m.pio")
    assert instance.batch == "nightly"


def test_profile_dir_writes_a_trace(basedir):
    events = basedir / "events.jsonl"
    _write_events(events, n=200)
    profile = basedir / "profile"
    assert console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                         str(events), "--device", "cpu", "--model-out",
                         str(basedir / "p.pio"), "--profile-dir",
                         str(profile)]) == 0
    trace = json.loads((profile / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    # the train's stages are named ranges (the engine.json's two
    # algorithms: als and popular)
    assert {"Engine.train read", "Engine.train prepare", "Engine.train als",
            "Engine.train popular"} <= names


def test_check_asserts_fails_a_bad_rating_and_is_silent_without(basedir,
                                                                capsys):
    """The DataSource drops NaN ratings, so an infinite one reaches the
    train: with --check-asserts it fails with the reference's message,
    without it the train completes on non-finite factors."""
    events = basedir / "events.jsonl"
    _write_events(events, bad=float("inf"))
    argv = ["train", "--engine-json", ENGINE_JSON, "--events", str(events),
            "--device", "cpu", "--model-out", str(basedir / "c.pio")]
    assert console.main(argv + ["--check-asserts"]) == 1
    assert "non-finite factors after solve" in capsys.readouterr().err
    assert not checks.enabled()  # armed for that train only
    assert console.main(argv) == 0
    assert not np.isfinite(_factors(basedir / "c.pio")[0]).all()
    assert console.main(argv + ["--debug-nans"]) == 1


def test_console_run(tmp_path, monkeypatch, capsys):
    (tmp_path / "pio_run_target.py").write_text(
        "def main(args):\n"
        "    print('main', args)\n"
        "    return 3\n"
        "def hello(*args):\n"
        "    print('hello', list(args))\n")
    (tmp_path / "pio_run_nomain.py").write_text("x = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert console.main(["run", "pio_run_target", "a", "--b"]) == 3
    assert "main ['a', '--b']" in capsys.readouterr().out
    assert console.main(["run", "pio_run_target:hello", "x"]) == 0
    assert "hello ['x']" in capsys.readouterr().out
    assert console.main(["run", "pio_run_missing_module"]) == 1
    assert "Cannot import" in capsys.readouterr().err
    assert console.main(["run", "pio_run_target:nope"]) == 1
    assert "has no attribute 'nope'" in capsys.readouterr().err
    assert console.main(["run", "pio_run_nomain"]) == 1
    assert "has no main()" in capsys.readouterr().err


def test_run_fake_workflow_records_completed_and_failed():
    from predictionio_torch.controller.context import WorkflowContext
    from predictionio_torch.storage.registry import (
        SourceConfig,
        StorageConfig,
    )
    from predictionio_torch.workflow.fake import run_fake_workflow

    src = SourceConfig(name="TEST", type="memory")
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    ctx = WorkflowContext(device="cpu", storage=storage, batch="adhoc")
    try:
        assert run_fake_workflow(lambda c: c.batch + "!", ctx) == "adhoc!"

        def boom(c):
            raise ValueError("boom")

        with pytest.raises(ValueError, match="boom"):
            run_fake_workflow(boom, ctx)
        rows = storage.meta_engine_instances().get_all()
        assert sorted(r.status for r in rows) == ["COMPLETED", "FAILED"]
        assert {r.engine_id for r in rows} == {"fake"}
        assert {r.batch for r in rows} == {"adhoc"}
    finally:
        storage.close()
