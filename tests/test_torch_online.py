"""The port's store tailer (`ingest/tailer.py`) and ALS fold-in
(`online/foldin.py`, `online/metrics.py`) on the CPU: the reference's
tests/test_online.py cases (TestStoreTailer, TestFoldInMath,
TestFoldModelProtocol) under solver="chol" and solver="gj" (the plain
kernels), and the port's fold against the reference's on the same model
and histories."""

import inspect
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as RefBiMap
from predictionio_tpu.models.als_model import ALSModel as RefALSModel
from predictionio_tpu.online import fold_model as ref_fold_model
from predictionio_tpu.online import solve_rows as ref_solve_rows
from predictionio_tpu.ops.als import ALSConfig as RefALSConfig
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.ingest.tailer import OVERLAP, StoreTailer
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.online import (
    ALSFold,
    FoldModel,
    SeenOverlay,
    fold_model,
    foldin,
    solve_rows,
)
from predictionio_torch.online.foldin import extend_bimap
from predictionio_torch.online.metrics import (
    ONLINE_COLD_START_ROWS,
    ONLINE_ROWS_FOLDED,
)
from predictionio_torch.ops.als import ALSConfig, _solve_buckets_device
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)

torch.set_num_threads(1)

T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)
SOLVERS = ["chol", "gj"]


@pytest.fixture()
def storage():
    src = SourceConfig(name="TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    yield s
    s.close()


def _event(user, item, t, event="rate", rating=5.0):
    return Event(event=event, entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties=DataMap({"rating": rating}), event_time=t)


class _Recorder(StoreTailer):
    """Streaming-mode consumer that records what it was handed."""

    def __init__(self, storage, **kw):
        super().__init__(storage, **kw)
        self.applied = []

    def _apply(self, e) -> bool:
        self.applied.append(e.target_entity_id)
        return True


# -- the store tailer ---------------------------------------------------------

def test_subclass_inherits_the_tail_machinery(storage):
    for inherited in ("poll_once", "_collect", "_process", "_mark", "start",
                      "stop", "_run"):
        assert getattr(_Recorder, inherited) is getattr(StoreTailer,
                                                        inherited)
    storage.l_events().insert(_event("u1", "i1", T0), 1)
    t = _Recorder(storage, interval_s=0.01)
    t.start()  # the background loop polls until stopped
    try:
        for _ in range(500):  # at most ~5 s
            if t.applied:
                break
            t._stop.wait(0.01)
        assert t.applied == ["i1"]
    finally:
        t.stop()
    assert t._thread is None


def test_streaming_delivery_in_time_order(storage):
    le = storage.l_events()
    le.insert(_event("u1", "i2", T0 + timedelta(seconds=2)), 1)
    le.insert(_event("u1", "i0", T0), 1)
    le.insert(_event("u1", "i1", T0 + timedelta(seconds=1)), 1)
    t = _Recorder(storage)
    assert t.poll_once() == 3
    assert t.applied == ["i0", "i1", "i2"]
    assert t.poll_once() == 0  # dedup: nothing re-applied


def test_overlap_catches_late_arrivals_without_redelivery(storage):
    le = storage.l_events()
    le.insert(_event("u1", "i0", T0), 1)
    t = _Recorder(storage)
    assert t.poll_once() == 1
    late = T0 - OVERLAP + timedelta(seconds=0.5)
    le.insert(_event("u1", "late", late), 1)
    assert t.poll_once() == 1
    assert t.applied == ["i0", "late"]


def test_event_name_filter_and_max_batch(storage):
    le = storage.l_events()
    for i in range(3):
        le.insert(_event("u1", f"i{i}", T0 + timedelta(seconds=i)), 1)
    le.insert(_event("u1", "bought", T0, event="buy"), 1)
    t = _Recorder(storage, event_names=["rate"], max_batch=2)
    assert t.poll_once() == 2
    assert t.poll_once() == 1
    assert t.applied == ["i0", "i1", "i2"]


def test_streaming_is_at_most_once_per_event(storage):
    class _Flaky(_Recorder):
        def _apply(self, e):
            if e.target_entity_id == "i1":
                raise RuntimeError("consumer died mid-batch")
            return super()._apply(e)

    le = storage.l_events()
    for i in range(3):
        le.insert(_event("u1", f"i{i}", T0 + timedelta(seconds=i)), 1)
    t = _Flaky(storage)
    with pytest.raises(RuntimeError, match="mid-batch"):
        t.poll_once()
    assert t.poll_once() == 1
    assert t.applied == ["i0", "i2"]


def test_batch_mode_replays_the_whole_batch_after_a_crash(storage):
    class _Batcher(StoreTailer):
        def __init__(self, storage, **kw):
            super().__init__(storage, **kw)
            self.batches = []
            self.crash_next = False

        def _process(self, fresh):
            if fresh and self.crash_next:
                self.crash_next = False
                raise RuntimeError("died before the watermark")
            self.batches.append([e.target_entity_id for e in fresh])
            for e in fresh:
                self._mark(e)
            return len(fresh)

    le = storage.l_events()
    for i in range(3):
        le.insert(_event("u1", f"i{i}", T0 + timedelta(seconds=i)), 1)
    t = _Batcher(storage)
    t.crash_next = True
    with pytest.raises(RuntimeError, match="watermark"):
        t.poll_once()
    assert t.batches == []
    assert t.poll_once() == 3
    assert t.batches == [["i0", "i1", "i2"]]
    assert t.poll_once() == 0


# -- fold-in math -------------------------------------------------------------

def _cfg(solver):
    # rank-4 explicit config with the solver pinned, so auto-resolution
    # can never change the parity reference under the bitwise asserts
    return ALSConfig(rank=4, reg=0.1, solver=solver)


def _entries(rng, n_rows=8, n_opposing=8, nnz=4):
    # every row gets the SAME nnz so single-row and batched solves land in
    # identically shaped buckets (the tier ladder pads a lone row to the
    # same [8, cap] bucket as 8 rows of one cap)
    out = []
    for _ in range(n_rows):
        cols = np.sort(rng.choice(n_opposing, size=nnz,
                                  replace=False)).astype(np.int32)
        vals = (1.0 + 4.0 * rng.random(nnz)).astype(np.float32)
        out.append((cols, vals))
    return out


def _model(rng):
    return ALSModel(
        user_factors=rng.standard_normal((5, 4)).astype(np.float32),
        item_factors=rng.standard_normal((6, 4)).astype(np.float32),
        user_ids=BiMap.string_int([f"u{i}" for i in range(5)]),
        item_ids=BiMap.string_int([f"i{i}" for i in range(6)]),
        seen={0: np.asarray([1, 2], np.int32)}, device="cpu")


@pytest.mark.parametrize("solver", SOLVERS)
def test_single_row_fold_bitwise_matches_the_batched_half_epoch(solver):
    rng = np.random.default_rng(7)
    opposing = rng.standard_normal((8, 4)).astype(np.float32)
    entries = _entries(rng)
    full = solve_rows(opposing, entries, _cfg(solver), device="cpu")
    assert full.shape == (8, 4)
    for u in range(8):
        single = solve_rows(opposing, [entries[u]], _cfg(solver),
                            device="cpu")
        assert torch.equal(single[0], full[u]), u
    # ... and equal to one plain half-epoch over the same bucket
    bucket, target = foldin.fold_bucket(entries, 4, 1.5)
    assert target == 8 and bucket.cols.shape == (8, 8)
    whole = _solve_buckets_device(
        torch.as_tensor(opposing), 8, [tuple(torch.as_tensor(a) for a in (
            bucket.rows.astype(np.int64), bucket.cols.astype(np.int64),
            bucket.vals, bucket.mask)) + (None,)], _cfg(solver))
    assert torch.equal(whole, full)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fold_solves_the_weighted_normal_equations(solver):
    rng = np.random.default_rng(11)
    opposing = rng.standard_normal((8, 4)).astype(np.float32)
    entries = _entries(rng)
    solved = solve_rows(opposing, entries, _cfg(solver), device="cpu")
    for (cols, vals), x in zip(entries, solved.numpy()):
        yc = opposing[cols].astype(np.float64)
        a = yc.T @ yc + 0.1 * len(cols) * np.eye(4)
        ref = np.linalg.solve(a, yc.T @ vals.astype(np.float64))
        np.testing.assert_allclose(x, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("solver", SOLVERS)
def test_empty_history_rows_solve_to_zeros(solver):
    rng = np.random.default_rng(3)
    opposing = rng.standard_normal((8, 4)).astype(np.float32)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    solved = solve_rows(opposing, [*_entries(rng, n_rows=2), empty],
                        _cfg(solver), device="cpu").numpy()
    assert np.array_equal(solved[2], np.zeros(4, np.float32))
    assert solved[:2].any(axis=1).all()
    assert solve_rows(opposing, [], _cfg(solver),
                      device="cpu").shape == (0, 4)


@pytest.mark.parametrize("n,target", [(1, 8), (8, 8), (9, 32), (32, 32),
                                      (33, 128), (128, 128)])
def test_fold_bucket_row_tiers(n, target):
    """The row ladder {8, 32, 128}: one bucket row per entry, scratch rows
    (id n) up to the tier, capacity on the power-of-4 ladder."""
    entries = [(np.arange(1 + i % 11, dtype=np.int32),
                np.ones(1 + i % 11, np.float32)) for i in range(n)]
    bucket, got = foldin.fold_bucket(entries, 4, 1.5)
    assert got == target
    assert bucket.rows.shape == (target,)
    assert sorted(bucket.rows[:n].tolist()) == list(range(n))
    assert (bucket.rows[n:] == n).all() and not bucket.mask[n:].any()
    assert bucket.cols.shape[1] == (8 if n <= 8 else 32)


@pytest.mark.parametrize("solver", SOLVERS)
def test_backlog_chunks_equal_each_chunk_folded_alone(solver):
    """300 rows fold in chunks of MAX_ROWS_PER_SOLVE (128, 128, 44): the
    result equals each chunk folded on its own."""
    rng = np.random.default_rng(19)
    opposing = rng.standard_normal((40, 4)).astype(np.float32)
    entries = _entries(rng, n_rows=300, n_opposing=40, nnz=6)
    whole = solve_rows(opposing, entries, _cfg(solver), device="cpu")
    for lo in (0, 128, 256):
        part = solve_rows(opposing, entries[lo:lo + 128], _cfg(solver),
                          device="cpu")
        assert torch.equal(whole[lo:lo + 128], part)


@pytest.mark.parametrize("solver", SOLVERS)
def test_cold_start_appends_rows_without_disturbing_existing(solver):
    rng = np.random.default_rng(5)
    model = _model(rng)
    users_before = ONLINE_COLD_START_ROWS.labels(side="user").value
    folded_before = ONLINE_ROWS_FOLDED.labels(side="user").value
    folded, stats = fold_model(
        model, _cfg(solver), {"newu": [("i1", 5.0), ("newi", 3.0)]})
    assert (stats.new_users, stats.new_items) == (1, 1)
    assert (stats.folded_users, stats.folded_items) == (1, 0)
    assert ONLINE_COLD_START_ROWS.labels(side="user").value == users_before + 1
    assert ONLINE_ROWS_FOLDED.labels(side="user").value == folded_before + 1
    assert folded.user_ids["newu"] == 5
    assert folded.item_ids["newi"] == 6
    uf, itf = folded.user_factors, folded.item_factors
    assert isinstance(uf, np.ndarray)  # host in, host out
    assert np.array_equal(uf[:5], model.user_factors)
    assert np.array_equal(itf[:6], model.item_factors)
    assert uf[5].any()
    assert np.array_equal(itf[6], np.zeros(4, np.float32))
    assert set(folded.seen.get(5)) == {1, 6}
    assert np.array_equal(folded.seen.get(0), np.asarray([1, 2], np.int32))
    assert model.user_ids.get("newu") is None
    assert model.user_factors.shape == (5, 4)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fold_is_bitwise_idempotent_against_fixed_opposing(solver):
    rng = np.random.default_rng(13)
    model = _model(rng)
    before = model.user_factors.copy()
    hist = {"u1": [("i0", 4.0), ("i3", 2.0)], "u4": [("i5", 5.0)]}
    once, _ = fold_model(model, _cfg(solver), hist)
    twice, _ = fold_model(once, _cfg(solver), hist)
    assert np.array_equal(once.user_factors, twice.user_factors)
    assert np.array_equal(once.item_factors, twice.item_factors)
    # untouched rows bitwise unchanged, the input never mutated
    untouched = [0, 2, 3]
    assert np.array_equal(once.user_factors[untouched], before[untouched])
    assert np.array_equal(model.user_factors, before)


@pytest.mark.parametrize("solver", SOLVERS)
def test_tensor_factors_fold_where_they_lie(solver):
    """Device-resident factors (a grid model, a folded one) fold on their
    own device and come back as tensors there, equal to the host fold."""
    rng = np.random.default_rng(23)
    host = _model(rng)
    dev = ALSModel(user_factors=torch.from_numpy(host.user_factors.copy()),
                   item_factors=torch.from_numpy(host.item_factors.copy()),
                   user_ids=host.user_ids, item_ids=host.item_ids,
                   seen=host.seen, device=None)
    hist = {"u2": [("i0", 4.0), ("i5", 1.0)], "new": [("i1", 2.0)]}
    items = {"i3": [("u0", 3.0), ("u2", 5.0)]}
    a, _ = fold_model(host, _cfg(solver), hist, items)
    b, _ = fold_model(dev, _cfg(solver), hist, items)
    assert isinstance(b.user_factors, torch.Tensor)
    assert np.array_equal(a.user_factors, b.user_factors.numpy())
    assert np.array_equal(a.item_factors, b.item_factors.numpy())
    assert torch.equal(dev.user_factors, torch.from_numpy(host.user_factors))


def test_seen_overlay_flattens_and_layers():
    base = {0: np.asarray([1], np.int32)}
    one = SeenOverlay(base, {1: np.asarray([2], np.int32)})
    two = SeenOverlay(one, {0: np.asarray([9], np.int32)})
    assert two._base is base
    assert np.array_equal(two.get(0), [9])
    assert np.array_equal(two.get(1), [2])
    assert two.get(7) is None
    assert bool(SeenOverlay(None, {}))


def test_extend_bimap_appends_and_preserves():
    bm = BiMap.string_int(["a", "b"])
    grown, added = extend_bimap(bm, ["b", "c", "d"])
    assert added == ["c", "d"]
    assert (grown["a"], grown["b"], grown["c"], grown["d"]) == (0, 1, 2, 3)
    same, none_added = extend_bimap(grown, ["a", "d"])
    assert same is grown and none_added == []


def test_folded_user_recommendations_exclude_what_it_rated():
    rng = np.random.default_rng(29)
    model = _model(rng)
    folded, _ = fold_model(model, _cfg("chol"),
                           {"u3": [("i0", 5.0), ("i4", 4.0)]})
    recs = [i for i, _ in folded.recommend_products("u3", 6)]
    assert recs and not {"i0", "i4"} & set(recs)
    assert len(recs) == 4


def test_fold_without_a_device_raises(monkeypatch):
    """No quiet fallback: a host model whose device resolves to CUDA
    raises on a machine without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    model = _model(np.random.default_rng(1))
    model.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        fold_model(model, _cfg("chol"), {"u1": [("i0", 1.0)]})


# -- the FoldModel protocol ---------------------------------------------------

def test_alsfold_is_a_thin_adapter():
    assert issubclass(ALSFold, FoldModel)
    assert ALSFold.family == "als"
    assert "fold_model" in inspect.getsource(ALSFold.fold)


@pytest.mark.parametrize("solver", SOLVERS)
def test_alsfold_fold_is_bit_identical_to_fold_model(solver):
    rng = np.random.default_rng(17)
    model = _model(rng)
    user_pairs = {"u1": [("i0", 4.0), ("i3", 2.0)],
                  "newu": [("i5", 5.0), ("newi", 3.0)]}
    item_pairs = {"i0": [("u1", 4.0), ("u2", 1.0)]}

    def timed(hists):
        return {k: [(o, v, T0 + timedelta(seconds=j))
                    for j, (o, v) in enumerate(pairs)]
                for k, pairs in hists.items()}

    via_handle, st1 = ALSFold(_cfg(solver)).fold(
        model, timed(user_pairs), timed(item_pairs))
    direct, st2 = fold_model(model, _cfg(solver), user_pairs, item_pairs)
    assert np.array_equal(via_handle.user_factors, direct.user_factors)
    assert np.array_equal(via_handle.item_factors, direct.item_factors)
    assert via_handle.user_ids.to_dict() == direct.user_ids.to_dict()
    assert via_handle.item_ids.to_dict() == direct.item_ids.to_dict()
    assert (st1.folded_users, st1.folded_items, st1.new_users,
            st1.new_items) == (st2.folded_users, st2.folded_items,
                               st2.new_users, st2.new_items)


# -- against the reference ----------------------------------------------------

def _ref_cfg(solver, rank, reg):
    # the reference's gj runs its Pallas kernel in interpret mode on CPU
    return RefALSConfig(rank=rank, reg=reg, solver=solver,
                        pallas="interpret" if solver == "gj" else "auto")


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_rows_matches_the_reference(solver):
    rng = np.random.default_rng(31)
    opposing = rng.standard_normal((30, 6)).astype(np.float32)
    entries = _entries(rng, n_rows=20, n_opposing=30, nnz=9)
    got = solve_rows(opposing, entries, ALSConfig(rank=6, reg=0.05,
                                                  solver=solver),
                     device="cpu").numpy()
    want = ref_solve_rows(opposing, entries, _ref_cfg(solver, 6, 0.05))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fold_model_matches_the_reference(solver):
    """The same model and histories through both packages' fold_model:
    folded rows within the ALS bar (rtol 2e-3), cold-start ids and codes
    identical, untouched rows equal."""
    rng = np.random.default_rng(37)
    n_users, n_items, k = 25, 18, 5
    uf = rng.standard_normal((n_users, k)).astype(np.float32)
    itf = rng.standard_normal((n_items, k)).astype(np.float32)
    users = [f"u{i}" for i in range(n_users)]
    items = [f"i{i}" for i in range(n_items)]
    user_hist = {}
    for u in [*rng.choice(users, 7, replace=False), "cold1", "cold2"]:
        picks = rng.choice([*items, "newA", "newB"], 6, replace=False)
        user_hist[str(u)] = [(str(i), float(rng.integers(1, 6)))
                             for i in picks]
    item_hist = {"i3": [("u1", 4.0), ("cold1", 2.0), ("u7", 5.0)],
                 "newA": [("u2", 3.0)]}
    port = ALSModel(user_factors=uf, item_factors=itf,
                    user_ids=BiMap.string_int(users),
                    item_ids=BiMap.string_int(items), device="cpu")
    ref = RefALSModel(user_factors=uf, item_factors=itf,
                      user_ids=RefBiMap.string_int(users),
                      item_ids=RefBiMap.string_int(items))
    got, got_stats = fold_model(port, ALSConfig(rank=k, reg=0.05,
                                                solver=solver),
                                user_hist, item_hist)
    want, want_stats = ref_fold_model(ref, _ref_cfg(solver, k, 0.05),
                                      user_hist, item_hist)
    assert got.user_ids.to_dict() == want.user_ids.to_dict()
    assert got.item_ids.to_dict() == want.item_ids.to_dict()
    assert (got_stats.new_users, got_stats.new_items,
            got_stats.folded_users, got_stats.folded_items) == \
        (want_stats.new_users, want_stats.new_items,
         want_stats.folded_users, want_stats.folded_items)
    np.testing.assert_allclose(got.user_factors,
                               np.asarray(want.user_factors),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got.item_factors,
                               np.asarray(want.item_factors),
                               rtol=2e-3, atol=1e-5)
    folded_rows = {got.user_ids[u] for u in user_hist}
    for row in range(n_users):
        if row not in folded_rows:
            assert np.array_equal(got.user_factors[row], uf[row])


def test_metrics_registry_renders_as_the_reference():
    """The port's registry copy renders the same Prometheus text as the
    reference's for the same counter, gauge and histogram updates."""
    from predictionio_tpu.telemetry.registry import (
        MetricsRegistry as RefRegistry,
    )
    from predictionio_torch.telemetry.registry import (
        REGISTRY,
        MetricsRegistry,
    )

    texts = []
    for reg in (MetricsRegistry(), RefRegistry()):
        c = reg.counter("rows_total", "Rows, by side", ("side",))
        c.labels(side="user").inc(3)
        c.labels(side="item").inc()
        g = reg.gauge("lag_seconds", "Lag\nin seconds")
        g.set(2.5)
        g.dec(0.5)
        h = reg.histogram("fold_seconds", "Fold wall", buckets=(0.01, 0.1))
        for v in (0.005, 0.05, 0.5):
            h.observe(v)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert "online_rows_folded_total" in REGISTRY.render()
