"""Checkpoint/resume in the port (`predictionio_torch/workflow/checkpoint.py`,
`ops/als.py::als_train`'s `checkpoint_dir`, `workflow/segmented.py`, the
engine's checkpoint scopes) on the CPU: the reference's own cases
(tests/test_checkpoint.py, the template cases of
tests/test_similarproduct_template.py and test_ecommerce_template.py),
written for the port, and the port against the reference on the same
numpy inputs: the on-disk format both ways, `_ckpt_suffixes`,
`segmented_train` through the same injected faults, and a resumed ALS
trajectory within the ALS bar (rtol 2e-3). Within the port, chunked ≡
single ≡ resumed training holds bitwise, split rows included."""

import dataclasses
import hashlib
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.ops import spd_solve
from predictionio_torch.ops.als import ALSConfig, als_train
from predictionio_torch.utils import faults
from predictionio_torch.workflow import checkpoint as port_ckpt
from predictionio_torch.workflow.checkpoint import CheckpointManager
from predictionio_torch.workflow.segmented import (
    fingerprint_of,
    segmented_train,
)

torch.set_num_threads(1)

N_U, N_I = 30, 20


def _data(seed, nnz=420):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_U, nnz).astype(np.int32),
            rng.integers(0, N_I, nnz).astype(np.int32),
            rng.uniform(1, 5, nnz).astype(np.float32))


def _train(data, cfg, **kw):
    ui, ii, r = data
    return als_train(ui, ii, r, N_U, N_I, cfg, device="cpu", **kw)


def _cfg(iterations, **kw):
    return ALSConfig(rank=4, iterations=iterations, reg=0.05, seed=7, **kw)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    np.testing.assert_array_equal(got.item_factors, want.item_factors)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


def _arm(monkeypatch, spec):
    """PIO_FAULTS = spec with fresh hit counts in both packages."""
    from predictionio_tpu.utils import faults as ref_faults

    monkeypatch.setenv("PIO_FAULTS", "")
    faults._parse()
    ref_faults._parse()
    monkeypatch.setenv("PIO_FAULTS", spec)


# -- CheckpointManager ---------------------------------------------------------

class TestCheckpointManager:
    def test_round_trip_nested_tree(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        tree = {"factors": {"user": np.arange(6, dtype=np.float32).reshape(2, 3),
                            "item": np.ones((3, 3))},
                "history": [np.float32(1.5), np.float32(0.7)],
                "step_count": np.int64(2)}
        cm.save(2, tree, metadata={"note": "hello"})
        restored, meta = cm.restore()
        assert meta["note"] == "hello"
        np.testing.assert_array_equal(restored["factors"]["user"],
                                      tree["factors"]["user"])
        np.testing.assert_array_equal(restored["factors"]["item"],
                                      tree["factors"]["item"])
        assert [float(x) for x in restored["history"]] == [1.5,
                                                           np.float32(0.7)]
        assert int(restored["step_count"]) == 2

    def test_latest_and_gc(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        for step in (1, 2, 3, 4):
            cm.save(step, {"x": np.full((2,), step, dtype=np.float32)})
        assert cm.latest_step() == 4
        assert cm.all_steps() == [3, 4]
        restored, _ = cm.restore(3)
        assert restored["x"][0] == 3.0

    def test_restore_empty_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore()

    def test_tuple_and_scalar_leaves(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"t": (np.zeros(2), np.ones(2)), "s": 3.5})
        restored, _ = cm.restore(1)
        assert isinstance(restored["t"], tuple)
        np.testing.assert_array_equal(restored["t"][1], np.ones(2))
        assert float(restored["s"]) == 3.5

    def test_keep_only(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=5)
        for step in (1, 2, 3):
            cm.save(step, {"x": np.zeros(1)})
        cm.keep_only(2)
        assert cm.all_steps() == [2]
        cm.keep_only(None)
        assert cm.all_steps() == []

    def test_crash_before_publish_keeps_the_old_step(self, tmp_path,
                                                     monkeypatch):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"x": np.zeros(2)})
        _arm(monkeypatch, "checkpoint.pre_replace=error")
        with pytest.raises(faults.FaultInjected):
            cm.save(1, {"x": np.ones(2)})
        # renamed aside, never published: a new manager salvages it
        assert not os.path.exists(tmp_path / "step_1")
        assert os.path.exists(tmp_path / "step_1.old")
        _arm(monkeypatch, "")
        again = CheckpointManager(str(tmp_path))
        np.testing.assert_array_equal(again.restore(1)[0]["x"], np.zeros(2))
        assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))

    def test_counters(self, tmp_path):
        saves = port_ckpt.CKPT_SAVES.value
        restores = port_ckpt.CKPT_RESTORES.value
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"x": np.zeros(1)})
        cm.restore(1)
        assert port_ckpt.CKPT_SAVES.value == saves + 1
        assert port_ckpt.CKPT_RESTORES.value == restores + 1

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_format_restores_across_packages(self, tmp_path, writer):
        """A step written by either package restores in the other with
        equal arrays, structure and metadata."""
        from predictionio_tpu.workflow.checkpoint import (
            CheckpointManager as RefManager,
        )

        rng = np.random.default_rng(4)
        tree = {"user_factors": rng.standard_normal((5, 3)).astype(np.float32),
                "item_factors": rng.standard_normal((4, 3)).astype(np.float32),
                "nested": {"t": (np.arange(3), np.float64(2.5))},
                "list": [np.int32(1), np.zeros((2, 2), np.float16)]}
        meta = {"rmse_history": [1.25, 0.5], "fingerprint": "abc",
                "iterations": 6}
        save_cls, load_cls = ((CheckpointManager, RefManager)
                              if writer == "port" else
                              (RefManager, CheckpointManager))
        save_cls(str(tmp_path)).save(3, tree, metadata=meta)
        got, got_meta = load_cls(str(tmp_path)).restore()
        assert got_meta == meta
        assert sorted(got) == sorted(tree)
        for key in ("user_factors", "item_factors"):
            np.testing.assert_array_equal(got[key], tree[key])
            assert got[key].dtype == tree[key].dtype
        assert isinstance(got["nested"]["t"], tuple)
        np.testing.assert_array_equal(got["nested"]["t"][0], np.arange(3))
        assert float(got["nested"]["t"][1]) == 2.5
        assert isinstance(got["list"], list)
        assert got["list"][1].dtype == np.float16


# -- ALS checkpoint/resume -------------------------------------------------------

class TestALSCheckpointResume:
    @pytest.mark.parametrize("split_cap", [32768, 16])
    @pytest.mark.parametrize("every", [1, 2])
    def test_chunked_single_and_resumed_are_bitwise_equal(
            self, tmp_path, split_cap, every):
        data = _data(3)
        cfg = _cfg(5, split_cap=split_cap)
        single = _train(data, cfg, compute_rmse=True)
        chunked = _train(data, cfg, compute_rmse=True,
                         checkpoint_dir=str(tmp_path / "c"),
                         checkpoint_every=every)
        _assert_bitwise(chunked, single)
        assert chunked.rmse_history == single.rmse_history
        # an interrupted run (3 of 5 epochs), then the full one resumed
        _train(data, dataclasses.replace(cfg, iterations=3),
               compute_rmse=True, checkpoint_dir=str(tmp_path / "r"),
               checkpoint_every=every)
        resumed = _train(data, cfg, compute_rmse=True,
                         checkpoint_dir=str(tmp_path / "r"),
                         checkpoint_every=every)
        assert resumed.start_epoch == 3
        _assert_bitwise(resumed, single)
        assert resumed.rmse_history == single.rmse_history
        if split_cap == 16:  # the case must hold split rows
            from predictionio_torch.ops.als import bucket_ragged_split

            assert len(bucket_ragged_split(data[1], data[0], data[2], N_I, 8,
                                           split_cap)[1]) > 0

    def test_killed_at_the_fault_site_resumes_bitwise(self, tmp_path,
                                                      monkeypatch):
        data = _data(4)
        cfg = _cfg(6, split_cap=16)
        want = _train(data, cfg)
        _arm(monkeypatch, "als.epoch_boundary:4=error")
        with pytest.raises(faults.FaultInjected):
            _train(data, cfg, checkpoint_dir=str(tmp_path))
        # the 4th chunk was computed, never saved
        assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2, 3]
        _arm(monkeypatch, "")
        got = _train(data, cfg, checkpoint_dir=str(tmp_path))
        assert got.start_epoch == 3 and len(got.epoch_times) == 3
        _assert_bitwise(got, want)
        assert CheckpointManager(str(tmp_path)).all_steps() == [4, 5, 6]

    def test_resume_rmse_history_concatenates(self, tmp_path):
        data = _data(5)
        _train(data, _cfg(2), checkpoint_dir=str(tmp_path),
               compute_rmse=True)
        resumed = _train(data, _cfg(5), checkpoint_dir=str(tmp_path),
                         compute_rmse=True)
        assert len(resumed.rmse_history) == 5
        assert resumed.rmse_history[-1] <= resumed.rmse_history[0] + 1e-6

    def test_missing_rmse_prefix_is_nan(self, tmp_path):
        data = _data(5)
        _train(data, _cfg(2), checkpoint_dir=str(tmp_path))
        resumed = _train(data, _cfg(4), checkpoint_dir=str(tmp_path),
                         compute_rmse=True)
        assert len(resumed.rmse_history) == 4
        assert all(np.isnan(resumed.rmse_history[:2]))
        assert np.isfinite(resumed.rmse_history[2:]).all()

    def test_changed_data_retrains_from_scratch(self, tmp_path, caplog):
        data = _data(8)
        cfg = _cfg(2)
        stale = _train(data, cfg, checkpoint_dir=str(tmp_path))
        r2 = data[2].copy()
        r2[0] += 2.0
        with caplog.at_level(logging.WARNING, "predictionio_torch.ops.als"):
            fresh = _train((data[0], data[1], r2), cfg,
                           checkpoint_dir=str(tmp_path))
        assert any("different data/config" in m for m in caplog.messages)
        _assert_bitwise(fresh, _train((data[0], data[1], r2), cfg))
        assert not np.allclose(fresh.user_factors, stale.user_factors)
        assert len(fresh.epoch_times) == 2 and fresh.start_epoch == 0

    def test_fully_resumed_run_trains_nothing(self, tmp_path):
        data = _data(9)
        first = _train(data, _cfg(2), checkpoint_dir=str(tmp_path))
        again = _train(data, _cfg(2), checkpoint_dir=str(tmp_path))
        _assert_bitwise(again, first)
        assert again.epoch_times == [] and again.start_epoch == 2

    def test_checkpoint_every_zero_acts_as_one(self, tmp_path):
        out = _train(_data(10), _cfg(3), checkpoint_dir=str(tmp_path),
                     checkpoint_every=0)
        assert np.isfinite(out.user_factors).all()
        assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2, 3]

    def test_stale_higher_steps_purged_on_data_change(self, tmp_path):
        data = _data(11)
        _train(data, _cfg(6), checkpoint_dir=str(tmp_path))
        r2 = data[2].copy()
        r2[0] += 1.0
        changed = (data[0], data[1], r2)
        _train(changed, _cfg(3), checkpoint_dir=str(tmp_path))
        assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2, 3]
        assert _train(changed, _cfg(3),
                      checkpoint_dir=str(tmp_path)).epoch_times == []

    def test_fully_resumed_run_purges_stale_steps(self, tmp_path):
        """A run resumed at its end saves nothing; the steps that are not
        its restore point (another run's among them) still go."""
        data = _data(11)
        d = str(tmp_path)
        _train(data, _cfg(3), checkpoint_dir=d)
        cm = CheckpointManager(d)
        tree, meta = cm.restore(3)
        CheckpointManager(d, keep=5).save(
            5, tree, metadata=dict(meta, fingerprint="another run's"))
        assert cm.all_steps() == [1, 2, 3, 5]
        out = _train(data, _cfg(3), checkpoint_dir=d)
        assert out.start_epoch == 3 and out.epoch_times == []
        assert cm.all_steps() == [3]

    def test_fewer_iterations_than_checkpoint_retrains_to_target(
            self, tmp_path):
        data = _data(12)
        _train(data, _cfg(6), checkpoint_dir=str(tmp_path),
               checkpoint_every=2)
        shorter = _train(data, _cfg(3), checkpoint_dir=str(tmp_path),
                         checkpoint_every=2)
        _assert_bitwise(shorter, _train(data, _cfg(3)))

    def test_resumed_metric_steps_continue_numbering(self, tmp_path):
        data = _data(13)
        _train(data, _cfg(2), checkpoint_dir=str(tmp_path))
        resumed = _train(data, _cfg(5), checkpoint_dir=str(tmp_path))
        assert resumed.start_epoch == 2 and len(resumed.epoch_times) == 3

    def test_mismatched_shapes_ignored(self, tmp_path):
        data = _data(6)
        _train(data, ALSConfig(rank=4, iterations=1, seed=2),
               checkpoint_dir=str(tmp_path))
        out = _train(data, ALSConfig(rank=6, iterations=2, seed=2),
                     checkpoint_dir=str(tmp_path))
        assert out.user_factors.shape == (N_U, 6) and out.start_epoch == 0

    def test_resume_false_trains_from_scratch(self, tmp_path):
        data = _data(7)
        _train(data, _cfg(2), checkpoint_dir=str(tmp_path))
        out = _train(data, _cfg(2), checkpoint_dir=str(tmp_path),
                     resume=False)
        assert out.start_epoch == 0 and len(out.epoch_times) == 2

    def test_resumed_trajectory_within_the_als_bar_of_the_reference(
            self, tmp_path):
        """The reference resumed (3 of 6 epochs, then 6) and the port
        resumed the same way from the reference's initial item factors:
        RMSE histories within rtol 2e-3 (ROADMAP, Parity)."""
        from predictionio_tpu.ops import als as ref_als
        from predictionio_tpu.ops.als import ALSConfig as RefConfig
        from predictionio_tpu.parallel.mesh import make_mesh

        ui, ii, r = _data(14)
        mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
        ref_dir = str(tmp_path / "ref")
        for iters in (3, 6):
            ref = ref_als.als_train(
                ui, ii, r, N_U, N_I,
                RefConfig(rank=4, iterations=iters, reg=0.05, seed=7,
                          solver="chol"),
                mesh=mesh, compute_rmse=True, checkpoint_dir=ref_dir)
        init = np.asarray(jax.random.normal(
            jax.random.key(7), (N_I, 4), dtype=jnp.float32) / np.sqrt(4))
        port_dir = str(tmp_path / "port")
        for iters in (3, 6):
            port = _train((ui, ii, r), _cfg(iters), compute_rmse=True,
                          checkpoint_dir=port_dir, init_item_factors=init)
        assert ref.start_epoch == port.start_epoch == 3
        assert len(port.rmse_history) == 6
        np.testing.assert_allclose(port.rmse_history, ref.rmse_history,
                                   rtol=2e-3)


# -- the workflow's wiring ----------------------------------------------------

class _Tagged:
    checkpoint_tags = ("als",)


class _AlsVariant:
    checkpoint_tags = ("als",)


class _TwoTags:
    checkpoint_tags = ("w2v", "w2v-head")


class _HeadOnly:
    checkpoint_tags = ("w2v-head",)


class _Untagged:
    checkpoint_tags = ()


class _OtherUntagged:
    pass


@pytest.mark.parametrize("classes", [
    [_Tagged, _Tagged],
    [_Tagged, _AlsVariant, _Tagged],
    [_Untagged, _Untagged, _OtherUntagged, _Untagged],
    [_TwoTags, _HeadOnly, _TwoTags, _Tagged],
    [_HeadOnly, _TwoTags, _Untagged, _AlsVariant, _OtherUntagged],
    [_Tagged],
])
def test_ckpt_suffixes_match_the_reference(classes):
    from predictionio_tpu.controller.engine import _ckpt_suffixes as ref
    from predictionio_torch.controller.engine import _ckpt_suffixes

    algos = [(f"a{n}", cls()) for n, cls in enumerate(classes)]
    assert _ckpt_suffixes(algos) == ref(algos)


class TestWorkflowCheckpointWiring:
    def test_context_algorithm_dir_and_scope(self, tmp_path):
        ctx = WorkflowContext(device="cpu", checkpoint_dir=str(tmp_path))
        assert ctx.algorithm_checkpoint_dir("als") == str(tmp_path / "als")
        with ctx.algo_checkpoint_scope(".1"):
            assert ctx.algorithm_checkpoint_dir("als") == str(
                tmp_path / "als.1")
        assert ctx.algorithm_checkpoint_dir("als").endswith("als")
        assert WorkflowContext(device="cpu").algorithm_checkpoint_dir(
            "als") is None
        assert ctx.checkpoint_every is None
        assert WorkflowContext(device="cpu", checkpoint_every=4
                               ).checkpoint_every == 4

    def test_algorithm_cache_dir(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        monkeypatch.setenv("PIO_BUCKET_CACHE", "1")
        ctx = WorkflowContext(device="cpu")
        assert ctx.algorithm_cache_dir("als") == str(tmp_path / "cache" /
                                                     "als")
        monkeypatch.setenv("PIO_BUCKET_CACHE", "0")
        assert ctx.algorithm_cache_dir("als") is None

    def test_engine_trains_duplicates_in_their_own_scopes(self, tmp_path):
        from predictionio_torch.controller import (
            Algorithm,
            DataSource,
            Engine,
        )
        from predictionio_torch.controller.engine import EngineParams

        seen = []

        class Source(DataSource):
            def read_training(self, ctx):
                return [1]

        class Als(Algorithm):
            checkpoint_tags = ("als",)

            def train(self, ctx, pd):
                seen.append(ctx.algorithm_checkpoint_dir("als"))
                return len(seen)

            def predict(self, model, query):
                return model

        engine = Engine(Source, None, {"a": Als, "b": Als})
        ctx = WorkflowContext(device="cpu", checkpoint_dir=str(tmp_path))
        ep = EngineParams(algorithm_params_list=[("a", None), ("b", None),
                                                 ("a", None)])
        assert engine.train(ctx, ep) == [1, 2, 3]
        assert seen == [str(tmp_path / d) for d in ("als", "als.1",
                                                    "als.2")]
        assert ctx.algo_ckpt_suffix == ""


# -- segmented_train -------------------------------------------------------------

def _toy(fingerprint="toyfp"):
    """A hash-chain trainer: any skipped, repeated or reordered step
    changes the final state."""
    def run_chunk(state, n_steps, done):
        metrics = []
        for k in range(n_steps):
            state = hashlib.blake2b(state + str(done + k).encode(),
                                    digest_size=16).digest()
            metrics.append(float(state[0]))
        return state, metrics

    return dict(init_state=lambda: b"genesis", run_chunk=run_chunk,
                state_to_host=lambda s: {"state": np.frombuffer(s, np.uint8)},
                state_from_host=lambda t: t["state"].tobytes(),
                fingerprint=fingerprint)


def test_segmented_random_interruptions_resume_to_identity(tmp_path):
    rng = np.random.default_rng(42)
    for trial in range(25):
        total = int(rng.integers(1, 13))
        every = int(rng.integers(1, total + 3))
        partial = int(rng.integers(0, total + 1))
        ckpt = str(tmp_path / f"t{trial}")
        want, want_hist, _ = segmented_train(total_steps=total, **_toy())
        if partial:
            segmented_train(total_steps=partial, checkpoint_dir=ckpt,
                            checkpoint_every=every, **_toy())
        got, hist, start = segmented_train(
            total_steps=total, checkpoint_dir=ckpt, checkpoint_every=every,
            **_toy())
        label = f"trial {trial}: {total}/{every}/{partial} from {start}"
        assert got == want and hist == want_hist, label
        again, hist2, start2 = segmented_train(
            total_steps=total, checkpoint_dir=ckpt, checkpoint_every=every,
            **_toy())
        assert again == want and start2 == total and hist2 == want_hist, label


def test_segmented_fingerprint_change_restarts(tmp_path):
    segmented_train(total_steps=6, checkpoint_dir=str(tmp_path),
                    checkpoint_every=2, **_toy("fpA"))
    want, _, _ = segmented_train(total_steps=6, **_toy("fpB"))
    got, hist, start = segmented_train(
        total_steps=6, checkpoint_dir=str(tmp_path), checkpoint_every=2,
        **_toy("fpB"))
    assert got == want and start == 0 and len(hist) == 6


def test_segmented_unusable_state_trains_from_scratch(tmp_path, caplog):
    toy = _toy()
    segmented_train(total_steps=4, checkpoint_dir=str(tmp_path), **toy)

    def refuse(tree):
        raise ValueError("foreign tree")

    with caplog.at_level(logging.WARNING):
        _, hist, start = segmented_train(
            total_steps=4, checkpoint_dir=str(tmp_path),
            **dict(toy, state_from_host=refuse))
    assert start == 0 and len(hist) == 4
    assert any("unusable" in m for m in caplog.messages)


def test_fingerprint_of_matches_the_reference():
    from predictionio_tpu.workflow.segmented import fingerprint_of as ref

    parts = (b"raw", np.arange(5, dtype=np.int32), "text", (3, 0.5))
    assert fingerprint_of(*parts) == ref(*parts)


def test_segmented_matches_the_reference_through_injected_faults(
        tmp_path, monkeypatch):
    """Both packages' `segmented_train`, driven by one pure-numpy trainer
    and interrupted by the same PIO_FAULTS error at a chunk boundary,
    give equal states, histories, start steps and saved steps."""
    from predictionio_tpu.utils import faults as ref_faults
    from predictionio_tpu.workflow.checkpoint import (
        CheckpointManager as RefManager,
    )
    from predictionio_tpu.workflow.segmented import (
        segmented_train as ref_segmented,
    )

    rng = np.random.default_rng(7)
    for trial in range(8):
        total = int(rng.integers(2, 10))
        every = int(rng.integers(1, 4))
        chunks = -(-total // every)
        kill = int(rng.integers(1, chunks + 1))
        out = {}
        for name, train, injected, manager in (
                ("port", segmented_train, faults.FaultInjected,
                 CheckpointManager),
                ("ref", ref_segmented, ref_faults.FaultInjected,
                 RefManager)):
            ckpt = str(tmp_path / f"{name}{trial}")
            _arm(monkeypatch, f"segment.boundary:{kill}=error")
            with pytest.raises(injected):
                train(total_steps=total, checkpoint_dir=ckpt,
                      checkpoint_every=every, **_toy())
            killed_steps = manager(ckpt).all_steps()
            _arm(monkeypatch, "")
            state, hist, start = train(total_steps=total, checkpoint_dir=ckpt,
                                       checkpoint_every=every, **_toy())
            out[name] = (state, hist, start, killed_steps,
                         manager(ckpt).all_steps())
        assert out["port"] == out["ref"], (trial, total, every, kill)
        assert out["port"][2] == min(kill - 1, chunks) * every


# -- the ALS templates' checkpoints (the reference's template cases) ----------

def test_similarproduct_interrupted_resume_matches_uninterrupted(
        port_storage, tmp_path, caplog):
    from predictionio_torch.workflow.workflow_utils import (
        EngineVariant,
        extract_engine_params,
        get_engine,
    )
    from tests.test_torch_similarproduct import ingest_views, variant_dict

    def train(ckpt, iters):
        variant = EngineVariant.from_dict(variant_dict(iters=iters))
        engine = get_engine(variant.engine_factory)
        ctx = WorkflowContext(device="cpu", storage=port_storage, seed=1,
                              checkpoint_dir=ckpt, checkpoint_every=1)
        return engine.train(ctx, extract_engine_params(engine, variant))[0]

    ingest_views(port_storage)
    want = train(None, 6)
    ck = str(tmp_path / "ck")
    train(ck, 3)  # the interrupted run
    cm = CheckpointManager(str(tmp_path / "ck" / "als"))
    assert cm.latest_step() == 3
    with caplog.at_level(logging.INFO):
        got = train(ck, 6)
    assert any("resumed from checkpoint step 3" in m for m in caplog.messages)
    assert cm.latest_step() == 6
    np.testing.assert_array_equal(got.item_factors_unit,
                                  want.item_factors_unit)


def test_ecommerce_interrupted_resume_matches_uninterrupted(
        port_storage, tmp_path, caplog):
    from predictionio_torch.workflow.workflow_utils import (
        EngineVariant,
        extract_engine_params,
        get_engine,
    )
    from tests.test_torch_ecommerce import ingest, trained, variant_dict

    ingest(port_storage)
    _, _, want = trained(port_storage, {"numIterations": 6})

    def ckpt_train(iters):
        variant = EngineVariant.from_dict(
            variant_dict({"numIterations": iters}))
        engine = get_engine(variant.engine_factory)
        ctx = WorkflowContext(device="cpu", storage=port_storage, seed=1,
                              checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=1)
        return engine.train(ctx, extract_engine_params(engine, variant))[0]

    ckpt_train(3)
    cm = CheckpointManager(str(tmp_path / "ck" / "als"))
    assert cm.latest_step() == 3
    with caplog.at_level(logging.INFO):
        got = ckpt_train(6)
    assert any("resumed from checkpoint step 3" in m for m in caplog.messages)
    assert cm.latest_step() == 6
    np.testing.assert_array_equal(got.user_factors, want[0].user_factors)
    np.testing.assert_array_equal(got.item_factors, want[0].item_factors)


from tests.test_torch_similarproduct import port_storage  # noqa: E402,F401 — a fixture
