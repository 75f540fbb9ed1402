"""The port's classification ops (`predictionio_torch/ops/classify.py`) on
the CPU, held against the reference's (`predictionio_tpu/ops/classify.py`)
on the same seeded inputs, at the reference's own bars
(tests/test_classify_grid.py): Naive Bayes rtol 1e-6 / atol 1e-7, softmax
regression rtol 2e-4 / atol 1e-5 on weights, bias and loss history. Within
the port, the checkpoint contract of the reference's
tests/test_checkpoint.py:222-271 holds bitwise: chunked ≡ single run ≡
resumed after a fault at `logreg.step_boundary`."""

import logging

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import classify as ref
from predictionio_torch.ops import classify
from predictionio_torch.utils import faults
from predictionio_torch.workflow.checkpoint import CheckpointManager

NB_TOL = dict(rtol=1e-6, atol=1e-7)
LR_TOL = dict(rtol=2e-4, atol=1e-5)

torch.set_num_threads(1)


@pytest.fixture()
def data():
    """The reference's grid-test data: 1 000 non-negative points, 6
    features, 3 classes."""
    rng = np.random.default_rng(5)
    n, d, c = 1000, 6, 3
    x = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    return x, y, c


def _xy(seed=0, n=240, d=12, c=3):
    """The reference's checkpoint-test data (signed features)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, c, n))


def _fit(x, y, c, **kw):
    return classify.logreg_train(x, y, c, device="cpu", **kw)


def _assert_lr_close(got, want):
    np.testing.assert_allclose(got.weights, want.weights, **LR_TOL)
    np.testing.assert_allclose(got.bias, want.bias, **LR_TOL)
    np.testing.assert_allclose(got.loss_history, want.loss_history, **LR_TOL)


def _assert_lr_equal(got, want):
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.bias, want.bias)
    assert got.loss_history == want.loss_history


# -- Naive Bayes -----------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.1, 5.0])
def test_naive_bayes_matches_reference(data, smoothing):
    x, y, c = data
    got = classify.naive_bayes_train(x, y, c, smoothing=smoothing,
                                     device="cpu")
    want = ref.naive_bayes_train(x, y, c, smoothing=smoothing)
    assert got.log_theta.shape == (c, x.shape[1])
    np.testing.assert_allclose(got.log_prior, want.log_prior, **NB_TOL)
    np.testing.assert_allclose(got.log_theta, want.log_theta, **NB_TOL)
    np.testing.assert_array_equal(got.logits(x[:50]).argmax(1),
                                  want.logits(x[:50]).argmax(1))


def test_naive_bayes_grid_matches_reference_and_sequential(data):
    x, y, c = data
    smoothings = [0.1, 1.0, 5.0, 25.0]
    grid = classify.naive_bayes_train_grid(x, y, c, smoothings, device="cpu")
    want = ref.naive_bayes_train_grid(x, y, c, smoothings)
    assert len(grid) == len(smoothings)
    for s, m, r in zip(smoothings, grid, want):
        np.testing.assert_allclose(m.log_prior, r.log_prior, **NB_TOL)
        np.testing.assert_allclose(m.log_theta, r.log_theta, **NB_TOL)
        seq = classify.naive_bayes_train(x, y, c, smoothing=s, device="cpu")
        np.testing.assert_allclose(m.log_theta, seq.log_theta, **NB_TOL)
        np.testing.assert_allclose(m.log_prior, seq.log_prior, **NB_TOL)


@pytest.mark.parametrize("grid", [False, True])
def test_naive_bayes_rejects_negative_features(data, grid):
    x, y, c = data
    with pytest.raises(ValueError, match="non-negative"):
        if grid:
            classify.naive_bayes_train_grid(-x, y, c, [1.0, 2.0],
                                            device="cpu")
        else:
            classify.naive_bayes_train(-x, y, c, device="cpu")


def test_padding_is_masked_out(data):
    """N = 1 000 − 3 is padded to 1 000: the padded rows change nothing
    (the counts, and the loss's mean, are over the real rows)."""
    x, y, c = data
    x, y = x[:997], y[:997]
    nb = classify.naive_bayes_train(x, y, c, device="cpu")
    counts = np.bincount(y, minlength=c)
    np.testing.assert_allclose(
        nb.log_prior, np.log(counts + 1.0) - np.log(997 + c), **NB_TOL)
    _assert_lr_close(_fit(x, y, c, iterations=5),
                     ref.logreg_train(x, y, c, iterations=5))


# -- softmax regression ----------------------------------------------------

def test_logreg_matches_reference(data):
    x, y, c = data
    got = _fit(x, y, c, iterations=25, learning_rate=0.5, reg=0.01)
    want = ref.logreg_train(x, y, c, iterations=25, learning_rate=0.5,
                            reg=0.01)
    assert got.weights.shape == (x.shape[1], c) and got.bias.shape == (c,)
    assert len(got.loss_history) == 25
    _assert_lr_close(got, want)


def test_logreg_grid_matches_reference_and_sequential(data):
    x, y, c = data
    cells = [(0.5, 0.0), (0.1, 0.01), (0.05, 0.1), (0.2, 0.0)]
    kw = dict(learning_rates=[lr for lr, _ in cells],
              regs=[rg for _, rg in cells])
    grid = classify.logreg_train_grid(x, y, c, iterations=25, device="cpu",
                                      **kw)
    want = ref.logreg_train_grid(x, y, c, iterations=25, **kw)
    for (lr, rg), m, r in zip(cells, grid, want):
        _assert_lr_close(m, r)
        _assert_lr_close(m, _fit(x, y, c, iterations=25, learning_rate=lr,
                                 reg=rg))


def test_logreg_grid_mixed_iterations(data):
    """Per-cell horizons: each cell freezes its params AND Adam state at
    its own count and lands on its sequential train; each loss history
    is its own length."""
    x, y, c = data
    cells = [(0.5, 0.0, 10), (0.5, 0.0, 30), (0.1, 0.01, 20)]
    kw = dict(iterations=[n for _, _, n in cells],
              learning_rates=[lr for lr, _, _ in cells],
              regs=[rg for _, rg, _ in cells])
    grid = classify.logreg_train_grid(x, y, c, device="cpu", **kw)
    want = ref.logreg_train_grid(x, y, c, **kw)
    for (lr, rg, n), m, r in zip(cells, grid, want):
        assert len(m.loss_history) == n
        _assert_lr_close(m, r)
        _assert_lr_close(m, _fit(x, y, c, iterations=n, learning_rate=lr,
                                 reg=rg))
    # same (lr, reg), different horizons: different models
    assert np.abs(grid[0].weights - grid[1].weights).max() > 1e-5


def test_logreg_grid_iteration_count_mismatch_raises(data):
    x, y, c = data
    with pytest.raises(ValueError, match="2 iteration counts for 3"):
        classify.logreg_train_grid(x, y, c, iterations=[5, 10],
                                   learning_rates=[0.1, 0.2, 0.3],
                                   regs=[0.0, 0.0, 0.0], device="cpu")


# -- the checkpoint contract, bitwise within the port ----------------------

def test_chunked_matches_single_run(tmp_path):
    x, y = _xy()
    base = _fit(x, y, 3, iterations=40)
    chunked = _fit(x, y, 3, iterations=40, checkpoint_dir=str(tmp_path),
                   checkpoint_every=7)
    _assert_lr_equal(chunked, base)
    assert CheckpointManager(str(tmp_path)).latest_step() == 40


def test_resumed_after_a_fault_matches_uninterrupted(tmp_path, monkeypatch,
                                                     caplog):
    """A fault at `logreg.step_boundary` after the 3rd chunk (before its
    save) leaves step 20; the re-run resumes there and ends on the
    uninterrupted run's bits, its loss history's prefix restored."""
    x, y = _xy(4)
    base = _fit(x, y, 3, iterations=40)
    monkeypatch.setenv("PIO_FAULTS", "")
    faults._parse()
    monkeypatch.setenv("PIO_FAULTS", "logreg.step_boundary:3=error")
    with pytest.raises(faults.FaultInjected):
        _fit(x, y, 3, iterations=40, checkpoint_dir=str(tmp_path),
             checkpoint_every=10)
    monkeypatch.setenv("PIO_FAULTS", "")
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]
    with caplog.at_level(logging.INFO):
        got = _fit(x, y, 3, iterations=40, checkpoint_dir=str(tmp_path),
                   checkpoint_every=10)
    assert any("logreg_train: resumed from checkpoint step 20"
               in r.getMessage() for r in caplog.records)
    _assert_lr_equal(got, base)


def test_resume_and_extend(tmp_path):
    x, y = _xy(1)
    base = _fit(x, y, 3, iterations=40)
    # a 20-step run, then a re-run to 40: it resumes at 20 and lands on
    # the uninterrupted 40-step result
    _fit(x, y, 3, iterations=20, checkpoint_dir=str(tmp_path),
         checkpoint_every=10)
    got = _fit(x, y, 3, iterations=40, checkpoint_dir=str(tmp_path),
               checkpoint_every=10)
    _assert_lr_equal(got, base)


def test_changed_data_retrains(tmp_path, caplog):
    x, y = _xy(2)
    _fit(x, y, 3, iterations=10, checkpoint_dir=str(tmp_path),
         checkpoint_every=5)
    x2 = x + 1.0  # new data, same shapes
    base = _fit(x2, y, 3, iterations=10)
    with caplog.at_level(logging.WARNING):
        got = _fit(x2, y, 3, iterations=10, checkpoint_dir=str(tmp_path),
                   checkpoint_every=5)
    _assert_lr_equal(got, base)
    assert any("different data/config" in r.message for r in caplog.records)


def test_default_saves_once_at_end(tmp_path):
    _fit(*_xy(3), 3, iterations=12, checkpoint_dir=str(tmp_path))
    assert CheckpointManager(str(tmp_path)).all_steps() == [12]


def test_the_references_checkpoint_is_not_resumed(tmp_path, caplog):
    """A step the reference wrote into the same directory (same data and
    config) carries another fingerprint: the port trains from scratch."""
    x, y = _xy(6)
    ref.logreg_train(x, y, 3, iterations=10, checkpoint_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        got = _fit(x, y, 3, iterations=10, checkpoint_dir=str(tmp_path))
    _assert_lr_equal(got, _fit(x, y, 3, iterations=10))
    assert any("different data/config" in r.message for r in caplog.records)


def test_entry_points_without_a_device_raise(data, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    x, y, c = data
    for fit in (lambda: classify.logreg_train(x, y, c, iterations=1),
                lambda: classify.naive_bayes_train(x, y, c),
                lambda: classify.logreg_train_grid(x, y, c, 1, [0.1], [0.0]),
                lambda: classify.naive_bayes_train_grid(x, y, c, [1.0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit()
