"""Classification ops: multinomial Naive Bayes and multinomial logistic
regression — the port of ``predictionio_tpu/ops/classify.py``, on one
device.

The classification and leadscoring templates train through these in place
of Spark MLlib's `NaiveBayes.train` and `LogisticRegressionWithLBFGS`.

Design notes:
- NB's sufficient statistics are one one-hot product,
  `onehot[N, C]ᵀ @ X[N, D]` → [C, D] per-class feature sums.
- LogReg is full-batch softmax regression with Adam, written out on
  tensors: the loss, its gradient (`(softmax − onehot)` through one GEMM
  `xᵀ @ G`) and optax's `scale_by_adam` update (b1 0.9, b2 0.999,
  eps 1e-8, eps_root 0, bias correction by the step count). The loss
  history comes back to the host once a chunk, not once a step.
- A grid of G cells keeps its weights as [D, G, C]: one GEMM
  `x @ W.reshape(D, G·C)` gives every cell's logits and one GEMM
  `xᵀ @ (P − Y)` every cell's gradient, with no [G, N, D] copy of the
  features. A sequential fit is the grid of one cell.
- N is padded to a multiple of 8 (the reference's padding on one device);
  a weight column masks the padding out of every reduction.
- Nothing accumulates through atomics (no `index_add_` or `scatter_add_`:
  the one-hot is an `eq`, the reductions are GEMMs and `sum`), so two
  fits, a chunked fit and a resumed fit give the same bits on the card.

The reference shards the example axis over a device mesh and meters its
jitted programs; the port runs on one device (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_torch.device import DeviceLike, resolve_device


# the padded example count divides by this (the reference's
# math.lcm(8, data-axis size) on one device)
ROW_MULTIPLE = 8
# optax.scale_by_adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
# the checkpoint fingerprint's tag: the port never resumes a step that the
# reference wrote into a shared directory
_FINGERPRINT_TAG = "torch.logreg.v1"


@dataclasses.dataclass
class NaiveBayesModel:
    """Multinomial NB: log priors [C] + log feature likelihoods [C, D]."""

    log_prior: np.ndarray
    log_theta: np.ndarray

    def logits(self, x: np.ndarray) -> np.ndarray:
        return self.log_prior + x @ self.log_theta.T


@dataclasses.dataclass
class LogRegModel:
    weights: np.ndarray  # [D, C]
    bias: np.ndarray  # [C]
    loss_history: list = dataclasses.field(default_factory=list)

    def logits(self, x: np.ndarray) -> np.ndarray:
        return x @ self.weights + self.bias


def _pad_batch(x: np.ndarray, y: np.ndarray, multiple: int):
    """Pad the example axis to `multiple`; returns (x, y, weight)."""
    n = x.shape[0]
    n_pad = -(-n // multiple) * multiple
    w = np.zeros(n_pad, dtype=np.float32)
    w[:n] = 1.0
    if n_pad != n:
        x = np.concatenate([x, np.zeros((n_pad - n,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros(n_pad - n, y.dtype)])
    return x, y, w


def _examples(features, labels, dev: torch.device, non_negative=False):
    """(x, y, w) on `dev`: x [N', D] f32, y [N'] int64 labels, w [N'] the
    padding mask, N' = N padded to ROW_MULTIPLE."""
    x = np.ascontiguousarray(features, dtype=np.float32)
    y = np.ascontiguousarray(labels, dtype=np.int32)
    if non_negative and np.any(x < 0):
        raise ValueError("multinomial NB requires non-negative features")
    x, y, w = _pad_batch(x, y, ROW_MULTIPLE)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev).long(),
            torch.from_numpy(w).to(dev))


def _onehot(y: torch.Tensor, n_classes: int, w: torch.Tensor) -> torch.Tensor:
    """[N, C] f32 one-hot of `y`, each row scaled by its weight."""
    classes = torch.arange(n_classes, device=y.device)
    return (y[:, None] == classes).to(w.dtype) * w[:, None]


# -- Naive Bayes -----------------------------------------------------------

def _nb_fit(x, y, w, n_classes: int, smoothings: torch.Tensor):
    """(log_prior [G, C], log_theta [G, C, D]) for the G smoothings: the
    counts once (they do not depend on the smoothing), then each cell's
    elementwise finish."""
    onehot = _onehot(y, n_classes, w)
    class_counts = onehot.sum(0)  # [C]
    feat_sums = onehot.T @ x  # [C, D]
    n = w.sum()
    d = x.shape[1]
    s = smoothings
    log_prior = (torch.log(class_counts + s[:, None])
                 - torch.log(n + n_classes * s)[:, None])
    log_theta = (torch.log(feat_sums + s[:, None, None])
                 - torch.log(feat_sums.sum(-1, keepdim=True)
                             + d * s[:, None, None]))
    return log_prior, log_theta


def naive_bayes_train_grid(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    smoothings,
    device: DeviceLike = None,
) -> "list[NaiveBayesModel]":
    """One model per smoothing (λ) in `smoothings`, the counts computed
    once; each cell equals `naive_bayes_train` at its λ."""
    dev = resolve_device(device)
    x, y, w = _examples(features, labels, dev, non_negative=True)
    s = torch.tensor([float(v) for v in smoothings], dtype=torch.float32,
                     device=dev)
    log_prior, log_theta = _nb_fit(x, y, w, n_classes, s)
    lp, lt = log_prior.cpu().numpy(), log_theta.cpu().numpy()
    return [NaiveBayesModel(lp[g], lt[g]) for g in range(len(s))]


def naive_bayes_train(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    smoothing: float = 1.0,
    device: DeviceLike = None,
) -> NaiveBayesModel:
    """MLlib-compatible multinomial NB («NaiveBayes.train(lambda)»):
    pi_c = log((n_c + λ)/(n + Cλ)); θ_cj = log((Σ x_j|c + λ)/(Σ x|c + Dλ)).
    Features must be non-negative counts/frequencies."""
    return naive_bayes_train_grid(features, labels, n_classes, [smoothing],
                                  device=device)[0]


# -- softmax regression ----------------------------------------------------

def _loss_and_grads(params, x, y, y1h, w, denom, regs):
    """Every cell's loss [G] and its gradients (gW [D, G, C], gb [G, C]):
    softmax cross-entropy weighted by the padding mask `w` over `denom`
    (max(Σ w, 1)), plus ½·reg·‖W‖²."""
    weights, bias = params
    d, g, c = weights.shape
    logits = (x @ weights.reshape(d, g * c)).reshape(-1, g, c) + bias
    lse = torch.logsumexp(logits, -1)  # [N, G]
    label_logit = logits.gather(-1, y[:, None, None].expand(-1, g, 1))[..., 0]
    data = ((lse - label_logit) * w[:, None]).sum(0) / denom
    loss = data + 0.5 * regs * (weights * weights).sum((0, 2))
    resid = ((torch.exp(logits - lse[..., None]) - y1h[:, None, :])
             * (w / denom)[:, None, None])
    grad_w = ((x.T @ resid.reshape(-1, g * c)).reshape(d, g, c)
              + _cells(regs, weights) * weights)
    return loss, (grad_w, resid.sum(0))


def _cells(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The per-cell vector `v` [G] shaped to broadcast over `like`'s cell
    axis: axis 1 of the [D, G, C] weights, axis 0 of everything else."""
    return v.reshape((1, -1, 1) if like.dim() == 3
                     else (-1,) + (1,) * (like.dim() - 1))


def _adam(grads, mu, nu, count):
    """optax.scale_by_adam's update (before the learning rate) and its
    new state (mu, nu, count); `count` [G] int32, one a cell."""
    mu = [(1 - ADAM_B1) * gr + ADAM_B1 * m for gr, m in zip(grads, mu)]
    nu = [(1 - ADAM_B2) * (gr * gr) + ADAM_B2 * v for gr, v in zip(grads, nu)]
    count = count + 1
    steps = count.to(torch.float32)
    bc1 = 1 - ADAM_B1 ** steps
    bc2 = 1 - ADAM_B2 ** steps
    updates = [(m / _cells(bc1, m))
               / (torch.sqrt(v / _cells(bc2, v) + ADAM_EPS_ROOT) + ADAM_EPS)
               for m, v in zip(mu, nu)]
    return updates, mu, nu, count


def _init_state(d: int, g: int, n_classes: int, dev) -> tuple:
    """(params, (mu, nu, count)) of G cells at zero."""
    def zeros():
        return (torch.zeros((d, g, n_classes), dtype=torch.float32,
                            device=dev),
                torch.zeros((g, n_classes), dtype=torch.float32, device=dev))

    return (zeros(), (list(zeros()), list(zeros()),
                      torch.zeros(g, dtype=torch.int32, device=dev)))


def _logreg_steps(state, inputs, lrs, regs, n_steps: int, start: int = 0,
                  horizons=None):
    """`n_steps` Adam steps of every cell from absolute step `start`;
    returns (state, losses [n_steps, G] on the device). With `horizons`
    ([G] int32) a cell past its own count keeps its params and Adam
    state, count included."""
    params, (mu, nu, count) = state
    losses = []
    for t in range(start, start + n_steps):
        loss, grads = _loss_and_grads(params, *inputs, regs)
        updates, new_mu, new_nu, new_count = _adam(grads, mu, nu, count)
        new_params = tuple(p - _cells(lrs, p) * u
                           for p, u in zip(params, updates))
        if horizons is not None:
            act = t < horizons  # [G]

            def keep(new, old):
                return torch.where(_cells(act, new), new, old)

            new_params = tuple(keep(n, o) for n, o in zip(new_params, params))
            new_mu = [keep(n, o) for n, o in zip(new_mu, mu)]
            new_nu = [keep(n, o) for n, o in zip(new_nu, nu)]
            new_count = keep(new_count, count)
        params, mu, nu, count = new_params, new_mu, new_nu, new_count
        losses.append(loss)
    stacked = (torch.stack(losses) if losses else
               torch.zeros((0, params[1].shape[0]), device=params[1].device))
    return (params, (mu, nu, count)), stacked


def _logreg_inputs(features, labels, n_classes: int, dev) -> tuple:
    """(x, y, one-hot y, w, max(Σ w, 1)) on `dev`: `_logreg_steps`'s
    inputs."""
    x, y, w = _examples(features, labels, dev)
    return (x, y, _onehot(y, n_classes, torch.ones_like(w)), w,
            torch.clamp(w.sum(), min=1.0))


def logreg_train_grid(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    iterations,
    learning_rates,
    regs,
    device: DeviceLike = None,
) -> "list[LogRegModel]":
    """N (stepSize, regParam, iterations) cells trained together, one
    forward and one backward GEMM a step for all of them. `iterations` is
    an int shared by every cell or a per-cell sequence: the loop runs
    max(iterations) steps and each cell freezes params + Adam state at
    its own horizon, so it lands on its sequential train."""
    dev = resolve_device(device)
    lrs = torch.tensor([float(v) for v in learning_rates],
                       dtype=torch.float32, device=dev)
    rgs = torch.tensor([float(v) for v in regs], dtype=torch.float32,
                       device=dev)
    g = int(len(lrs))
    if np.ndim(iterations) == 0:
        iters_list = [int(iterations)] * g
    else:
        iters_list = [int(v) for v in iterations]
    if len(iters_list) != g:
        raise ValueError(
            f"logreg_train_grid: {len(iters_list)} iteration counts for "
            f"{g} cells")
    inputs = _logreg_inputs(features, labels, n_classes, dev)
    n_steps = max(iters_list) if iters_list else 0
    state = _init_state(inputs[0].shape[1], g, n_classes, dev)
    horizons = torch.tensor(iters_list, dtype=torch.int32, device=dev)
    (params, _), losses = _logreg_steps(state, inputs, lrs, rgs, n_steps,
                                        horizons=horizons)
    wts = params[0].cpu().numpy()
    bs = params[1].cpu().numpy()
    ls = losses.cpu().numpy()
    return [
        LogRegModel(weights=np.ascontiguousarray(wts[:, c, :]), bias=bs[c],
                    # post-horizon rows re-measure frozen params: each
                    # cell keeps its own history
                    loss_history=[float(v) for v in ls[:iters_list[c], c]])
        for c in range(g)
    ]


def logreg_train(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    iterations: int = 200,
    learning_rate: float = 0.1,
    reg: float = 0.0,
    device: DeviceLike = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
) -> LogRegModel:
    """Softmax regression, full-batch Adam on one device.

    `checkpoint_dir`: when set, (params, Adam state) are checkpointed
    every `checkpoint_every` iterations (default: one save at the end)
    under a fingerprint of the training data and config (not
    `iterations`: resuming into a longer run is legal), and a re-run
    resumes from the latest usable step. The chunks, saves and resume are
    `workflow.segmented.segmented_train`'s, with the fault site
    `logreg.step_boundary` after each chunk, before its save. Chunked,
    single-run and resumed fits give the same bits."""
    from predictionio_torch.workflow.segmented import (
        fingerprint_of,
        segmented_train,
    )

    dev = resolve_device(device)
    x_np = np.ascontiguousarray(features, dtype=np.float32)
    y_np = np.ascontiguousarray(labels, dtype=np.int32)
    d = x_np.shape[1]
    inputs = _logreg_inputs(x_np, y_np, n_classes, dev)
    lr, rg = float(learning_rate), float(reg)
    lrs = torch.tensor([lr], dtype=torch.float32, device=dev)
    rgs = torch.tensor([rg], dtype=torch.float32, device=dev)

    def init_state():
        return _init_state(d, 1, n_classes, dev)

    def leaves(state) -> list:
        params, (mu, nu, count) = state
        return [*params, *mu, *nu, count]

    def run_chunk(state, n_steps, done):
        state, losses = _logreg_steps(state, inputs, lrs, rgs, n_steps,
                                      start=done)
        # the losses' readback is the chunk's fence
        return state, [float(v) for v in losses[:, 0].cpu()]

    def state_from_host(tree):
        want = leaves(init_state())
        got = tree["leaves"]
        if len(got) != len(want):
            raise ValueError(f"leaf count {len(got)} != {len(want)}")
        for g, t in zip(got, want):
            if tuple(np.shape(g)) != tuple(t.shape):
                raise ValueError(f"shape {np.shape(g)} != {tuple(t.shape)}")
        got = [torch.as_tensor(np.asarray(g), dtype=t.dtype, device=dev)
               for g, t in zip(got, want)]
        return (tuple(got[0:2]), (got[2:4], got[4:6], got[6]))

    fp = ""
    if checkpoint_dir:
        fp = fingerprint_of(x_np, y_np, (n_classes, d, lr, rg,
                                         _FINGERPRINT_TAG))
    state, history, _ = segmented_train(
        total_steps=int(iterations),
        init_state=init_state,
        run_chunk=run_chunk,
        state_to_host=lambda st: {"leaves": [t.cpu().numpy()
                                             for t in leaves(st)]},
        state_from_host=state_from_host,
        fingerprint=fp,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        fault_site="logreg.step_boundary",
        name="logreg_train",
    )
    weights, bias = state[0]
    return LogRegModel(
        weights=weights[:, 0, :].cpu().numpy(),
        bias=bias[0].cpu().numpy(),
        loss_history=[float(v) for v in history],
    )
