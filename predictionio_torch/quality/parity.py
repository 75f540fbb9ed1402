"""Train the port's ALS and the MLlib-faithful CPU reference on identical
data; report held-out RMSE / MAP@10 side by side — own copy of the JAX
package's ``quality/parity.py``.

The metric code here is shared numpy applied to both implementations'
factor matrices — what must be independent is the *training* math, and it
is (quality/mllib_als.py shares no code with ops/als.py). Cold-start
semantics match MLlib's `coldStartStrategy="drop"`: test entries whose
user or item has no training data are dropped from both metrics,
identically for both implementations.

The port's side trains on `device` (the card unless the caller asks for
the CPU); the MLlib-faithful side is host numpy and can be trained apart
(`reference_side`, e.g. in another process) and handed to `run_parity`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.ops.ranking import average_precision_at_k
from predictionio_torch.quality import datasets
from predictionio_torch.quality.mllib_als import mllib_als_train


def rmse_heldout(uf, itf, split: datasets.RatingSplit) -> float:
    """Held-out RMSE with cold (train-unseen) users/items dropped."""
    seen_u = np.zeros(split.n_users, bool)
    seen_u[split.train_u] = True
    seen_i = np.zeros(split.n_items, bool)
    seen_i[split.train_i] = True
    keep = seen_u[split.test_u] & seen_i[split.test_i]
    u, i, r = split.test_u[keep], split.test_i[keep], split.test_r[keep]
    pred = np.einsum("ij,ij->i", uf[u].astype(np.float64),
                     itf[i].astype(np.float64))
    return float(np.sqrt(np.mean((pred - r) ** 2)))


def map_at_k_heldout(uf, itf, split: datasets.RatingSplit, k: int = 10,
                     max_users: Optional[int] = None,
                     chunk: int = 2048) -> float:
    """MAP@k against held-out positives, train items excluded from the
    candidate ranking (the standard implicit-ALS protocol and what the
    Recommendation template's evaluation measures)."""
    test_users = np.unique(split.test_u)
    if max_users is not None and len(test_users) > max_users:
        rng = np.random.default_rng(12345)
        test_users = rng.choice(test_users, max_users, replace=False)
        test_users.sort()
    # CSR views of train/test per user
    def by_user(u_arr, i_arr):
        order = np.argsort(u_arr, kind="stable")
        counts = np.bincount(u_arr, minlength=split.n_users)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        return indptr, i_arr[order]

    tr_ptr, tr_items = by_user(split.train_u, split.train_i)
    te_ptr, te_items = by_user(split.test_u, split.test_i)

    uf64 = uf.astype(np.float64)
    itf64 = itf.astype(np.float64)
    ap_sum, n_ap = 0.0, 0
    for s in range(0, len(test_users), chunk):
        users = test_users[s : s + chunk]
        scores = uf64[users] @ itf64.T  # [chunk, n_items]
        for row, u in enumerate(users):
            scores[row, tr_items[tr_ptr[u] : tr_ptr[u + 1]]] = -np.inf
        top = np.argpartition(-scores, k, axis=1)[:, :k]
        ord_ = np.take_along_axis(scores, top, axis=1).argsort(axis=1)[:, ::-1]
        top = np.take_along_axis(top, ord_, axis=1)
        for row, u in enumerate(users):
            actual = te_items[te_ptr[u] : te_ptr[u + 1]]
            if actual.size == 0:
                continue
            ap_sum += average_precision_at_k(
                top[row].tolist(), set(actual.tolist()), k)
            n_ap += 1
    return ap_sum / max(n_ap, 1)


def parity_split(mode: str, scale: str, seed: int = 0) -> datasets.RatingSplit:
    """The split `run_parity` trains and scores on."""
    if mode == "implicit":
        return datasets.synth_implicit(scale, seed=seed)
    return datasets.synth_explicit(scale, seed=seed)


def reference_side(split: datasets.RatingSplit, mode: str, rank: int,
                   iterations: int, reg: float, alpha: float = 40.0,
                   seed: int = 0) -> dict:
    """The MLlib-faithful ALS trained on `split`: its factors, epoch
    seconds and wall seconds, as `run_parity(ref_side=…)` takes them."""
    t0 = time.perf_counter()
    ref = mllib_als_train(split.train_u, split.train_i, split.train_r,
                          split.n_users, split.n_items, rank=rank,
                          iterations=iterations, reg=reg,
                          implicit=mode == "implicit", alpha=alpha,
                          seed=seed)
    return {"user_factors": ref.user_factors,
            "item_factors": ref.item_factors,
            "epoch_times": list(ref.epoch_times),
            "wall_s": time.perf_counter() - t0}


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def run_parity(
    mode: str = "explicit",
    scale: str = "100k",
    rank: int = 10,
    iterations: int = 10,
    reg: float = 0.1,
    alpha: float = 40.0,
    seed: int = 0,
    map_k: int = 10,
    map_max_users: Optional[int] = 20_000,
    ref_iterations: Optional[int] = None,
    als_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
    split: Optional[datasets.RatingSplit] = None,
    ref_side: Optional[dict] = None,
    init_item_factors: Optional[np.ndarray] = None,
) -> dict:
    """Returns {"ours": {...}, "ref": {...}, "delta": {...}, ...}.

    device: where the port's ALS trains (`device.resolve_device`).
    split: `parity_split(mode, scale, seed)`, when the caller has it.
    ref_side: `reference_side(...)` of the same split and settings,
    trained elsewhere; None trains it here.
    init_item_factors: the port's initial item factors (None: its own
    seeded draw)."""
    from predictionio_torch.ops.als import ALSConfig, als_train

    implicit = mode == "implicit"
    if split is None:
        split = parity_split(mode, scale, seed)
    dev = resolve_device(device)

    cfg = ALSConfig(rank=rank, iterations=iterations, reg=reg,
                    weighted_reg=True, implicit=implicit,
                    alpha=alpha if implicit else 1.0, seed=seed,
                    **(als_kwargs or {}))
    t0 = time.perf_counter()
    ours = als_train(split.train_u, split.train_i, split.train_r,
                     split.n_users, split.n_items, cfg, device=dev,
                     init_item_factors=init_item_factors)
    ours_wall = time.perf_counter() - t0

    if ref_side is None:
        ref_side = reference_side(split, mode, rank,
                                  ref_iterations or iterations, reg, alpha,
                                  seed)

    out = {
        "mode": mode, "scale": scale, "rank": rank,
        "iterations": iterations, "reg": reg,
        "n_train": split.n_train, "n_test": split.n_test,
        "ours": {"wall_s": round(ours_wall, 2),
                 "epoch_s": (round(float(np.median(ours.epoch_times)), 4)
                             if ours.epoch_times else None),
                 "device": _device_name(dev)},
        "ref": {"wall_s": round(float(ref_side["wall_s"]), 2),
                "epoch_s": round(float(np.median(ref_side["epoch_times"])),
                                 4)},
    }
    sides = (("ours", ours.user_factors, ours.item_factors),
             ("ref", ref_side["user_factors"], ref_side["item_factors"]))
    if implicit:
        out["alpha"] = alpha
        for name, uf, itf in sides:
            out[name]["map%d" % map_k] = round(
                map_at_k_heldout(uf, itf, split, map_k, map_max_users), 4)
        key = "map%d" % map_k
    else:
        for name, uf, itf in sides:
            out[name]["rmse"] = round(rmse_heldout(uf, itf, split), 4)
        key = "rmse"
    out["delta"] = round(out["ours"][key] - out["ref"][key], 4)
    out["metric"] = key
    return out
