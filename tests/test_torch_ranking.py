"""The port's top-k (predictionio_torch/ops/ranking.py) against the
reference's `recommend_topk`: both branches, with and without seen-item
exclusion. Ids must be identical wherever the scores are not tied."""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import ranking as ref
from predictionio_torch.ops import ranking

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


def _factors(seed=0, n_users=200, n_items=150, k=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, k)).astype(np.float32),
            rng.normal(size=(n_items, k)).astype(np.float32))


def _exclude(rng, user_ids, n_items):
    return {int(u): rng.choice(n_items, size=rng.integers(0, 20),
                               replace=False).astype(np.int32)
            for u in user_ids}


def _assert_same_topk(scores, idx, ref_scores, ref_idx):
    assert idx.shape == ref_idx.shape and idx.dtype == np.int32
    assert scores.dtype == np.float32
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5)
    for row in range(idx.shape[0]):
        s = ref_scores[row]
        # a position is tied when its score is within f32 rounding of a
        # neighbour's: the order among such items is unspecified
        gaps = np.abs(np.diff(s))
        tied = np.zeros(len(s), bool)
        tied[:-1] |= gaps < 1e-5
        tied[1:] |= gaps < 1e-5
        fin = np.isfinite(s)
        keep = ~tied & fin
        np.testing.assert_array_equal(idx[row][keep], ref_idx[row][keep])


@pytest.mark.parametrize("n_batch", [1, 7, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_host_branch_matches_reference_exactly(n_batch, masked):
    """≤ SERVE_HOST_MAX_BATCH users: the same numpy gemv math, so ids and
    scores are bit-identical."""
    uf, itf = _factors()
    rng = np.random.default_rng(1)
    ids = rng.choice(uf.shape[0], n_batch, replace=False).astype(np.int32)
    exclude = _exclude(rng, ids, itf.shape[0]) if masked else None
    s, i = ranking.recommend_topk(uf, itf, ids, 10, exclude)
    rs, ri = ref.recommend_topk(uf, itf, ids, 10, exclude)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [None, 33])
def test_device_branch_matches_reference(masked, chunk):
    """> SERVE_HOST_MAX_BATCH users: mm + index_put_(-inf) + topk on the
    CPU device, against the reference's device branch."""
    uf, itf = _factors(seed=2)
    rng = np.random.default_rng(3)
    ids = rng.permutation(uf.shape[0]).astype(np.int32)[:150]
    exclude = _exclude(rng, ids, itf.shape[0]) if masked else None
    s, i = ranking.recommend_topk(uf, itf, ids, 12, exclude, chunk=chunk,
                                  device="cpu")
    rs, ri = ref.recommend_topk(uf, itf, ids, 12, exclude, chunk=chunk)
    _assert_same_topk(s, i, rs, ri)
    if masked:
        for row, uid in enumerate(ids):
            assert not set(i[row].tolist()) & set(exclude[int(uid)].tolist())


def test_device_and_host_branches_agree():
    uf, itf = _factors(seed=4)
    rng = np.random.default_rng(5)
    ids = np.arange(uf.shape[0], dtype=np.int32)
    exclude = _exclude(rng, ids, itf.shape[0])
    s_dev, i_dev = ranking.topk_device(uf, itf, ids, 10, exclude,
                                       device="cpu")
    s_host, i_host = ranking.topk_host(uf, itf, ids, 10, exclude)
    _assert_same_topk(s_dev, i_dev, s_host, i_host)


def test_k_clamps_and_empty_batches():
    uf, itf = _factors(n_items=5)
    s, i = ranking.recommend_topk(uf, itf, np.arange(3, dtype=np.int32), 50)
    assert i.shape == (3, 5)
    s, i = ranking.recommend_topk(uf, itf, np.zeros(0, np.int32), 5)
    assert s.shape == (0, 0) and i.shape == (0, 0)


def test_exclusion_coo_matches_reference():
    rng = np.random.default_rng(6)
    ids = np.arange(9, dtype=np.int32)
    exclude = _exclude(rng, ids, 40)
    # the reference pads to a power of two with rows == n_rows; the port
    # returns the real entries only
    ref_rows, ref_cols = ref._exclusion_coo(ids, exclude, 9)
    real = ref_rows < 9
    rows, cols = ranking._exclusion_coo(ids, exclude)
    np.testing.assert_array_equal(rows, ref_rows[real])
    np.testing.assert_array_equal(cols, ref_cols[real])
    assert rows.dtype == cols.dtype == np.int32


def test_map_at_k_matches_reference():
    uf, itf = _factors(seed=7)
    rng = np.random.default_rng(8)
    test = {int(u): set(rng.choice(itf.shape[0], 5, replace=False).tolist())
            for u in range(0, 100, 3)}
    assert ranking.map_at_k(uf, itf, test, k=10) == ref.map_at_k(
        uf, itf, test, k=10)
    assert ranking.average_precision_at_k([3, 1, 2], {1, 2}, 3) == \
        ref.average_precision_at_k([3, 1, 2], {1, 2}, 3)
