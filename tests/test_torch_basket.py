"""The port's basket ops (`predictionio_torch/ops/basket.py`) on the CPU,
held against the reference's (`predictionio_tpu/ops/basket.py`) on the
same seeded numpy inputs. The counts are exact integers, so the bar is
equality: the co-occurrence Gram is `np.array_equal` to the reference's
(random baskets, repeat purchases, a capped basket, empty input, chunk
boundaries inside the data, counts past bf16's 256 inside one chunk), and
every `BasketRules` array of `mine_rules` equals the reference's under
both scores, with thresholds and through the host fallback."""

import logging

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import basket as ref
from predictionio_torch.ops import basket as port

torch.set_num_threads(1)

RULE_FIELDS = ("cond_items", "cons_items", "scores", "support", "confidence",
               "lift")


def random_baskets(seed, n_baskets, n_items, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_baskets, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32))


def assert_rules_equal(got, want):
    for name in RULE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.n_baskets == want.n_baskets


@pytest.mark.parametrize("case", ["random", "duplicates", "chunks",
                                  "odd_chunk", "empty"])
def test_cooccurrence_equals_reference(case):
    """`chunks`: 2 500 baskets over three 1 024-basket chunks; `odd_chunk`:
    chunk 100 (not a multiple of the GEMM's 8) with baskets cut by every
    chunk boundary; `duplicates`: each purchase bought again."""
    n_baskets, n_items = {"random": (300, 40), "duplicates": (200, 30),
                          "chunks": (2_500, 37), "odd_chunk": (1_000, 50),
                          "empty": (7, 5)}[case]
    b, i = random_baskets(3, n_baskets, n_items,
                          {"empty": 0}.get(case, 6 * n_baskets))
    if case == "duplicates":
        b, i = np.concatenate([b, b[::2]]), np.concatenate([i, i[::2]])
    chunk = 100 if case == "odd_chunk" else 1024
    want = ref.cooccurrence_matrix(b, i, n_baskets, n_items, chunk=chunk)
    got = port.cooccurrence_matrix(b, i, n_baskets, n_items, chunk=chunk,
                                   device="cpu")
    assert got.dtype == np.float32 and got.shape == (n_items, n_items)
    np.testing.assert_array_equal(got, want)


def test_counts_past_bf16_inside_one_chunk():
    """A pair in 1 023 baskets and one in 257, all inside one 1 024-basket
    chunk: a bf16 product's output rounds both (to 1 024 and 256). The
    port's count is exact and equals the reference's."""
    b = np.concatenate([np.repeat(np.arange(1023), 2), [1023],
                        np.repeat(np.arange(257), 2)])
    i = np.concatenate([np.tile([0, 1], 1023), [2], np.tile([2, 3], 257)])
    got = port.cooccurrence_matrix(b, i, 1024, 4, device="cpu")
    assert got[0, 1] == got[1, 0] == 1023
    assert got[2, 3] == got[3, 2] == got[0, 2] == 257
    assert got[2, 2] == 258
    np.testing.assert_array_equal(got, ref.cooccurrence_matrix(b, i, 1024, 4))
    # the trap this formulation avoids
    m = torch.zeros(1024, 4, dtype=torch.bfloat16)
    m[:257, 2] = 1
    m[:257, 3] = 1
    assert (m.t() @ m)[2, 3].item() == 256


def test_capped_basket_warns_and_equals_reference(caplog):
    """A bot basket of 90 distinct items (with repeats) under a cap of 16
    keeps its 16 lowest item ids, with a warning on the port's logger."""
    b, i = random_baskets(5, 120, 100, 400)
    rng = np.random.default_rng(6)
    bot = rng.integers(0, 100, 300).astype(np.int32)
    b, i = np.concatenate([b, np.full(300, 7, np.int32)]), np.concatenate(
        [i, bot])
    want = ref.cooccurrence_matrix(b, i, 120, 100, max_basket_items=16)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=port.__name__):
        got = port.cooccurrence_matrix(b, i, 120, 100, max_basket_items=16,
                                       device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [(r.name, r.getMessage()) for r in caplog.records] == [
        ("predictionio_torch.ops.basket", "cooccurrence_matrix: truncating "
         "1 basket(s) larger than 16 distinct items")]
    # basket 7 adds one to each pair of its 16 lowest distinct items
    kept = np.unique(i[b == 7])[:16]
    others = b != 7
    added = got - port.cooccurrence_matrix(b[others], i[others], 120, 100,
                                           device="cpu")
    assert added.sum() == 16 * 16
    assert (added[np.ix_(kept, kept)] == 1).all()


@pytest.mark.parametrize("group_bytes", [1, 4 * 25 * 16])
def test_grouped_chunks_give_the_same_gram(monkeypatch, group_bytes):
    """One GEMM a chunk (GROUP_BYTES 1) and four 16-basket chunks of 25
    padded item rows a GEMM (six chunks: the last group short) give the
    Gram that all chunks in one GEMM give."""
    b, i = random_baskets(8, 90, 20, 500)
    whole = port.cooccurrence_matrix(b, i, 90, 20, chunk=16, device="cpu")
    monkeypatch.setattr(port, "GROUP_BYTES", group_bytes)
    got = port.cooccurrence_matrix(b, i, 90, 20, chunk=16, device="cpu")
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(
        got, ref.cooccurrence_matrix(b, i, 90, 20, chunk=16))


def test_host_fallback_equals_reference():
    b, i = random_baskets(9, 80, 25, 500)
    want = ref.cooccurrence_matrix_host(b, i, 80, 25, max_basket_items=6)
    got = port.cooccurrence_matrix_host(b, i, 80, 25, max_basket_items=6)
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(min_lift=0.0, top_k=4),
    dict(min_support=0.02, min_confidence=0.1, min_lift=1.0, top_k=3,
         score="confidence"),
    dict(min_support=0.01, min_lift=1.2, top_k=50, score="lift"),
    dict(min_lift=0.0, top_k=5, max_dense_items=1),
    dict(min_support=0.02, min_confidence=0.2, top_k=3, score="confidence",
         max_dense_items=1),
])
def test_mine_rules_equals_reference(kw):
    """Every array equal, on the dense path and the host fallback
    (`max_dense_items=1`); top_k 50 is wider than the 30-item catalog."""
    b, i = random_baskets(1, 150, 30, 900)
    want = ref.mine_rules(b, i, 150, 30, **kw)
    got = port.mine_rules(b, i, 150, 30, device="cpu", **kw)
    assert len(got.cond_items) > 0
    assert_rules_equal(got, want)


def test_dense_and_host_paths_agree():
    """The reference's own case: both paths give each condition item the
    same consequents and scores (5 decimals)."""
    b, i = random_baskets(1, 50, 20, 400)
    dense = port.mine_rules(b, i, 50, 20, top_k=4, min_lift=0.0,
                            device="cpu")
    sparse = port.mine_rules(b, i, 50, 20, top_k=4, min_lift=0.0,
                             max_dense_items=1, device="cpu")
    np.testing.assert_array_equal(dense.cond_items, sparse.cond_items)
    for r in range(len(dense.cond_items)):
        pairs = [{(int(j), round(float(s), 5)) for j, s in zip(
            rules.cons_items[r], rules.scores[r]) if j >= 0}
            for rules in (dense, sparse)]
        assert pairs[0] == pairs[1]


def test_mine_rules_thresholds_and_ranking():
    """The reference's planted case: {0,1} in 6 of 10 baskets, {0,2} in 2,
    item 3 alone in 2."""
    b = [k for k in range(6) for _ in (0, 1)] + [6, 6, 7, 7, 8, 9]
    i = [0, 1] * 6 + [0, 2, 0, 2, 3, 3]
    rules = port.mine_rules(np.array(b, np.int32), np.array(i, np.int32), 10,
                            4, min_support=0.25, min_confidence=0.0,
                            min_lift=0.0, top_k=5, device="cpu")
    r0 = rules.lookup(0)
    assert list(rules.cons_items[r0][rules.cons_items[r0] >= 0]) == [1]
    assert rules.confidence[r0, 0] == pytest.approx(0.75)
    assert rules.lift[r0, 0] == pytest.approx(1.25)
    assert rules.support[r0, 0] == pytest.approx(0.6)
    assert rules.lookup(3) is None
    with pytest.raises(ValueError, match="score must be"):
        port.mine_rules(np.array(b), np.array(i), 10, 4, score="support",
                        device="cpu")


def test_sessionize_equals_reference():
    rng = np.random.default_rng(4)
    u = rng.integers(0, 30, 600).astype(np.int32)
    i = rng.integers(0, 50, 600).astype(np.int32)
    t = rng.uniform(0, 40_000, 600)
    want = ref.sessionize(u, i, t, window_s=3600.0)
    got = port.sessionize(u, i, t, window_s=3600.0)
    for a, w in zip(got[:2], want[:2]):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    assert got[2] == want[2]
    empty = port.sessionize(np.zeros(0), np.zeros(0), np.zeros(0), 60.0)
    assert empty[2] == 0 and empty[0].dtype == np.int32
