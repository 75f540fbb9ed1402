"""The session kernels' launch plan (`ops/session.py::launch_plan`) on the
CPU: the kernels themselves run on the card only (tests/test_torch_cuda.py
holds them against their first and plain versions at the plan's
B-dependent shapes), but their routing and grids are computed in Python.
`encode_schedule` / `readout_schedule` below are a copy of the kernels'
index loops in `csrc/session.cu` (launch_encode's bodies, the readout's
tile loop) and walk a plan's grids as those loops do. Every batch tier
1-64 and the wide batches 128-4 096 × seq tier 5-256 × (V, D, blocks,
heads): each history encoded once, each (row, item) scored once, the warp
body only where L ≤ 32 and its shared bytes fit the card's 232 448."""

import numpy as np
import pytest
import torch

from predictionio_torch.ops import _build, session

H100_SHARED = 232_448  # bytes a block may opt into on the H100
H100_SMS = 132  # the H100 SXM's SMs
H100 = (H100_SHARED, H100_SMS)
BATCH_TIERS = (1, 2, 4, 8, 16, 32, 64)
# batches past the tiers (an evaluation fold through one batch_predict):
# the readout's 32- and 64-row groups, 2 and 8 warp histories a block
WIDE_BATCHES = (128, 512, 4_096)
SEQ_TIERS = (5, 8, 12, 16, 32, 64, 256)
# the template's width, the eval grid's D 8 and 2 blocks, and the card
# test's wide case (its workspace route at L 256)
CONFIGS = [(8_192, 16, 1, 2), (8_192, 8, 1, 2), (8_192, 16, 2, 2),
           (500, 64, 2, 4)]


def encode_schedule(plan: session.LaunchPlan) -> np.ndarray:
    """The histories the encoder's grid visits, as its loops walk them: the
    warp body's warp w of block x takes x·k + w, then steps by grid·k
    (k histories a block); the block body's block x takes x, then steps by
    the grid."""
    if plan.body == "none":
        return np.zeros(0, np.int64)
    per = plan.histories if plan.body == "warp" else 1
    stride = plan.enc_grid * per
    return np.concatenate([np.arange(first, plan.b, stride)
                           for first in range(stride)])


def readout_schedule(plan: session.LaunchPlan) -> tuple:
    """How many times the readout's grid takes each row [B] and each item
    [V], as its loops walk them: block (x, y) takes items [128x, 128x +
    128) (lane t, its items t + 32u, u < 4) and row groups y, y + grid_y,
    …; in a group warp w takes the rows w + 16t and w + 16t + 8. Every x
    walks the same rows, so score (r, v) is written rows[r] · items[v]
    times."""
    gx, gy = plan.rd_grid
    items = np.zeros(plan.v, np.int32)
    per_lane = (np.arange(32)[:, None] + 32 * np.arange(4)[None, :]).ravel()
    for x in range(gx):
        v0 = x * session.READOUT_TILE
        np.add.at(items, v0 + per_lane[per_lane < min(session.READOUT_TILE,
                                                      plan.v - v0)], 1)
    rows = np.zeros(plan.b, np.int32)
    warps = session.READOUT_THREADS // 32
    for y in range(gy):
        for g in range(y, -(-plan.b // plan.rd_rows), gy):
            r0 = g * plan.rd_rows
            nr = min(plan.rd_rows, plan.b - r0)
            np.add.at(rows, [r0 + r + s for w in range(warps)
                             for r in range(w, nr, 2 * warps)
                             for s in (0, warps) if r + s < nr], 1)
    return rows, items


@pytest.mark.parametrize("v,d,n_blocks,heads", CONFIGS)
@pytest.mark.parametrize("l", SEQ_TIERS)
@pytest.mark.parametrize("b", BATCH_TIERS)
def test_plan_covers_every_history_and_score_once(b, l, v, d, n_blocks,
                                                  heads):
    plan = session.launch_plan(b, l, d, heads, v, n_blocks, *H100)
    np.testing.assert_array_equal(np.sort(encode_schedule(plan)),
                                  np.arange(b))
    rows, items = readout_schedule(plan)
    assert rows.shape == (b,) and (rows == 1).all()
    assert items.shape == (v,) and (items == 1).all()
    # the routing: the warp body only where L ≤ 32 and it fits
    warp_fits = session.warp_shared_bytes(l, d, n_blocks, 1) <= H100_SHARED
    if l <= 32 and (d, heads) in session.WARP_SHAPES and warp_fits:
        assert plan.body == "warp"
        assert plan.enc_shared == session.warp_shared_bytes(
            l, d, n_blocks, plan.histories) <= H100_SHARED
        assert plan.enc_threads == 32 * plan.histories
    elif session.work_floats(l, d, heads) * 4 <= H100_SHARED:
        assert plan.body == "block" and plan.enc_grid == b
        assert plan.enc_shared == session.work_floats(l, d, heads) * 4
    else:
        assert plan.body == "block_workspace"
        assert plan.scratch_floats == (
            min(b, session.WORKSPACE_SLOTS) * session.work_floats(l, d, heads))
    assert plan.body != "warp" or (l <= 32 and plan.enc_shared <= H100_SHARED)
    assert plan.rd_shared <= H100_SHARED
    if v == 8_192:
        # B 1 spreads over at least 32 SMs, B 64 over all of them
        blocks = plan.rd_grid[0] * plan.rd_grid[1]
        assert blocks >= (H100_SMS if b == 64 else 32)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("l", [32, 64])
@pytest.mark.parametrize("b", WIDE_BATCHES)
def test_wide_batches_share_blocks_and_widen_row_groups(b, l, sms):
    """Past the batch tiers the warp body puts several histories in a
    block (about 2·sms blocks, at most 8 a block) and the readout takes
    wider row groups, and the grids still cover each history and score
    once; at L 64 the block body keeps its working set in shared memory.
    114 is the H100 PCIe's SM count."""
    plan = session.launch_plan(b, l, 16, 2, 8_192, 1, H100_SHARED, sms)
    np.testing.assert_array_equal(np.sort(encode_schedule(plan)),
                                  np.arange(b))
    rows, items = readout_schedule(plan)
    assert (rows == 1).all() and (items == 1).all()
    if l == 32:
        assert plan.body == "warp"
        assert plan.histories == min(8, -(-b // (2 * sms)))
        assert plan.enc_grid == -(-b // plan.histories)
    else:
        assert plan.body == "block" and plan.enc_grid == b
    assert plan.rd_rows == (32 if b == 128 and sms == H100_SMS else 64)
    assert plan.rd_grid == (64, -(-b // plan.rd_rows))

def test_template_shapes_take_the_warp_body():
    """The template's serving tiers (8, 16, 32 and 5, 12) at D 16 and the
    eval grid's D 8, 1 or 2 blocks, take the warp body at every batch
    tier; L 64 and above take the block body."""
    for l in (5, 8, 12, 16, 32):
        for d, n_blocks in ((16, 1), (8, 1), (16, 2), (8, 2)):
            for b in BATCH_TIERS:
                plan = session.launch_plan(b, l, d, 2, 8_192, n_blocks,
                                           *H100)
                assert plan.body == "warp", plan
    assert session.launch_plan(64, 64, 16, 2, 8_192, 1,
                               *H100).body == "block"
    assert session.launch_plan(6, 256, 64, 4, 500, 2,
                               *H100).body == "block_workspace"


@pytest.mark.parametrize("max_shared,n_blocks,want", [
    (48 * 1024, 1, "warp"), (48 * 1024, 8, "block"),
    (20_000, 1, "warp"), (17_000, 1, "block_workspace"),
])
def test_warp_body_only_where_its_shared_bytes_fit(max_shared, n_blocks,
                                                   want):
    """A card with less shared memory (or more blocks' weights) moves the
    tier-32 history off the warp body; a warp body takes fewer histories a
    block before it gives up."""
    plan = session.launch_plan(64, 32, 16, 2, 8_192, n_blocks, max_shared,
                               H100_SMS)
    assert plan.body == want
    if want == "warp":
        assert plan.enc_shared <= max_shared
    wide = session.launch_plan(4_096, 32, 16, 2, 8_192, 1, 48 * 1024,
                               H100_SMS)
    assert wide.body == "warp" and wide.enc_shared <= 48 * 1024
    assert 1 <= wide.histories < session.WARP_MAX_HISTORIES


@pytest.mark.parametrize("b,v", [(0, 8_192), (16, 0), (0, 0)])
def test_plan_handles_empty_batches_and_catalogs(b, v):
    plan = session.launch_plan(b, 16, 16, 2, v, 1, *H100)
    assert (plan.body == "none") == (b == 0)
    assert plan.rd_grid == (0, 0)
    assert len(encode_schedule(plan)) == b
    rows, items = readout_schedule(plan)
    assert rows.shape == (b,) and items.shape == (v,)


def test_plan_array_is_what_the_kernels_read():
    """`csrc/session.cu`'s PlanEntry order, and one cached plan a shape."""
    plan = session.launch_plan(64, 32, 16, 2, 8_192, 1, *H100)
    assert list(plan.array) == [
        1, plan.enc_grid, plan.enc_threads, plan.enc_shared, *plan.rd_grid,
        plan.rd_shared, plan.rd_rows, 64, 32, 16, 2, 8_192, 1]
    assert session.launch_plan(64, 32, 16, 2, 8_192, 1, *H100) is plan
    assert plan.scale == float(np.float32(np.sqrt(8)))
    rows, cols = plan.score_shape()
    assert cols == 8_192 and (rows - 64) * cols >= 64 * 16
    with pytest.raises(ValueError, match="heads"):
        session.launch_plan(4, 8, 16, 3, 100, 1, *H100)


def test_cpu_score_never_loads_the_library(monkeypatch):
    """`score` on CPU tensors runs the plain versions: no build, no load,
    no launch counted."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(session, "_LIB", None)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((41, 8)).astype(np.float32)
    params = {"emb": emb, "pos": rng.standard_normal((8, 8), np.float32),
              "blocks": [{k: rng.standard_normal(s, np.float32) * 0.1
                          for k, s in (("wq", (8, 8)), ("wk", (8, 8)),
                                       ("wv", (8, 8)), ("wo", (8, 8)),
                                       ("w1", (8, 16)), ("b1", (16,)),
                                       ("w2", (16, 8)), ("b2", (8,)))}]}
    p = session.params_on(params, torch.device("cpu"))
    session.reset_launches()
    seq = torch.full((3, 8), 40, dtype=torch.int32)
    seq[:, :3] = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    got = session.score(p, seq, torch.tensor([3, 2, 1], dtype=torch.int32), 2)
    assert got.shape == (3, 40) and torch.isfinite(got).all()
    assert session._LIB is None and "session" not in _build._libs
    assert session.launches == {"session_encode": 0, "session_readout": 0}
    assert session.launches_v1 == {"session_encode_v1": 0,
                                   "session_readout_v1": 0}


def test_first_versions_refuse_cpu_tensors():
    """The kept first versions launch on CUDA tensors only, like the
    kernels that replaced them."""
    emb = torch.zeros(11, 8)
    with pytest.raises(ValueError, match="CUDA"):
        session.session_encode_v1(emb, torch.zeros(8, 8),
                                  torch.zeros(8 * 64 + 24), 1,
                                  torch.zeros((2, 8), dtype=torch.int32),
                                  torch.ones(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        session.session_readout_v1(torch.zeros(2, 8), emb[:-1])
    assert session.launches_v1 == {"session_encode_v1": 0,
                                   "session_readout_v1": 0}
