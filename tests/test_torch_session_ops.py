"""The sessionrec scorer's plain versions (`ops/session.py`) on the CPU:
against the reference's `_encode` + readout (templates/sessionrec/
engine.py:179-222) on the same params within rtol 1e-5 / atol 1e-6,
against the port's BLAS formulation (`encode`), and bitwise within the
port: every history scores the same alone and in every batch that
carries it, at every sequence tier that fits it (8, 16, 32, and the
PIO_SERVING_SEQ_TIERS ladder 5, 12). The kernels themselves run on the
card only (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.templates.sessionrec import engine as ref_engine
from predictionio_torch.ops import session
from predictionio_torch.templates.sessionrec import engine as port_engine

torch.set_num_threads(1)

V = 300


def inputs(d, n_blocks, l_pos=32, b=16, seed=0):
    """The template's seeded init and b right-padded histories of
    lengths 1..l_pos (distinct items; the first of length 1, the second
    of l_pos)."""
    rng = np.random.default_rng(seed)
    params = port_engine.init_params(V, d, n_blocks, l_pos,
                                     np.random.default_rng(seed + 1))
    lengths = rng.integers(1, l_pos + 1, b).astype(np.int32)
    lengths[:2] = (1, l_pos)
    seq = np.full((b, l_pos), V, np.int32)
    for r, n in enumerate(lengths):
        seq[r, :n] = rng.choice(V, n, replace=False)
    return params, seq, lengths


def on_cpu(params):
    return session.params_on(params, torch.device("cpu"))


def ref_scores(params, seq, lengths, n_heads):
    x = np.asarray(ref_engine._encode(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(seq),
        n_heads))
    idx = np.clip(lengths - 1, 0, seq.shape[1] - 1)
    h = x[np.arange(len(seq)), idx]
    return h, h @ params["emb"][:V].T


def plain_scores(params, seq, lengths, n_heads):
    p = on_cpu(params)
    h = session.session_encode_plain(p, torch.from_numpy(seq),
                                     torch.from_numpy(lengths), n_heads)
    return h, session.session_readout_plain(h, p["emb"][:-1])


CONFIGS = [(16, 1, 2), (8, 1, 2), (16, 2, 2), (8, 2, 4)]


@pytest.mark.parametrize("d,n_blocks,n_heads", CONFIGS)
def test_plain_matches_reference(d, n_blocks, n_heads):
    """The template's width (D 16, 1 block, 2 heads) and the eval grid's
    D 8 and 2 blocks, on the reference's formula at rtol 1e-5 / atol
    1e-6."""
    params, seq, lengths = inputs(d, n_blocks, seed=d * n_blocks)
    want_h, want = ref_scores(params, seq, lengths, n_heads)
    h, got = plain_scores(params, seq, lengths, n_heads)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the scorer takes the plain versions for CPU tensors
    p = on_cpu(params)
    np.testing.assert_array_equal(
        session.score(p, torch.from_numpy(seq), torch.from_numpy(lengths),
                      n_heads).numpy(), got.numpy())


@pytest.mark.parametrize("d,n_blocks,n_heads", CONFIGS[:3])
def test_plain_matches_the_blas_encode(d, n_blocks, n_heads):
    """The fixed-order formulation against the port's training one
    (`encode`: matmuls and `dense_attention`) at each last real
    position."""
    params, seq, lengths = inputs(d, n_blocks, seed=7)
    h, _ = plain_scores(params, seq, lengths, n_heads)
    x = session.encode(on_cpu(params), torch.from_numpy(seq), n_heads)
    want = x[torch.arange(len(seq)),
             torch.from_numpy(np.clip(lengths - 1, 0, 31)).long()]
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tiers", [(8, 16, 32), (5, 12, 32)])
@pytest.mark.parametrize("d,n_blocks,n_heads", CONFIGS[:3])
def test_bitwise_batched_and_single_at_every_tier(d, n_blocks, n_heads,
                                                  tiers):
    """Each history's scores alone at every tier that fits it, and as a
    row of batches of 1, 2, 4 … 16 padded to the smallest tier that
    fits the batch, are bitwise equal."""
    params, seq, lengths = inputs(d, n_blocks, b=16, seed=3)
    p = on_cpu(params)

    def score(rows, tier):
        s = np.full((len(rows), tier), V, np.int32)
        for r, row in enumerate(rows):
            s[r, :len(row)] = row
        lens = np.asarray([len(r) for r in rows], np.int32)
        return session.score(p, torch.from_numpy(s), torch.from_numpy(lens),
                             n_heads)

    rows = [seq[r, :lengths[r]] for r in range(len(seq))]
    singles = []
    for row in rows:
        fits = [t for t in tiers if t >= len(row)]
        alone = [score([row], t)[0] for t in fits]
        for other in alone[1:]:
            assert torch.equal(other, alone[0])
        singles.append(alone[0])
    b = 1
    while b <= len(rows):
        tier = min(t for t in tiers if t >= max(len(r) for r in rows[:b]))
        batch = score(rows[:b], tier)
        for r in range(b):
            assert torch.equal(batch[r], singles[r]), (b, r)
        b *= 2


def test_pack_blocks_layout():
    """Each block as wq, wk, wv, wo, w1, b1, w2, b2, block after block:
    8·D² + 3·D floats a block."""
    params, _, _ = inputs(8, 2)
    p = on_cpu(params)
    packed = session.pack_blocks(p["blocks"])
    assert packed.shape == (2 * (8 * 64 + 3 * 8),)
    blk1 = packed[8 * 64 + 24:]
    torch.testing.assert_close(blk1[:64].reshape(8, 8), p["blocks"][1]["wq"],
                               rtol=0, atol=0)
    torch.testing.assert_close(blk1[-8:], p["blocks"][1]["b2"], rtol=0,
                               atol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors only; CPU callers go
    through `score`, which takes the plain versions."""
    params, seq, lengths = inputs(8, 1)
    p = on_cpu(params)
    with pytest.raises(ValueError, match="CUDA"):
        session.session_encode(p["emb"], p["pos"], p["packed"], 1,
                               torch.from_numpy(seq),
                               torch.from_numpy(lengths), 2)
    with pytest.raises(ValueError, match="CUDA"):
        session.session_readout(torch.zeros(2, 8), p["emb"][:-1])
    assert session.launches == {"session_encode": 0, "session_readout": 0}
