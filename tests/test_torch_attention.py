"""The port's `ops/attention.py::dense_attention` against the reference's
on the same seeded inputs, causal and not (the dense case of the
reference's tests/test_attention.py; the ring and Ulysses forms shard
over a device mesh and wait for the port's multi-device slice)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import attention as ref_attention
from predictionio_torch.ops import attention

torch.set_num_threads(1)


def qkv(b=2, h=4, sq=64, sk=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    dict(), dict(b=3, h=2, sq=32, sk=32, d=8), dict(b=1, h=1, sq=1, sk=1, d=4),
    dict(b=2, h=2, sq=8, sk=24, d=8)])
def test_matches_reference(causal, shape):
    """rtol 1e-5 / atol 1e-6; the last shape has more keys than queries,
    where the causal mask's diagonal is offset by sk − sq."""
    q, k, v = qkv(**shape, seed=len(shape))
    want = np.asarray(ref_attention.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = attention.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_causal_rows_ignore_the_future():
    """Under the causal mask a query's output is unchanged when the keys
    and values after it change, and the fully unmasked first query
    attends to key 0 alone."""
    q, k, v = (torch.from_numpy(a) for a in qkv(b=1, h=2, sq=16, sk=16, d=8))
    base = attention.dense_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 9:] += 3.0
    v2[:, :, 9:] -= 5.0
    moved = attention.dense_attention(q, k2, v2, causal=True)
    torch.testing.assert_close(moved[:, :, :9], base[:, :, :9], rtol=0,
                               atol=0)
    torch.testing.assert_close(base[:, :, 0], v[:, :, 0])
    assert attention._NEG_INF == ref_attention._NEG_INF
