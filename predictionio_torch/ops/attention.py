"""Dense attention — the port of ``predictionio_tpu/ops/attention.py``'s
`dense_attention`, in plain torch.

The sessionrec template trains through it (`ops/session.py::encode`).
The reference's sequence-parallel forms, `ring_attention`,
`ulysses_attention` and `sequence_sharded_attention`, shard the sequence
over a device mesh; they wait for the port's multi-device slice.
Shapes: [batch, heads, seq, head_dim].
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows
# NaN-free after softmax


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Single-device attention. q, k, v: [B, H, S, D]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
