"""The sessionrec template's encoder and scorer — the port of
``predictionio_tpu/templates/sessionrec/engine.py``'s `_encode` (:179),
`_scorer` (:204) and `_train_step` (:227).

Two formulations of one function, for two jobs:

- `encode` is the reference's formula in plain torch (matmuls,
  `ops.attention.dense_attention`, relu), differentiable: training runs
  on it (`train_params`). The gather of the embedding rows has a fixed
  order backward (`ops.text.scatter_add_rows`), so two fits on the card
  give the same bits.
- The scorer (`score`) holds the template's serving contract: a history
  scores bitwise the same at every sequence tier that fits it and in every
  batch that carries it. A BLAS product picks its kernel by shape and
  does not keep a row's order of summation at another batch, so the
  scorer sums in one fixed order a row. On a CUDA tensor it runs the two
  kernels of ``csrc/session.cu``, `session_encode` (one thread block per
  history) and `session_readout` (one thread per row and item), written
  so by construction; on a CPU tensor their plain versions,
  `session_encode_plain` and `session_readout_plain`, which compute every
  contraction and every softmax sum as elementwise multiplies and adds in
  ascending index order (no fused multiply-add, no reduction kernel), so
  a row's value depends on that row alone. Their exponentials run in
  float64 and round to float32: the CPU's vectorised and scalar `exp`
  may differ in the last place, and which one an element meets depends
  on where it lies in the tensor.

`launches` counts each kernel's launches (the plain versions never
count).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from predictionio_torch.ops.attention import _NEG_INF, dense_attention
from predictionio_torch.ops.text import scatter_add_rows

# kernel launches per wrapper (plain ints; the plain versions never count)
launches = {"session_encode": 0, "session_readout": 0}
_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2")
_max_shared: dict[int, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- training: the reference's formula ---------------------------------------

class _GatherRows(torch.autograd.Function):
    """table[ids] whose backward sums each row's gradients in a fixed
    order (`scatter_add_rows`), where `index_put_`'s accumulation on CUDA
    is free to reorder them."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.n_rows, grad.shape[1]))
        scatter_add_rows(out, ids, grad.contiguous())
        return out, None


def encode(params: dict, seq: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, L] padded item rows → [B, L, D] contextual states (the
    reference's `_encode`). Right-padded rows index the pad embedding
    (row V); causal attention keeps every real position a function of
    real positions only."""
    b, l = seq.shape
    emb = params["emb"]
    x = _GatherRows.apply(emb, seq.reshape(-1).long()).reshape(b, l, -1)
    x = x + params["pos"][:l][None, :, :]
    d = x.shape[-1]
    for blk in params["blocks"]:
        q = (x @ blk["wq"]).reshape(b, l, n_heads, -1).transpose(1, 2)
        k = (x @ blk["wk"]).reshape(b, l, n_heads, -1).transpose(1, 2)
        v = (x @ blk["wv"]).reshape(b, l, n_heads, -1).transpose(1, 2)
        a = dense_attention(q, k, v, causal=True)
        x = x + a.transpose(1, 2).reshape(b, l, d) @ blk["wo"]
        x = x + (torch.relu(x @ blk["w1"] + blk["b1"]) @ blk["w2"]
                 + blk["b2"])
    return x


def next_item_loss(params: dict, seq: torch.Tensor, lengths: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    """Masked next-item cross-entropy through the tied output embedding
    (the reference's `loss_fn`): position i predicts item i + 1 for
    i < length − 1, averaged over those positions."""
    x = encode(params, seq, n_heads)
    emb = params["emb"]
    n_items = emb.shape[0] - 1
    logp = torch.log_softmax(x[:, :-1] @ emb[:n_items].T, dim=-1)
    targets = seq[:, 1:].clamp(max=n_items - 1).long()
    positions = torch.arange(seq.shape[1] - 1, device=seq.device)
    mask = (positions[None, :] < (lengths - 1)[:, None]).to(logp.dtype)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _flat(params: dict) -> list:
    return [params["emb"], params["pos"],
            *(blk[k] for blk in params["blocks"] for k in _BLOCK_KEYS)]


def _unflat(tensors: Sequence, n_blocks: int) -> dict:
    it = iter(tensors)
    emb, pos = next(it), next(it)
    return {"emb": emb, "pos": pos,
            "blocks": [{k: next(it) for k in _BLOCK_KEYS}
                       for _ in range(n_blocks)]}


def train_params(params: dict, seq: np.ndarray, lengths: np.ndarray,
                 n_heads: int, lr: float, epochs: int,
                 device: torch.device) -> tuple[dict, np.ndarray]:
    """`epochs` full-batch Adam steps on `next_item_loss` on `device` (the
    reference's `_train_step`: its constants, and its bias correction
    1 − 0.9ᵗ, 1 − 0.999ᵗ on a float32 t). `params` is a dict of numpy
    arrays; returns the trained params as numpy arrays and each step's
    loss (float32, before that step's update)."""
    n_blocks = len(params["blocks"])
    leaves = [torch.as_tensor(np.asarray(p, np.float32), device=device)
              .clone() for p in _flat(params)]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    seq_t = torch.as_tensor(np.asarray(seq, np.int32), device=device)
    len_t = torch.as_tensor(np.asarray(lengths, np.int32), device=device)
    t = np.float32(0.0)
    losses = []
    for _ in range(int(epochs)):
        for p in leaves:
            p.requires_grad_(True)
        loss = next_item_loss(_unflat(leaves, n_blocks), seq_t, len_t,
                              n_heads)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        t = np.float32(t + np.float32(1.0))
        c1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        c2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        with torch.no_grad():
            for j, g in enumerate(grads):
                m[j] = 0.9 * m[j] + 0.1 * g
                v[j] = 0.999 * v[j] + 0.001 * g * g
                leaves[j] = leaves[j].detach() - lr * (m[j] / c1) / (
                    torch.sqrt(v[j] / c2) + 1e-8)
    out = _unflat([p.detach().cpu().numpy() for p in leaves], n_blocks)
    loss_arr = (torch.stack(losses).cpu().numpy() if losses
                else np.zeros(0, np.float32))
    return out, loss_arr


# -- serving: the scorer -----------------------------------------------------

def pack_blocks(blocks: Sequence[dict]) -> torch.Tensor:
    """The blocks' weights in one flat float32 tensor, block after block,
    each as wq, wk, wv, wo, w1, b1, w2, b2 (row-major): the layout
    `session_encode` reads."""
    return torch.cat([blk[k].reshape(-1).float() for blk in blocks
                      for k in _BLOCK_KEYS]).contiguous()


def params_on(params: dict, device: torch.device) -> dict:
    """The scorer's params: `params` (numpy arrays) as float32 tensors on
    `device`, with the blocks also packed (`"packed"`, `pack_blocks`)."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    out = {"emb": put(params["emb"]), "pos": put(params["pos"]),
           "blocks": [{k: put(w) for k, w in blk.items()}
                      for blk in params["blocks"]]}
    out["packed"] = pack_blocks(out["blocks"])
    return out


def _mm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N], each output summed over k in ascending order
    as an elementwise multiply, then add."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def _exp_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def session_encode_plain(params: dict, seq: torch.Tensor,
                         lengths: torch.Tensor, n_heads: int) -> torch.Tensor:
    """`session_encode`'s plain version: h [B, D], the state at position
    clip(length − 1, 0, L − 1) of each row of seq [B, L], every sum in
    ascending index as elementwise multiplies and adds."""
    b, l = seq.shape
    x = params["emb"][seq.long()] + params["pos"][:l][None, :, :]
    d = x.shape[-1]
    dh = d // n_heads
    scale = math.sqrt(dh)
    causal = torch.ones((l, l), dtype=torch.bool, device=seq.device).tril()
    for blk in params["blocks"]:
        q, k, v = (_mm_plain(x, blk[w]).reshape(b, l, n_heads, dh)
                   .transpose(1, 2) for w in ("wq", "wk", "wv"))
        s = q[:, :, :, None, 0] * k[:, :, None, :, 0]  # [B, H, L, L]
        for c in range(1, dh):
            s = s + q[:, :, :, None, c] * k[:, :, None, :, c]
        s = (s / scale).masked_fill(~causal, _NEG_INF)
        e = _exp_plain(s - s.amax(dim=-1, keepdim=True))
        den = e[..., 0:1]
        for j in range(1, l):
            den = den + e[..., j:j + 1]
        p = e / den
        a = p[..., 0:1] * v[:, :, None, 0, :]  # [B, H, L, dh]
        for j in range(1, l):
            a = a + p[..., j:j + 1] * v[:, :, None, j, :]
        x = x + _mm_plain(a.transpose(1, 2).reshape(b, l, d), blk["wo"])
        hid = torch.relu(_mm_plain(x, blk["w1"]) + blk["b1"])
        x = x + (_mm_plain(hid, blk["w2"]) + blk["b2"])
    idx = (lengths.long() - 1).clamp(0, l - 1)
    return x[torch.arange(b, device=seq.device), idx]


def session_readout_plain(h: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """`session_readout`'s plain version: scores [B, V] = h @ itemsᵀ, each
    summed over D in ascending k."""
    acc = h[:, 0:1] * items[:, 0][None, :]
    for k in range(1, h.shape[1]):
        acc = acc + h[:, k:k + 1] * items[:, k][None, :]
    return acc


def _lib():
    from predictionio_torch.ops import _build

    lib = _build.load("session")
    if not getattr(lib, "_pio_bound", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.session_max_shared_bytes.argtypes = [i32]
        lib.session_max_shared_bytes.restype = i32
        lib.session_work_floats.argtypes = [i32, i32, i32]
        lib.session_work_floats.restype = i64
        lib.session_slots.argtypes = []
        lib.session_slots.restype = i32
        lib.session_encode.argtypes = [p, p, p, i32, p, p, p, p, i64, i32,
                                       i32, i32, ctypes.c_float, i32, p]
        lib.session_encode.restype = i32
        lib.session_readout.argtypes = [p, p, p, i64, i64, i32, p]
        lib.session_readout.restype = i32
        lib._pio_bound = True
    return lib


def _check_f32(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous float32, got "
                             f"{t.dtype}")


def encode_shared_fits(l: int, d: int, n_heads: int,
                       device: torch.device) -> bool:
    """Whether one block of `session_encode` keeps a row's working set in
    shared memory at tier `l`; otherwise a device workspace holds it."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    if idx not in _max_shared:
        _max_shared[idx] = lib.session_max_shared_bytes(idx)
    return lib.session_work_floats(l, d, n_heads) * 4 <= _max_shared[idx]


def session_encode(emb: torch.Tensor, pos: torch.Tensor,
                   packed: torch.Tensor, n_blocks: int, seq: torch.Tensor,
                   lengths: torch.Tensor, n_heads: int) -> torch.Tensor:
    """h [B, D]: the encoder's state at each row's last real position, on
    the card (`csrc/session.cu`). emb [V+1, D], pos [Lpos ≥ L, D] and the
    packed blocks (`pack_blocks`) float32; seq [B, L] and lengths [B]
    int32, every id in [0, V]. Raises on a CPU tensor: callers that may
    hold one go through `score`."""
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError("session_encode: needs CUDA tensors (the plain "
                         "version is session_encode_plain)")
    _check_f32("session_encode", dev, emb=emb, pos=pos, packed=packed)
    b, l = seq.shape
    d = emb.shape[1]
    if (d % n_heads or pos.shape[0] < l or pos.shape[1] != d
            or packed.numel() != n_blocks * (8 * d * d + 3 * d)
            or lengths.shape != (b,) or seq.dtype != torch.int32
            or lengths.dtype != torch.int32 or lengths.device != dev
            or not seq.is_contiguous() or not lengths.is_contiguous()):
        raise ValueError(f"session_encode: bad shapes or types: emb "
                         f"{tuple(emb.shape)}, pos {tuple(pos.shape)}, "
                         f"packed {packed.numel()} for {n_blocks} blocks, "
                         f"seq {tuple(seq.shape)} {seq.dtype}, lengths "
                         f"{tuple(lengths.shape)} {lengths.dtype}, "
                         f"{n_heads} heads")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _lib()
    scratch, grid = None, 0
    if not encode_shared_fits(l, d, n_heads, dev):
        grid = min(b, lib.session_slots())
        scratch = torch.empty(grid * lib.session_work_floats(l, d, n_heads),
                              dtype=torch.float32, device=dev)
    scale = float(np.float32(math.sqrt(d // n_heads)))
    err = lib.session_encode(
        emb.data_ptr(), pos.data_ptr(), packed.data_ptr(), n_blocks,
        seq.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, l, d, n_heads,
        scale, grid, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"session_encode launch failed: CUDA error {err} "
                           f"(B={b}, L={l}, D={d}, H={n_heads})")
    launches["session_encode"] += 1
    return out


def session_readout(h: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """scores [B, V] = h [B, D] @ items [V, D]ᵀ on the card
    (`csrc/session.cu`); both contiguous float32. Raises on a CPU
    tensor: the plain version is `session_readout_plain`."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError("session_readout: needs CUDA tensors (the plain "
                         "version is session_readout_plain)")
    _check_f32("session_readout", dev, h=h, items=items)
    if h.dim() != 2 or items.dim() != 2 or items.shape[1] != h.shape[1]:
        raise ValueError(f"session_readout: shapes {tuple(h.shape)} and "
                         f"{tuple(items.shape)} are not [B, D] and [V, D]")
    b, d = h.shape
    v = items.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    if b == 0 or v == 0:
        return out
    err = _lib().session_readout(h.data_ptr(), items.data_ptr(),
                                 out.data_ptr(), b, v, d,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"session_readout launch failed: CUDA error {err} "
                           f"(B={b}, V={v}, D={d})")
    launches["session_readout"] += 1
    return out


def score(params: dict, seq: torch.Tensor, lengths: torch.Tensor,
          n_heads: int) -> torch.Tensor:
    """Next-item scores [B, V] of the histories seq [B, L] (int32, right-
    padded with the pad row V) of lengths [B] (int32): the encoder's state
    at each row's last real position against the tied item embedding.
    `params` is `params_on(…)` for seq's device; a CUDA seq runs
    `session_encode` and `session_readout`, a CPU seq their plain
    versions."""
    emb = params["emb"]
    items = emb[:-1]
    if seq.device.type == "cpu":
        h = session_encode_plain(params, seq, lengths, n_heads)
        return session_readout_plain(h, items)
    h = session_encode(emb, params["pos"], params["packed"],
                       len(params["blocks"]), seq, lengths, n_heads)
    return session_readout(h, items)
