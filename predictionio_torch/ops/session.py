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
  kernels of ``csrc/session.cu`` as one launch pair (`session_score`):
  `session_encode` (a warp a history where the tier allows, else a
  thread block a history) and `session_readout` (item tiles in shared
  memory), written so by construction, and the same bits as their first
  versions (`session_encode_v1`, `session_readout_v1`, kept for the A/B
  on the card). `launch_plan` routes the bodies and sizes the grids by
  shape. On a CPU tensor it runs their plain versions,
  `session_encode_plain` and `session_readout_plain`, which compute every
  contraction and every softmax sum as elementwise multiplies and adds in
  ascending index order (no fused multiply-add, no reduction kernel), so
  a row's value depends on that row alone. Their exponentials run in
  float64 and round to float32: the CPU's vectorised and scalar `exp`
  may differ in the last place, and which one an element meets depends
  on where it lies in the tensor.

`launches` counts each kernel's launches (`score` adds one to each), and
`launches_v1` the first versions' (the plain versions never count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from predictionio_torch.ops.attention import _NEG_INF, dense_attention
from predictionio_torch.ops.text import scatter_add_rows

# kernel launches per wrapper (plain ints; the plain versions never count)
launches = {"session_encode": 0, "session_readout": 0}
# the first versions' launches (the A/B on the card; no path calls them)
launches_v1 = {"session_encode_v1": 0, "session_readout_v1": 0}
_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2")
_card_limits: dict[int, tuple[int, int]] = {}


def reset_launches() -> None:
    for counts in (launches, launches_v1):
        for name in counts:
            counts[name] = 0


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


# -- the kernels: launch plan ------------------------------------------------

# The warp body's instantiations (D, H) (`csrc/session.cu`), its longest
# tier (a lane a position) and its most histories a block.
WARP_SHAPES = frozenset({(8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (16, 4)})
WARP_MAX_L = 32
WARP_MAX_HISTORIES = 8
# The block body's threads and the workspace variant's slots.
BLOCK_THREADS, WORKSPACE_SLOTS = 128, 1024
# The readout's threads, items a block, and its row groups, widest first.
READOUT_THREADS, READOUT_TILE, READOUT_ROWS = 256, 128, (64, 32, 16)
_GRID_Y_MAX = 65_535
# The encoder's bodies, by their number in the plan (`session.cu`'s Body).
BODIES = ("none", "warp", "block", "block_workspace")


def work_floats(l: int, d: int, n_heads: int) -> int:
    """Floats of one history's working set in the block body at tier `l`
    (`session.cu`'s work_floats): x, q, k, v, a and the scores."""
    return 5 * l * d + n_heads * l * l


def warp_shared_bytes(l: int, d: int, n_blocks: int, histories: int) -> int:
    """Shared bytes of a warp-body block holding `histories` histories:
    the mbarrier's 16 bytes, the weights rounded up to 4 floats, and per
    warp k and v [l, d + 4] and the lanes' score rows [32, (l + 1) | 1]."""
    weights = n_blocks * (8 * d * d + 3 * d)
    per_warp = 2 * l * (d + 4) + 32 * ((l + 1) | 1)
    return 16 + 4 * (-(-weights // 4) * 4) + 4 * histories * per_warp


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Where and how `session_encode`, `session_readout` and `score`
    launch for one shape: the encoder's body (`BODIES`), grid, threads,
    shared bytes, histories a block (warp body) and workspace floats; the
    readout's grid (item tiles, row groups launched), rows a group and
    shared bytes. `array` holds them as `csrc/session.cu` reads them (its
    PlanEntry order), at `address`."""

    b: int
    l: int
    d: int
    heads: int
    v: int
    n_blocks: int
    body: str
    enc_grid: int
    enc_threads: int
    enc_shared: int
    histories: int
    scratch_floats: int
    rd_grid: tuple
    rd_rows: int
    rd_shared: int
    scale: float
    array: ctypes.Array = dataclasses.field(init=False, repr=False,
                                            compare=False)
    address: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        array = (ctypes.c_int64 * 14)(
            BODIES.index(self.body), self.enc_grid, self.enc_threads,
            self.enc_shared, *self.rd_grid, self.rd_shared, self.rd_rows,
            self.b, self.l, self.d, self.heads, self.v, self.n_blocks)
        object.__setattr__(self, "array", array)
        object.__setattr__(self, "address", ctypes.addressof(array))

    def score_shape(self) -> tuple[int, int]:
        """Rows × V of `score`'s one allocation: the scores [B, V], then
        h [B, D] and the workspace in the rows after."""
        extra = self.b * self.d + self.scratch_floats
        return self.b + -(-extra // self.v), self.v


@functools.lru_cache(maxsize=4096)
def launch_plan(b: int, l: int, d: int, n_heads: int, v: int, n_blocks: int,
                max_shared: int, sms: int) -> LaunchPlan:
    """The launch plan of B histories at tier L (0: no encoder), width D,
    H heads, V items (0: no readout) and n_blocks blocks on a card of
    `sms` SMs whose blocks may opt into `max_shared` shared bytes.

    The encoder takes the warp body (a warp a history) where L ≤ 32,
    (D, H) is one of WARP_SHAPES, there are blocks' weights to stage and
    a block of one history fits in shared memory, with as many histories
    a block (up to 8) as keep about 2·sms blocks; else the block body (a
    block a history), its working set in shared memory where it fits,
    else in a workspace of min(B, WORKSPACE_SLOTS) slots. The readout
    tiles V by READOUT_TILE and takes the widest row group of READOUT_ROWS
    that still gives sms blocks (else the narrowest)."""
    if n_heads <= 0 or d % n_heads:
        raise ValueError(f"launch_plan: {n_heads} heads do not divide D {d}")
    body, enc_grid, enc_threads, enc_shared, hist, scratch = \
        "none", 0, 0, 0, 0, 0
    if b > 0 and l > 0:
        if (l <= WARP_MAX_L and (d, n_heads) in WARP_SHAPES and n_blocks > 0
                and warp_shared_bytes(l, d, n_blocks, 1) <= max_shared):
            hist = min(WARP_MAX_HISTORIES, max(1, -(-b // (2 * sms))))
            while warp_shared_bytes(l, d, n_blocks, hist) > max_shared:
                hist -= 1
            body, enc_threads = "warp", 32 * hist
            enc_grid = -(-b // hist)
            enc_shared = warp_shared_bytes(l, d, n_blocks, hist)
        elif work_floats(l, d, n_heads) * 4 <= max_shared:
            body, enc_threads = "block", BLOCK_THREADS
            enc_grid = min(b, 2 ** 31 - 1)
            enc_shared = work_floats(l, d, n_heads) * 4
        else:
            body, enc_threads = "block_workspace", BLOCK_THREADS
            enc_grid = min(b, WORKSPACE_SLOTS)
            scratch = enc_grid * work_floats(l, d, n_heads)
    rd_grid, rd_rows, rd_shared = (0, 0), READOUT_ROWS[-1], 0
    if b > 0 and v > 0:
        tiles = -(-v // READOUT_TILE)
        rd_rows = next((r for r in READOUT_ROWS if tiles * -(-b // r) >= sms),
                       READOUT_ROWS[-1])
        rd_grid = (tiles, min(-(-b // rd_rows), _GRID_Y_MAX))
        rd_shared = 4 * (READOUT_TILE * (d | 1) + rd_rows * d)
        if rd_shared > max_shared:
            raise ValueError(f"launch_plan: D {d} is too wide for the "
                             f"readout's item tile ({rd_shared} shared bytes, "
                             f"the card has {max_shared})")
    return LaunchPlan(
        b=b, l=l, d=d, heads=n_heads, v=v, n_blocks=n_blocks, body=body,
        enc_grid=enc_grid, enc_threads=enc_threads, enc_shared=enc_shared,
        histories=hist, scratch_floats=scratch, rd_grid=rd_grid,
        rd_rows=rd_rows, rd_shared=rd_shared,
        scale=float(np.float32(math.sqrt(d // n_heads))))


# -- the kernels: wrappers ---------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from predictionio_torch.ops import _build

        lib = _build.load("session")
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_float)
        lib.session_max_shared_bytes.argtypes = [i32]
        lib.session_max_shared_bytes.restype = i32
        lib.session_encode.argtypes = [p, p, p, p, p, p, p, p, f32, p]
        lib.session_encode.restype = i32
        lib.session_readout.argtypes = [p, p, p, p, p]
        lib.session_readout.restype = i32
        lib.session_score.argtypes = [p, p, p, p, p, p, p, f32, p]
        lib.session_score.restype = i32
        lib.session_encode_v1.argtypes = [p, p, p, i32, p, p, p, p, i64, i32,
                                          i32, i32, f32, i32, p]
        lib.session_encode_v1.restype = i32
        lib.session_readout_v1.argtypes = [p, p, p, i64, i64, i32, p]
        lib.session_readout_v1.restype = i32
        _LIB = lib
    return _LIB


def _stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as an integer handle."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def card_limits(index: int) -> tuple[int, int]:
    """Device `index`'s shared bytes a block may opt into and its SM count
    (`launch_plan`'s last two arguments), read once a device."""
    limits = _card_limits.get(index)
    if limits is None:
        shared = _lib().session_max_shared_bytes(index)
        if shared <= 0:
            raise RuntimeError(f"session: cannot read device {index}'s "
                               f"shared memory limit")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        limits = _card_limits[index] = (shared, sms)
    return limits


def _f32_on(device: torch.device, *tensors: torch.Tensor) -> bool:
    """Whether every tensor is contiguous float32 on `device` (written out:
    this runs on every served query)."""
    for t in tensors:
        if (t.dtype is not torch.float32 or t.device != device
                or not t.is_contiguous()):
            return False
    return True


def _check_encode_args(name: str, emb, pos, packed, n_blocks: int, seq,
                       lengths, n_heads: int) -> torch.device:
    dev = seq.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors (the plain version is "
                         f"session_encode_plain)")
    b, l = seq.shape
    d = emb.shape[1]
    if (not _f32_on(dev, emb, pos, packed) or d % n_heads
            or pos.shape[0] < l or pos.shape[1] != d
            or packed.numel() != n_blocks * (8 * d * d + 3 * d)
            or packed.data_ptr() % 16  # the warp body's bulk copy
            or seq.dtype is not torch.int32
            or lengths.dtype is not torch.int32 or lengths.shape != (b,)
            or lengths.device != dev or not seq.is_contiguous()
            or not lengths.is_contiguous()):
        raise ValueError(f"{name}: bad devices, shapes or types (want "
                         f"contiguous float32 emb, pos, packed (16-byte "
                         f"aligned) and int32 seq, lengths on {dev}): emb "
                         f"{tuple(emb.shape)} {emb.dtype} {emb.device}, pos "
                         f"{tuple(pos.shape)}, "
                         f"packed {packed.numel()} for {n_blocks} blocks, "
                         f"seq {tuple(seq.shape)} {seq.dtype}, lengths "
                         f"{tuple(lengths.shape)} {lengths.dtype}, "
                         f"{n_heads} heads")
    return dev


def _check_readout_args(name: str, h, items) -> torch.device:
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors (the plain version is "
                         f"session_readout_plain)")
    if (not _f32_on(dev, h, items) or h.dim() != 2 or items.dim() != 2
            or items.shape[1] != h.shape[1]):
        raise ValueError(f"{name}: want contiguous float32 h [B, D] and "
                         f"items [V, D] on {dev}, got {tuple(h.shape)} "
                         f"{h.dtype} and {tuple(items.shape)} {items.dtype} "
                         f"on {items.device}")
    return dev


def _raise_on(err: int, name: str, plan: LaunchPlan) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({plan})")


def encode_shared_fits(l: int, d: int, n_heads: int,
                       device: torch.device) -> bool:
    """Whether one block of the block body keeps a history's working set
    in shared memory at tier `l`; otherwise a device workspace holds it."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    return work_floats(l, d, n_heads) * 4 <= card_limits(idx)[0]


def session_encode(emb: torch.Tensor, pos: torch.Tensor,
                   packed: torch.Tensor, n_blocks: int, seq: torch.Tensor,
                   lengths: torch.Tensor, n_heads: int) -> torch.Tensor:
    """h [B, D]: the encoder's state at each row's last real position, on
    the card (`csrc/session.cu`, the body `launch_plan` routes). emb
    [V+1, D], pos [Lpos ≥ L, D] and the packed blocks (`pack_blocks`)
    float32; seq [B, L] and lengths [B] int32, every id in [0, V]. Raises
    on a CPU tensor: callers that may hold one go through `score`."""
    dev = _check_encode_args("session_encode", emb, pos, packed, n_blocks,
                             seq, lengths, n_heads)
    b, l = seq.shape
    d = emb.shape[1]
    plan = launch_plan(b, l, d, n_heads, 0, n_blocks,
                       *card_limits(dev.index))
    out = emb.new_empty(b * d + plan.scratch_floats)
    if b == 0:
        return out.view(0, d)
    err = _lib().session_encode(
        emb.data_ptr(), pos.data_ptr(), packed.data_ptr(), seq.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * b * d,
        plan.address, plan.scale, _stream(dev))
    _raise_on(err, "session_encode", plan)
    launches["session_encode"] += 1
    return out[:b * d].view(b, d)


def session_readout(h: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """scores [B, V] = h [B, D] @ items [V, D]ᵀ on the card
    (`csrc/session.cu`, the tiled readout); both contiguous float32.
    Raises on a CPU tensor: the plain version is `session_readout_plain`."""
    dev = _check_readout_args("session_readout", h, items)
    b, d = h.shape
    v = items.shape[0]
    out = h.new_empty((b, v))
    if b == 0 or v == 0:
        return out
    plan = launch_plan(b, 0, d, 1, v, 0, *card_limits(dev.index))
    err = _lib().session_readout(h.data_ptr(), items.data_ptr(),
                                 out.data_ptr(), plan.address, _stream(dev))
    _raise_on(err, "session_readout", plan)
    launches["session_readout"] += 1
    return out


def session_encode_v1(emb: torch.Tensor, pos: torch.Tensor,
                      packed: torch.Tensor, n_blocks: int, seq: torch.Tensor,
                      lengths: torch.Tensor, n_heads: int) -> torch.Tensor:
    """`session_encode`'s first version (the block body at every shape),
    kept for the A/B on the card; no path of the port calls it."""
    dev = _check_encode_args("session_encode_v1", emb, pos, packed,
                             n_blocks, seq, lengths, n_heads)
    b, l = seq.shape
    d = emb.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scratch, grid = None, 0
    if not encode_shared_fits(l, d, n_heads, dev):
        grid = min(b, WORKSPACE_SLOTS)
        scratch = torch.empty(grid * work_floats(l, d, n_heads),
                              dtype=torch.float32, device=dev)
    scale = float(np.float32(math.sqrt(d // n_heads)))
    err = _lib().session_encode_v1(
        emb.data_ptr(), pos.data_ptr(), packed.data_ptr(), n_blocks,
        seq.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, l, d, n_heads,
        scale, grid, _stream(dev))
    if err:
        raise RuntimeError(f"session_encode_v1 launch failed: CUDA error "
                           f"{err} (B={b}, L={l}, D={d}, H={n_heads})")
    launches_v1["session_encode_v1"] += 1
    return out


def session_readout_v1(h: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """`session_readout`'s first version (a thread a row and item), kept
    for the A/B on the card; no path of the port calls it."""
    dev = _check_readout_args("session_readout_v1", h, items)
    b, d = h.shape
    v = items.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    if b == 0 or v == 0:
        return out
    err = _lib().session_readout_v1(
        h.data_ptr(), items.data_ptr(), out.data_ptr(), b, v, d,
        _stream(dev))
    if err:
        raise RuntimeError(f"session_readout_v1 launch failed: CUDA error "
                           f"{err} (B={b}, V={v}, D={d})")
    launches_v1["session_readout_v1"] += 1
    return out


def score(params: dict, seq: torch.Tensor, lengths: torch.Tensor,
          n_heads: int) -> torch.Tensor:
    """Next-item scores [B, V] of the histories seq [B, L] (int32, right-
    padded with the pad row V) of lengths [B] (int32): the encoder's state
    at each row's last real position against the tied item embedding.
    `params` is `params_on(…)` for seq's device. A CPU seq runs the plain
    versions; a CUDA seq one allocation and one launch pair
    (`session_score`: the encoder, then the readout as its programmatic
    dependent), counted under `session_encode` and `session_readout`, or
    raises."""
    emb = params["emb"]
    if seq.device.type == "cpu":
        h = session_encode_plain(params, seq, lengths, n_heads)
        return session_readout_plain(h, emb[:-1])
    pos, packed = params["pos"], params["packed"]
    n_blocks = len(params["blocks"])
    dev = _check_encode_args("score", emb, pos, packed, n_blocks, seq,
                             lengths, n_heads)
    b, l = seq.shape
    v, d = emb.shape[0] - 1, emb.shape[1]
    if b == 0 or v == 0:
        return emb.new_empty((b, v))
    plan = launch_plan(b, l, d, n_heads, v, n_blocks,
                       *card_limits(dev.index))
    out = emb.new_empty(plan.score_shape())
    err = _lib().session_score(
        emb.data_ptr(), pos.data_ptr(), packed.data_ptr(), seq.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), plan.address, plan.scale,
        _stream(dev))
    _raise_on(err, "session_score", plan)
    launches["session_encode"] += 1
    launches["session_readout"] += 1
    return out[:b]
