"""Market-basket co-occurrence mining — the port of
``predictionio_tpu/ops/basket.py``, on one device.

Compute path for the Complementary Purchase template (upstream gallery
template «template-scala-parallel-complementarypurchase» [U] — its Spark
job self-joins basket RDDs to count itemset co-occurrence). Baskets become
0/1 incidence rows and co-occurrence is a Gram matrix:

    B ∈ {0,1}^[n_baskets, n_items]   (built on the device from COO)
    C = BᵀB                          (C[i,j] = #baskets containing both)

B is never materialized whole: baskets stream through in row chunks (the
reference's rectangular walk), and the chunks' Grams add into one
accumulator on the device. The diagonal carries item supports.

Association scores from C (n = total baskets):
    support(i,j)    = C[i,j] / n
    confidence(i→j) = C[i,j] / C[i,i]
    lift(i→j)       = C[i,j]·n / (C[i,i]·C[j,j])

The dense [n_items, n_items] Gram bounds the catalog this path serves
(`max_dense_items`, default 8192 ≈ 256 MB f32); larger catalogs use the
numpy sparse-pair fallback (same math, hash-map counts on host). The rule
passes over C, the fallback and `sessionize` are numpy, the reference's
text.

The reference meters its jitted program (`metered_jit`); the port's
device telemetry does not exist yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from predictionio_torch.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

# the incidence of one GEMM holds at most this many int8 entries; the
# chunks of the walk are grouped under it (`_gram`)
GROUP_BYTES = 1 << 27


@dataclasses.dataclass
class BasketRules:
    """Pairwise rules i → j, pre-filtered and top-k'd per antecedent."""

    cond_items: np.ndarray  # [R] int32 — antecedent item row
    cons_items: np.ndarray  # [R, k] int32 — consequent rows, -1 padded
    scores: np.ndarray  # [R, k] float32 — ranking score (lift or conf)
    support: np.ndarray  # [R, k] float32
    confidence: np.ndarray  # [R, k] float32
    lift: np.ndarray  # [R, k] float32
    n_baskets: int = 0

    def lookup(self, cond_row: int) -> Optional[int]:
        """Index into the rule table for an antecedent row, or None."""
        i = np.searchsorted(self.cond_items, cond_row)
        if i < len(self.cond_items) and self.cond_items[i] == cond_row:
            return int(i)
        return None


def _dedup_and_cap(basket_idx, item_idx, n_baskets: int,
                   max_basket_items: int, caller: str):
    """Shared pre-pass for BOTH count paths: dedup (basket, item) pairs
    (incidence is 0/1 — repeat purchases must not count twice OR crowd
    real items out of the cap), then truncate oversized baskets to
    `max_basket_items` distinct items (lowest item ids — deterministic)
    with a warning."""
    basket_idx = np.asarray(basket_idx, np.int64)
    item_idx = np.asarray(item_idx, np.int64)
    n_items_span = int(item_idx.max(initial=-1)) + 1
    pair = np.unique(basket_idx * max(n_items_span, 1) + item_idx)
    b_sorted = (pair // max(n_items_span, 1)).astype(np.int32)
    i_sorted = (pair % max(n_items_span, 1)).astype(np.int32)
    counts = np.bincount(b_sorted, minlength=n_baskets)
    if counts.max(initial=0) > max_basket_items:
        log.warning(
            "%s: truncating %d basket(s) larger than %d distinct items",
            caller, int((counts > max_basket_items).sum()),
            max_basket_items)
        starts_full = np.concatenate(([0], np.cumsum(counts)))
        rank = np.arange(len(b_sorted)) - starts_full[b_sorted]
        keep = rank < max_basket_items
        b_sorted = b_sorted[keep]
        i_sorted = i_sorted[keep]
    return b_sorted, i_sorted


def _chunk_walk(b_sorted: np.ndarray, i_sorted: np.ndarray, n_baskets: int,
                chunk: int) -> tuple:
    """The reference's rectangular [n_chunks, max_entries] walk over the
    deduped, basket-sorted entries: each chunk's chunk-local basket rows,
    item columns and a mask of its real (not padding) entries."""
    counts = np.bincount(b_sorted, minlength=n_baskets)
    starts = np.concatenate(([0], np.cumsum(counts)))
    n_chunks = -(-n_baskets // chunk)
    max_e = 0
    for c in range(n_chunks):
        lo = starts[c * chunk]
        hi = starts[min((c + 1) * chunk, n_baskets)]
        max_e = max(max_e, hi - lo)
    rows = np.zeros((n_chunks, max_e), np.int32)
    cols = np.zeros((n_chunks, max_e), np.int32)
    valid = np.zeros((n_chunks, max_e), np.bool_)
    for c in range(n_chunks):
        lo = starts[c * chunk]
        hi = starts[min((c + 1) * chunk, n_baskets)]
        e = hi - lo
        rows[c, :e] = b_sorted[lo:hi] - c * chunk  # chunk-local basket row
        cols[c, :e] = i_sorted[lo:hi]
        valid[c, :e] = True
    return rows, cols, valid


def _gram(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
          n_items: int, chunk: int) -> torch.Tensor:
    """Σ over the walk's chunks of each chunk's incidence Gram, on the
    walk's device: an int32 [n_pad, n_pad] tensor whose [:n_items,
    :n_items] block is C (`n_pad` is `n_items` rounded up to the GEMM's
    multiple of 8, at least 24).

    The incidence is kept item-major, [items, baskets] (cuBLASLt's int8
    GEMM takes its first operand row-major), so a chunk's baskets are
    columns and the dropped row that takes the walk's padding is an
    extra item row, `n_pad`, cut off before the product. Duplicates were
    removed by `_dedup_and_cap`, so a plain `index_put_` of ones is the
    0/1 incidence. int32 sums are exact however many baskets a GEMM
    takes, so consecutive chunks are grouped, up to GROUP_BYTES of
    incidence, into one GEMM of K = group × chunk baskets (each chunk's
    columns at its offset in the group): fewer passes over the [n_pad,
    n_pad] accumulator, the same C."""
    n_pad = max(24, -(-n_items // 8) * 8)  # _int_mm: M > 16, N % 8 == 0
    k_chunk = -(-chunk // 8) * 8  # _int_mm: K % 8 == 0
    group = max(1, GROUP_BYTES // ((n_pad + 1) * k_chunk))
    dev = rows.device
    one = torch.ones((), dtype=torch.int8, device=dev)
    acc = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=dev)
    for c0 in range(0, rows.shape[0], group):
        c1 = min(c0 + group, rows.shape[0])
        offset = torch.arange(c1 - c0, device=dev, dtype=torch.int64)
        basket = rows[c0:c1].long() + (offset * k_chunk)[:, None]
        # padding entries go to the dropped item row
        item = torch.where(valid[c0:c1], cols[c0:c1].long(), n_pad)
        m = torch.zeros((n_pad + 1, (c1 - c0) * k_chunk), dtype=torch.int8,
                        device=dev)
        m.index_put_((item.reshape(-1), basket.reshape(-1)), one)
        m = m[:n_pad]
        acc += torch._int_mm(m, m.t())
    return acc


def cooccurrence_matrix(
    basket_idx: np.ndarray,
    item_idx: np.ndarray,
    n_baskets: int,
    n_items: int,
    chunk: int = 1024,
    max_basket_items: int = 512,
    device: DeviceLike = None,
) -> np.ndarray:
    """C[i, j] = number of baskets containing both i and j (diagonal =
    per-item support counts), as a numpy f32 array. Chunked incidence and
    a Gram on `device` (`device.resolve_device`: CUDA unless the caller
    asks for the CPU).

    `max_basket_items` truncates pathological baskets (a crawler "basket"
    with 100k purchases would otherwise set the rectangular chunk walk's
    padded width for EVERY chunk): oversized baskets keep N DISTINCT
    items (duplicates are deduped before the cap, so repeat purchases
    never crowd out real items), with a warning. Association rules from
    bot-sized baskets are noise, not signal.

    Why an int8 → int32 product (`torch._int_mm`), on the CPU and on the
    card alike: C must be exact whatever a chunk's counts.
    - A torch `matmul` of two bf16 tensors returns bf16, which holds
      integers exactly only up to 256: a per-chunk count of 257 comes
      back as 256.
    - bf16 inputs with an f32 output (`out_dtype`) exist only for CUDA,
      so the CPU would need another formulation; on CUDA, cuBLAS may
      reduce split-K partials in bf16 unless
      `allow_bf16_reduced_precision_reduction` is turned off around it.
    - An f32 GEMM (TF32 is off, `predictionio_torch/__init__.py`) is
      exact, but runs at the card's f32 rate, 67 TFLOP/s against int8's
      1 979 TOP/s.
    - 0 and 1 are exact in int8 and every partial sum is an integer in
      int32, so the product is exact by construction, in any summation
      order: the CPU and the card give the same bits, and no bf16 GEMM
      feeds a count. The counts leave as f32 (exact to 2²⁴ baskets, the
      reference's own bound).
    """
    dev = resolve_device(device)
    if len(basket_idx) == 0:
        return np.zeros((n_items, n_items), np.float32)
    b_sorted, i_sorted = _dedup_and_cap(basket_idx, item_idx, n_baskets,
                                        max_basket_items,
                                        "cooccurrence_matrix")
    walk = _chunk_walk(b_sorted, i_sorted, n_baskets, chunk)
    rows, cols, valid = (torch.from_numpy(a).to(dev) for a in walk)
    acc = _gram(rows, cols, valid, n_items, chunk)
    return acc[:n_items, :n_items].float().cpu().numpy()


def cooccurrence_matrix_host(
    basket_idx: np.ndarray,
    item_idx: np.ndarray,
    n_baskets: int,
    n_items: int,
    max_basket_items: int = 512,
) -> dict:
    """Sparse host fallback for catalogs too large for the dense Gram:
    {(i, j): count} for i < j plus {i: support} — same math, and the SAME
    basket cap as the dense path (an unbounded bot basket would otherwise
    enumerate O(n²) pairs here)."""
    from collections import Counter, defaultdict

    if len(basket_idx):
        basket_idx, item_idx = _dedup_and_cap(
            basket_idx, item_idx, n_baskets, max_basket_items,
            "cooccurrence_matrix_host")
    per_basket: dict = defaultdict(set)
    for b, i in zip(basket_idx, item_idx):
        per_basket[int(b)].add(int(i))
    support: Counter = Counter()
    pairs: Counter = Counter()
    for items in per_basket.values():
        s = sorted(items)
        support.update(s)
        for a_i in range(len(s)):
            for b_i in range(a_i + 1, len(s)):
                pairs[(s[a_i], s[b_i])] += 1
    return {"support": support, "pairs": pairs}


def mine_rules(
    basket_idx: np.ndarray,
    item_idx: np.ndarray,
    n_baskets: int,
    n_items: int,
    min_support: float = 0.0,
    min_confidence: float = 0.0,
    min_lift: float = 1.0,
    top_k: int = 10,
    score: str = "lift",
    max_dense_items: int = 8192,
    max_basket_items: int = 512,
    device: DeviceLike = None,
) -> BasketRules:
    """Pairwise association rules i → j, thresholded and top-k'd.

    `score` ("lift" | "confidence") ranks each antecedent's consequents.
    min_support applies to the PAIR's support (fraction of baskets),
    matching the upstream template's minSupport semantics [U]. Catalogs
    of at most `max_dense_items` count on `device` (`cooccurrence_matrix`),
    larger ones on the host (`cooccurrence_matrix_host`, logged); the
    device is resolved either way, so a call that names none needs CUDA
    whatever the catalog's size.
    """
    if score not in ("lift", "confidence"):
        raise ValueError(f"score must be 'lift' or 'confidence': {score!r}")
    dev = resolve_device(device)
    n = max(n_baskets, 1)
    if n_items <= max_dense_items:
        C = cooccurrence_matrix(basket_idx, item_idx, n_baskets, n_items,
                                max_basket_items=max_basket_items,
                                device=dev)
    else:
        log.info("mine_rules: %d items > max_dense_items %d — sparse "
                 "host count", n_items, max_dense_items)
        sp = cooccurrence_matrix_host(basket_idx, item_idx, n_baskets,
                                      n_items,
                                      max_basket_items=max_basket_items)
        return _rules_from_sparse(sp, n, n_items, min_support,
                                  min_confidence, min_lift, top_k, score)
    return _rules_from_dense(C, n_baskets, min_support, min_confidence,
                             min_lift, top_k, score)


def _rules_from_dense(C: np.ndarray, n_baskets: int, min_support: float,
                      min_confidence: float, min_lift: float, top_k: int,
                      score: str) -> BasketRules:
    """The reference's row-wise rule pass over the dense Gram `C`."""
    n = max(n_baskets, 1)
    n_items = C.shape[0]
    # row-wise pass: materializing full [n_items, n_items] supp/conf/lift
    # planes alongside C would peak ~7× the documented Gram budget;
    # per-condition rows keep the peak at C + O(n_items)
    diag = np.diag(C).copy()
    # candidate condition rows: any co-occurrence beyond the diagonal
    nz_per_row = np.count_nonzero(C, axis=1)
    candidates = np.nonzero(nz_per_row - (diag > 0) > 0)[0]

    k = min(top_k, n_items)
    ids = np.arange(n_items)
    cond_list, rows_out = [], []
    for i in candidates:
        cn = C[i].copy()
        cn[i] = 0.0
        supp = cn / n
        with np.errstate(divide="ignore", invalid="ignore"):
            conf = cn / diag[i] if diag[i] > 0 else np.zeros_like(cn)
            lift = np.where(diag > 0, cn * n / (diag[i] * diag), 0.0) \
                if diag[i] > 0 else np.zeros_like(cn)
        # cn > 0: a rule requires actual co-occurrence (self-pairs and
        # never-together pairs must not surface when thresholds are 0 —
        # the sparse fallback only ever sees real pairs)
        ok = ((cn > 0) & (supp >= min_support) & (conf >= min_confidence)
              & (lift >= min_lift))
        if not ok.any():
            continue
        rank = np.where(ok, lift if score == "lift" else conf, -np.inf)
        # deterministic order: score desc, item id asc (ties at the top-k
        # boundary must resolve identically to the sparse fallback)
        top = np.lexsort((ids, -rank))[:k]
        top = top[rank[top] > -np.inf]
        cond_list.append(i)
        rows_out.append((top, rank[top], supp[top], conf[top], lift[top]))

    cond_rows = np.asarray(cond_list, np.int32)
    cons = np.full((len(cond_rows), k), -1, np.int32)
    sc = np.zeros((len(cond_rows), k), np.float32)
    s_out = np.zeros((len(cond_rows), k), np.float32)
    c_out = np.zeros((len(cond_rows), k), np.float32)
    l_out = np.zeros((len(cond_rows), k), np.float32)
    for out_i, (top, r_v, s_v, c_v, l_v) in enumerate(rows_out):
        cons[out_i, : len(top)] = top
        sc[out_i, : len(top)] = r_v
        s_out[out_i, : len(top)] = s_v
        c_out[out_i, : len(top)] = c_v
        l_out[out_i, : len(top)] = l_v
    return BasketRules(cond_rows, cons, sc, s_out, c_out, l_out, n_baskets)


def _rules_from_sparse(sp: dict, n: int, n_items: int, min_support: float,
                       min_confidence: float, min_lift: float, top_k: int,
                       score: str) -> BasketRules:
    support = sp["support"]
    per_cond: dict = {}
    for (a, b), cnt in sp["pairs"].items():
        for i, j in ((a, b), (b, a)):
            s = cnt / n
            conf = cnt / support[i] if support[i] else 0.0
            lift = (cnt * n / (support[i] * support[j])
                    if support[i] and support[j] else 0.0)
            if s >= min_support and conf >= min_confidence and lift >= min_lift:
                per_cond.setdefault(i, []).append(
                    (lift if score == "lift" else conf, j, s, conf, lift))
    cond_rows = np.asarray(sorted(per_cond), np.int32)
    k = top_k
    cons = np.full((len(cond_rows), k), -1, np.int32)
    sc = np.zeros((len(cond_rows), k), np.float32)
    s_out = np.zeros((len(cond_rows), k), np.float32)
    c_out = np.zeros((len(cond_rows), k), np.float32)
    l_out = np.zeros((len(cond_rows), k), np.float32)
    for out_i, i in enumerate(cond_rows):
        # same deterministic order as the dense path: score desc, id asc
        entries = sorted(per_cond[int(i)],
                         key=lambda e: (-e[0], e[1]))[:k]
        for e_i, (rank_v, j, s, conf, lift) in enumerate(entries):
            cons[out_i, e_i] = j
            sc[out_i, e_i] = rank_v
            s_out[out_i, e_i] = s
            c_out[out_i, e_i] = conf
            l_out[out_i, e_i] = lift
    return BasketRules(cond_rows, cons, sc, s_out, c_out, l_out, n)


def sessionize(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    times: np.ndarray,
    window_s: float,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Events → baskets: a user's purchases closer than `window_s` apart
    share a basket (the upstream template's basketWindow [U]). Returns
    (basket_idx, item_idx, n_baskets), vectorized numpy."""
    if len(user_idx) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), 0)
    order = np.lexsort((np.asarray(times), np.asarray(user_idx)))
    u = np.asarray(user_idx)[order]
    i = np.asarray(item_idx)[order]
    t = np.asarray(times, np.float64)[order]
    new_user = np.concatenate(([True], u[1:] != u[:-1]))
    gap = np.concatenate(([True], (t[1:] - t[:-1]) > window_s))
    new_basket = new_user | gap
    basket = np.cumsum(new_basket) - 1
    return basket.astype(np.int32), i.astype(np.int32), int(basket[-1]) + 1
