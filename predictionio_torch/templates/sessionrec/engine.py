"""Session-based next-item engine template (DASE components) — the port of
``predictionio_tpu/templates/sessionrec/engine.py``.

A small causal self-attention next-item model: item embeddings plus 1-2
attention blocks, trained through the normal DataSource → Preparator →
Algorithm path over per-user event sequences from `data/view.py`'s
ordered aggregation, and served through the micro-batcher.

Serving pads over TWO ragged axes on fixed ladders: the power-of-two
batch tier (`_pad_batch_tier`) bounds the batch dimension, and the
sequence-tier ladder (`serving.batcher.seq_tiers_from_env`, knob
PIO_SERVING_SEQ_TIERS) bounds the history length.

Pad positions are exact no-ops, so a history scores bitwise the same at
every tier that fits it and in every batch that carries it: histories
right-pad, the causal mask keeps every real position from attending past
itself, the readout takes the LAST REAL position's state, and the scorer
(`ops/session.py::score`: the kernels of ``csrc/session.cu`` on the card,
their plain versions on the CPU) sums every row in one fixed order of its
own. Training runs the reference's formula (`ops/session.py::encode`).

Wire shapes:
    query:  {"user": "u1", "num": 4}            — served session window
            {"items": ["i1", "i2"], "num": 4}   — explicit session
    result: {"itemScores": [{"item": "i5", "score": 0.93}, ...]}
"""

from __future__ import annotations

import dataclasses
import logging
from datetime import timezone
from typing import Dict, List, Optional

import numpy as np
import torch

from predictionio_torch.controller import (
    Algorithm,
    DataSource as BaseDataSource,
    Engine,
    EngineFactory,
    FirstServing,
    Params,
    Preparator as BasePreparator,
    SanityCheck,
    WorkflowContext,
)
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.view import LBatchView
from predictionio_torch.device import resolve_device
from predictionio_torch.models.session_model import (
    SessionRecModel,
    recent_window,
)
from predictionio_torch.ops import session as session_ops
from predictionio_torch.serving.batcher import (
    pad_to_seq_tier,
    seq_tier_ladder,
    seq_tiers_from_env,
)
from predictionio_torch.templates.similarproduct.engine import store_of

log = logging.getLogger(__name__)

Query = dict
PredictedResult = dict


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    eventNames: list = dataclasses.field(
        default_factory=lambda: ["view", "buy"])
    evalK: int = 0  # >0 enables read_eval with k leave-last-item folds


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Per-user canonical item sequences (the `recent_window` rule over
    the ordered event fold: keep-last dedup, (time, item) order)."""

    sequences: Dict[str, List[str]]  # user id → ordered item ids

    def sanity_check(self):
        if not any(len(s) >= 2 for s in self.sequences.values()):
            raise ValueError(
                "TrainingData has no user with a 2+ item sequence; ingest "
                "view/buy events first (next-item training needs at least "
                "one transition).")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Per-user ordered sequences through `LBatchView.
        aggregate_by_entity_ordered`, the time-ordered per-entity fold:
        it gathers (item, event_time) pairs, and `recent_window` applies
        the canonical window rule."""
        view = LBatchView(self.params.appName, store=store_of(ctx))
        names = set(self.params.eventNames)

        def pred(e) -> bool:
            return (e.event in names
                    and e.entity_type == "user"
                    and (e.target_entity_type or "item") == "item"
                    and bool(e.target_entity_id))

        def op(acc, e):
            t = e.event_time
            if t is not None and t.tzinfo is None:
                t = t.replace(tzinfo=timezone.utc)
            return acc + ((str(e.target_entity_id), t),)

        folded = view.aggregate_by_entity_ordered(pred, (), op)
        # 0 = uncapped here: the Algorithm caps to maxSeqLen, so the
        # window length stays an algorithm knob
        sequences = {str(u): recent_window(pairs, 0)
                     for u, pairs in folded.items() if pairs}
        log.info("DataSource: %d users with sequences, app %r",
                 len(sequences), self.params.appName)
        return TrainingData(sequences=sequences)

    def read_eval(self, ctx: WorkflowContext):
        """k-fold leave-last-item-out: each fold holds out 1/k of the
        2+-item users; their training sequence drops its last item and
        the query replays the prefix asking the model to rank the
        held-out next item."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError("DataSourceParams.evalK must be >= 2 for "
                             "evaluation")
        td = self.read_training(ctx)
        users = sorted(u for u, s in td.sequences.items() if len(s) >= 2)
        folds = []
        for fold in range(k):
            held = set(users[fold::k])
            seqs = {u: (list(s[:-1]) if u in held else list(s))
                    for u, s in td.sequences.items()}
            seqs = {u: s for u, s in seqs.items() if s}
            qa = [({"items": list(seqs[u]), "num": 10},
                   {"items": [td.sequences[u][-1]]})
                  for u in sorted(held) if seqs.get(u)]
            folds.append((TrainingData(sequences=seqs), qa))
        return folds


@dataclasses.dataclass
class PreparedData:
    item_ids: BiMap
    user_seqs: Dict[str, np.ndarray]  # user id → int32 embedding rows


class Preparator(BasePreparator):
    """Code items densely (sorted ids → deterministic rows) and encode
    each user's canonical sequence."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        items = sorted({i for s in td.sequences.values() for i in s})
        item_ids = BiMap.string_int(items)
        user_seqs = {
            u: item_ids.to_index(s).astype(np.int32)
            for u, s in sorted(td.sequences.items())
        }
        return PreparedData(item_ids=item_ids, user_seqs=user_seqs)


def _pad_batch_tier(n: int) -> int:
    """Power-of-two batch tier ≥ n: batch groups re-fragment after the
    sequence-tier grouping, so the batch dimension pads onto its own
    fixed ladder."""
    t = 1
    while t < n:
        t <<= 1
    return t


def _serve_tiers(model: SessionRecModel) -> tuple:
    """Sequence tiers this model can serve: the env ladder clamped to the
    trained positional table (a tier past it would index beyond it)."""
    l_pos = int(np.asarray(model.params["pos"]).shape[0])
    tiers = tuple(t for t in seq_tiers_from_env(model.max_seq_len)
                  if t <= l_pos)
    return tiers or seq_tier_ladder(model.max_seq_len)


def init_params(n_items: int, d: int, n_blocks: int, l_pos: int,
                rng: np.random.Generator) -> dict:
    """The reference's initial params, drawn from `rng` in its order: the
    blocks' weights, then the item embeddings (the pad row V zero), then
    the positional table; N(0, 0.1²) weights, zero biases."""
    def init_w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    blocks = []
    for _ in range(n_blocks):
        blocks.append({
            "wq": init_w(d, d), "wk": init_w(d, d),
            "wv": init_w(d, d), "wo": init_w(d, d),
            "w1": init_w(d, 2 * d),
            "b1": np.zeros(2 * d, np.float32),
            "w2": init_w(2 * d, d),
            "b2": np.zeros(d, np.float32),
        })
    return {
        "emb": np.concatenate(
            [init_w(n_items, d), np.zeros((1, d), np.float32)]),
        "pos": init_w(l_pos, d),
        "blocks": blocks,
    }


def training_batch(user_seqs: Dict[str, np.ndarray], n_items: int,
                   cap: int, l_pos: int) -> tuple:
    """(seq [bt, l_pos] int32, lengths [bt] int32, n): the last `cap`
    items of each 2+-item user's sequence, in user order, right-padded
    with the pad row `n_items`; bt is n's batch tier, its padding rows of
    length 0."""
    seqs = [s[-cap:] for _, s in sorted(user_seqs.items()) if len(s) >= 2]
    n = len(seqs)
    bt = _pad_batch_tier(n)
    seq = np.full((bt, l_pos), n_items, np.int32)
    lengths = np.zeros(bt, np.int32)
    for r, s in enumerate(seqs):
        seq[r, :len(s)] = s
        lengths[r] = len(s)
    return seq, lengths, n


def served_model(params: dict, item_ids: BiMap,
                 user_seqs: Dict[str, np.ndarray], cap: int, n_heads: int,
                 device) -> SessionRecModel:
    """The model a train serves: its params, each user's last `cap` items
    as the served window, each window's pooled vector, scoring on
    `device`."""
    windows = {u: tuple(item_ids.from_index(s[-cap:]))
               for u, s in sorted(user_seqs.items())}
    model = SessionRecModel(
        params=params, item_ids=item_ids, user_windows=windows,
        session_vecs={}, max_seq_len=cap, n_heads=n_heads,
        device=str(device))
    model.session_vecs.update(
        {u: model.session_vec_of(w) for u, w in windows.items()})
    return model


@dataclasses.dataclass
class SessionRecParams(Params):
    embedDim: int = 16
    numBlocks: int = 1
    numHeads: int = 2
    maxSeqLen: int = 32
    epochs: int = 30
    stepSize: float = 0.05
    seed: Optional[int] = None


class SessionRecAlgorithm(Algorithm):
    """Causal self-attention next-item model over session windows."""

    params_class = SessionRecParams
    checkpoint_tags = ("sessionrec",)

    def __init__(self, params: SessionRecParams):
        self.params = params

    def train(self, ctx: WorkflowContext,
              pd: PreparedData) -> SessionRecModel:
        p = self.params
        seed = ctx.seed if p.seed is None else p.seed
        rng = np.random.default_rng(int(seed) if seed is not None else 0)
        n_items = len(pd.item_ids)
        cap = int(p.maxSeqLen)
        # the positional table spans the default ladder's top tier for
        # this window length, whatever the serve-time env, so a model
        # never deploys with fewer positions than its own ladder needs
        l_pos = seq_tier_ladder(cap)[-1]
        params = init_params(n_items, int(p.embedDim), int(p.numBlocks),
                             l_pos, rng)
        seq, lengths, n = training_batch(pd.user_seqs, n_items, cap, l_pos)
        if n:
            params, losses = session_ops.train_params(
                params, seq, lengths, int(p.numHeads), float(p.stepSize),
                int(p.epochs), ctx.device)
            final = float(losses[-1]) if len(losses) else float("nan")
            log.info("SessionRec: trained %d sequences, %d items, final "
                     "loss %.4f", n, n_items, final)
            ctx.metrics.emit("train/sessionrec", sequences=n, items=n_items,
                             epochs=int(p.epochs), loss=final)

        return served_model(params, pd.item_ids, pd.user_seqs, cap,
                            int(p.numHeads), ctx.device)

    def predict(self, model: SessionRecModel,
                query: Query) -> PredictedResult:
        # the single path IS the batched path at batch 1: parity between
        # them is this identity plus the scorer's fixed order a row
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: SessionRecModel,
                      queries) -> list:
        out: list = [None] * len(queries)
        tiers = _serve_tiers(model)
        cap = min(model.max_seq_len, int(tiers[-1]))
        groups: Dict[int, list] = {}
        for pos, q in enumerate(queries):
            hist = q.get("items")
            if hist is None:
                u = q.get("user")
                hist = (model.user_windows.get(str(u), ())
                        if u is not None else ())
            rows = model.window_rows(hist)[-cap:]
            num = int(q.get("num", 10))
            if not rows or num <= 0:
                out[pos] = {"itemScores": []}
                continue
            tier = pad_to_seq_tier(len(rows), tiers)
            groups.setdefault(tier, []).append((pos, rows, num))
        if not groups:
            return out
        dev = resolve_device(model.device)
        params = model.device_params(dev)
        pad_row = model.n_items
        for tier, entries in groups.items():
            b = len(entries)
            bt = _pad_batch_tier(b)
            seq = np.full((bt, tier), pad_row, np.int32)
            lengths = np.zeros(bt, np.int32)
            for r, (_, rows, _) in enumerate(entries):
                seq[r, :len(rows)] = rows
                lengths[r] = len(rows)
            if bt > b:
                # batch padding duplicates the last real row; its
                # results are never read (the batcher's padding idiom)
                seq[b:] = seq[b - 1]
                lengths[b:] = lengths[b - 1]
            logits = session_ops.score(
                params, torch.as_tensor(seq, device=dev),
                torch.as_tensor(lengths, device=dev),
                model.n_heads).cpu().numpy()
            for r, (pos, rows, num) in enumerate(entries):
                s = logits[r].copy()
                seen = np.unique(np.asarray(rows, np.int32))
                s[seen] = -np.inf  # never re-recommend the window
                k = min(num, s.shape[0] - len(seen))
                if k <= 0:
                    out[pos] = {"itemScores": []}
                    continue
                top = np.argpartition(-s, k - 1)[:k]
                top = top[np.argsort(-s[top])]
                items = model.item_ids.from_index(top)
                out[pos] = {"itemScores": [
                    {"item": i, "score": float(s[j])}
                    for i, j in zip(items, top)]}
        return out


class SessionRecEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"attention": SessionRecAlgorithm},
            serving_class_map=FirstServing,
        )
