"""Text-feature ops: hashing TF, IDF and Word2Vec — the port of
``predictionio_tpu/ops/text.py``, on one device.

The Text Classification template featurizes through these in place of
Spark MLlib's `HashingTF`, `IDF` and `Word2Vec.fit`.

Host side (numpy, array-equal to the reference's): tokenization, the
hashing trick (crc32), IDF, the vocabulary and the skip-gram pair table,
whose order the sampler indexes into.

Device side: skip-gram with negative sampling (SGNS) as a loop of sparse
SGD steps (`sgns_loop`). Each step draws a batch of pairs and negatives
from its sampler, gathers the B·(N+2) embedding rows it touches, computes
the hand-derived row gradients (the mean over the batch folded into
`g_pos` / `g_neg`) and adds them back with `scatter_add_rows`: first
`emb_in` at the centers, then `emb_out` at the contexts, then `emb_out`
at the negatives, the reference's order. No autodiff over the full
tables: their gradient would be dense [V, K].

Rows repeat within a batch. A float `index_add_` on CUDA accumulates
them through atomics in no fixed order, so two runs would differ in their
bits; `scatter_add_rows` sums each row's updates in a fixed order (a
stable sort of the row ids, ordered segment sums), and every write to a
row carries the same value. Two fits, a chunked fit and a resumed fit
give the same bits.

The draws come from a `torch.Generator` on the device
(`TorchSampler`), which the checkpoint carries, so a resumed run draws
the batches the uninterrupted run would have drawn. The generator's
stream is not `jax.random`'s: the tests hold the loop against the
reference's by injecting the reference's draws.

The reference also has a data-parallel loop over a device mesh
(`_w2v_train_loop_sharded`) and meters its jitted programs; the port runs
on one device (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import re
import zlib
from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_torch.device import DeviceLike, make_generator, resolve_device

log = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9']+")
# the checkpoint fingerprint's tag: the port never resumes a step that the
# reference wrote into a shared directory
_FINGERPRINT_TAG = "torch.w2v.v1"

# SGNS steps run in this process: one draw from the sampler a step
# (plain ints)
sampler_calls = {"sgns": 0}


def reset_sampler_calls() -> None:
    sampler_calls["sgns"] = 0


# -- host side ---------------------------------------------------------------

def tokenize(text: str) -> list[str]:
    """Lowercase word tokenizer (the template's regex split)."""
    return _TOKEN_RE.findall(text.lower())


def hashing_tf(
    docs_tokens: Sequence[Sequence[str]], num_features: int = 1024
) -> np.ndarray:
    """«HashingTF»: term-frequency vectors via the hashing trick. crc32 is
    stable across processes (unlike Python's seeded str hash), so models
    serve correctly after a deploy reloads them."""
    out = np.zeros((len(docs_tokens), num_features), dtype=np.float32)
    for d, tokens in enumerate(docs_tokens):
        for t in tokens:
            out[d, zlib.crc32(t.encode()) % num_features] += 1.0
    return out


@dataclasses.dataclass
class IDFModel:
    idf: np.ndarray  # [D] float32

    def transform(self, tf: np.ndarray) -> np.ndarray:
        return tf * self.idf


def idf_fit(tf: np.ndarray, min_doc_freq: int = 0) -> IDFModel:
    """«IDF.fit»: idf_j = log((n + 1) / (df_j + 1)) (MLlib's formula);
    terms below min_doc_freq get idf 0 (dropped)."""
    n = tf.shape[0]
    df = (tf > 0).sum(axis=0)
    idf = np.log((n + 1.0) / (df + 1.0)).astype(np.float32)
    if min_doc_freq > 0:
        idf = np.where(df >= min_doc_freq, idf, 0.0).astype(np.float32)
    return IDFModel(idf=idf)


def build_vocab(
    docs_tokens: Sequence[Sequence[str]], min_count: int = 1,
    max_size: Optional[int] = None,
) -> dict[str, int]:
    """Frequency-ordered token→id map, ties broken by token («Word2Vec»'s
    vocabulary build)."""
    counts = Counter(t for doc in docs_tokens for t in doc)
    items = [(t, c) for t, c in counts.items() if c >= min_count]
    items.sort(key=lambda tc: (-tc[1], tc[0]))
    if max_size is not None:
        items = items[:max_size]
    return {t: i for i, (t, _) in enumerate(items)}


def skipgram_pairs(
    docs_tokens: Sequence[Sequence[str]], vocab: dict[str, int], window: int = 5
) -> np.ndarray:
    """(center, context) id pairs within ±window of each other in a
    document, out-of-vocabulary tokens dropped first: [P, 2] int32, in the
    reference's order (document, center position, context position).

    Vectorised: every token against each offset in -window … window
    (0 left out), in ascending order, kept where the partner lies in the
    same document; a row-major mask keeps that order."""
    ids_per_doc = [[vocab[t] for t in doc if t in vocab] for doc in docs_tokens]
    lengths = np.fromiter(map(len, ids_per_doc), dtype=np.int64,
                          count=len(ids_per_doc))
    n = int(lengths.sum())
    offsets = np.asarray([d for d in range(-window, window + 1) if d != 0],
                         dtype=np.int64)
    if n == 0 or offsets.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    ids = np.fromiter(itertools.chain.from_iterable(ids_per_doc),
                      dtype=np.int64, count=n)
    doc = np.repeat(np.arange(len(lengths)), lengths)
    partner = np.arange(n)[:, None] + offsets[None, :]  # [n, 2·window]
    inside = (partner >= 0) & (partner < n)
    partner = np.clip(partner, 0, n - 1)
    keep = inside & (doc[partner] == doc[:, None])
    centers = np.broadcast_to(ids[:, None], partner.shape)[keep]
    contexts = ids[partner][keep]
    return np.stack([centers, contexts], axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Word2VecConfig:
    dim: int = 64
    window: int = 5
    negatives: int = 5
    steps: int = 500
    batch_size: int = 1024
    learning_rate: float = 0.05
    min_count: int = 1
    max_vocab: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class Word2VecModel:
    vectors: np.ndarray  # [V, dim] — input (center) embeddings
    vocab: dict  # token → row

    def vector(self, token: str) -> Optional[np.ndarray]:
        i = self.vocab.get(token)
        return None if i is None else self.vectors[i]

    def doc_vector(self, tokens: Sequence[str]) -> np.ndarray:
        """Mean of known-token vectors (the template's document embedding)."""
        rows = [self.vocab[t] for t in tokens if t in self.vocab]
        if not rows:
            return np.zeros(self.vectors.shape[1], dtype=np.float32)
        return self.vectors[np.asarray(rows)].mean(axis=0)

    def similar(self, token: str, num: int = 10) -> list[tuple[str, float]]:
        """«Word2VecModel.findSynonyms»: top cosine neighbours."""
        v = self.vector(token)
        if v is None:
            return []
        norms = np.linalg.norm(self.vectors, axis=1)
        sims = self.vectors @ v / np.maximum(
            norms * max(np.linalg.norm(v), 1e-12), 1e-12
        )
        order = np.argsort(-sims)
        inv = {i: t for t, i in self.vocab.items()}
        out = []
        for idx in order:
            t = inv[int(idx)]
            if t != token:
                out.append((t, float(sims[idx])))
            if len(out) >= num:
                break
        return out


# -- device side -------------------------------------------------------------

def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> None:
    """table[ids[j]] += rows[j] for every j, in place, with each row's
    updates summed in a fixed order: the ids sorted stably, each run of
    equal ids summed front to back (`segment_reduce`, one thread a run
    and column), the sum added to the row, and every position of the run
    writing that same value (so which write lands does not matter). No
    atomics, no data-dependent shapes (no sync with the host); the same
    inputs give the same bits on every run. ids int64 [M], rows [M, K]."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    vals = rows.index_select(0, perm)
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    last = torch.searchsorted(sorted_ids, sorted_ids, side="right")
    pos = torch.arange(sorted_ids.shape[0], device=ids.device)
    # a run's length at its first position, 0 elsewhere: segment j of the
    # reduction is then positions [j, j + length) for a run's first j
    lengths = torch.where(first == pos, last - pos, 0)
    sums = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                unsafe=True)
    table.index_put_((sorted_ids,), table.index_select(0, sorted_ids)
                     + sums.index_select(0, first))


def _sgns_step(emb_in: torch.Tensor, emb_out: torch.Tensor,
               pairs: torch.Tensor, idx: torch.Tensor, neg: torch.Tensor,
               lr: float, inv_b: float) -> torch.Tensor:
    """One SGNS step in place on the tables; returns its loss (a 0-d
    tensor on the device). The reference's step (text.py:182-213):
    gradients of the loss with respect to the gathered rows, the mean
    over the batch folded into g_pos / g_neg."""
    batch = pairs.index_select(0, idx)  # [B, 2]
    center, ctx = batch[:, 0], batch[:, 1]
    negs = neg.reshape(-1)
    c = emb_in.index_select(0, center)  # [B, K]
    pos = emb_out.index_select(0, ctx)  # [B, K]
    ngs = emb_out.index_select(0, negs).reshape(*neg.shape, -1)  # [B, N, K]
    pos_score = (c * pos).sum(-1)  # [B]
    neg_score = torch.bmm(ngs, c.unsqueeze(-1)).squeeze(-1)  # [B, N]
    loss = -(F.logsigmoid(pos_score).mean()
             + F.logsigmoid(-neg_score).sum(-1).mean())
    g_pos = (torch.sigmoid(pos_score) - 1.0) * inv_b  # [B]
    g_neg = torch.sigmoid(neg_score) * inv_b  # [B, N]
    g_c = g_pos[:, None] * pos + torch.bmm(g_neg.unsqueeze(1), ngs).squeeze(1)
    g_ctx = g_pos[:, None] * c
    g_ngs = g_neg[..., None] * c[:, None, :]  # [B, N, K]
    scatter_add_rows(emb_in, center, -lr * g_c)
    scatter_add_rows(emb_out, ctx, -lr * g_ctx)
    scatter_add_rows(emb_out, negs, (-lr * g_ngs).reshape(-1, c.shape[1]))
    return loss


class TorchSampler:
    """Each SGNS step's draws from `generator` (on the tables' device):
    pair indices [B] uniform over the pair table, negatives [B, N]
    uniform over the vocabulary, both int64."""

    def __init__(self, generator: torch.Generator, n_pairs: int,
                 vocab_size: int, cfg: Word2VecConfig):
        self.generator = generator
        self.n_pairs = n_pairs
        self.vocab_size = vocab_size
        self.cfg = cfg

    def __call__(self) -> tuple[torch.Tensor, torch.Tensor]:
        gen, cfg = self.generator, self.cfg
        idx = torch.randint(0, self.n_pairs, (cfg.batch_size,),
                            generator=gen, device=gen.device)
        neg = torch.randint(0, self.vocab_size,
                            (cfg.batch_size, cfg.negatives),
                            generator=gen, device=gen.device)
        return idx, neg


def sgns_loop(emb_in: torch.Tensor, emb_out: torch.Tensor,
              pairs: torch.Tensor, sampler: Callable[[], tuple],
              n_steps: int, cfg: Word2VecConfig) -> torch.Tensor:
    """`n_steps` SGNS steps, the tables updated in place; `sampler()`
    gives each step's (pair idx [B], negatives [B, N]) on the tables'
    device. Returns the losses [n_steps], left on the device (the caller
    reads them once a chunk: that readback is the fence)."""
    inv_b = 1.0 / cfg.batch_size
    lr = cfg.learning_rate
    losses = []
    for _ in range(n_steps):
        idx, neg = sampler()
        sampler_calls["sgns"] += 1
        losses.append(_sgns_step(emb_in, emb_out, pairs, idx.long(),
                                 neg.long(), lr, inv_b))
    if not losses:
        return torch.zeros(0, device=emb_in.device)
    return torch.stack(losses)


def _table(values: np.ndarray, shape: tuple, dev: torch.device,
           name: str) -> torch.Tensor:
    """`values` as an f32 table of `shape` on `dev` (a copy)."""
    arr = np.asarray(values, dtype=np.float32)
    if arr.shape != shape:
        raise ValueError(f"{name} shape {arr.shape} != {shape}")
    return torch.tensor(arr, device=dev)


def word2vec_fit_pairs(
    pairs: np.ndarray,
    vocab_size: int,
    cfg: Word2VecConfig = Word2VecConfig(),
    device: DeviceLike = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    init_emb_in: Optional[np.ndarray] = None,
    init_emb_out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, list]:
    """`cfg.steps` SGNS steps over a pair table ([P, 2] ids below
    `vocab_size`): (emb_in, emb_out, losses), host numpy.

    The initial tables are `init_emb_in` / `init_emb_out` when given,
    else uniform(−0.5, 0.5)/dim from a generator seeded with `cfg.seed`
    and zeros; the draws come from a second generator, seeded with
    `cfg.seed` + 1 (the reference splits one key into the two).

    `checkpoint_dir`: when set, (emb_in, emb_out, the draws' generator
    state) are checkpointed every `checkpoint_every` steps (default: one
    save at the end) under a fingerprint of the pair table and of every
    config field that shapes an update (not `steps`: resuming into a
    longer run is legal), and a re-run resumes from the latest usable
    step. The chunks, saves and resume are
    `workflow.segmented.segmented_train`'s, with the fault site
    `w2v.step_boundary` after each chunk, before its save."""
    from predictionio_torch.workflow.segmented import (
        fingerprint_of,
        segmented_train,
    )

    dev = resolve_device(device)
    v, k = int(vocab_size), cfg.dim
    pairs = np.ascontiguousarray(pairs, dtype=np.int32)
    pairs_dev = torch.from_numpy(pairs).to(dev).long()
    n_pairs = len(pairs)

    def init_state():
        gen = make_generator(dev, cfg.seed)
        if init_emb_in is None:
            emb_in = torch.empty((v, k), dtype=torch.float32, device=dev)
            emb_in.uniform_(-0.5, 0.5, generator=gen).div_(k)
        else:
            emb_in = _table(init_emb_in, (v, k), dev, "init_emb_in")
        emb_out = (torch.zeros((v, k), dtype=torch.float32, device=dev)
                   if init_emb_out is None
                   else _table(init_emb_out, (v, k), dev, "init_emb_out"))
        return emb_in, emb_out, make_generator(dev, cfg.seed + 1)

    def run_chunk(state, n_steps, done):
        emb_in, emb_out, gen = state
        losses = sgns_loop(emb_in, emb_out, pairs_dev,
                           TorchSampler(gen, n_pairs, v, cfg), n_steps, cfg)
        # the losses' readback is the chunk's fence
        return state, [float(x) for x in losses.cpu()]

    def state_to_host(state):
        emb_in, emb_out, gen = state
        return {"emb_in": emb_in.cpu().numpy(),
                "emb_out": emb_out.cpu().numpy(),
                "rng_state": gen.get_state().numpy()}

    def state_from_host(tree):
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(
            np.ascontiguousarray(tree["rng_state"], dtype=np.uint8)))
        return (_table(tree["emb_in"], (v, k), dev, "emb_in"),
                _table(tree["emb_out"], (v, k), dev, "emb_out"), gen)

    fp = ""
    if checkpoint_dir:
        inits = [a for a in (init_emb_in, init_emb_out) if a is not None]
        fp = fingerprint_of(
            pairs, *[np.asarray(a, dtype=np.float32) for a in inits],
            (v, k, cfg.negatives, cfg.batch_size, cfg.learning_rate,
             cfg.seed, init_emb_in is None, init_emb_out is None, dev.type,
             _FINGERPRINT_TAG))
    state, history, _ = segmented_train(
        total_steps=cfg.steps,
        init_state=init_state,
        run_chunk=run_chunk,
        state_to_host=state_to_host,
        state_from_host=state_from_host,
        fingerprint=fp,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        fault_site="w2v.step_boundary",
        name="word2vec_train",
    )
    emb_in, emb_out, _ = state
    return emb_in.cpu().numpy(), emb_out.cpu().numpy(), history


def word2vec_train(
    docs_tokens: Sequence[Sequence[str]],
    cfg: Word2VecConfig = Word2VecConfig(),
    device: DeviceLike = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    init_emb_in: Optional[np.ndarray] = None,
    init_emb_out: Optional[np.ndarray] = None,
) -> Word2VecModel:
    """Train skip-gram embeddings («Word2Vec.fit»): the vocabulary and
    the pair table on the host, then `word2vec_fit_pairs` on the device
    (its checkpointing and initial tables). The model's vectors are the
    input (center) embeddings, host numpy."""
    vocab = build_vocab(docs_tokens, cfg.min_count, cfg.max_vocab)
    if not vocab:
        raise ValueError("word2vec_train: empty vocabulary")
    pairs = skipgram_pairs(docs_tokens, vocab, cfg.window)
    if len(pairs) == 0:
        raise ValueError("word2vec_train: no skip-gram pairs (docs too short)")
    emb, _, history = word2vec_fit_pairs(
        pairs, len(vocab), cfg, device=device, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, init_emb_in=init_emb_in,
        init_emb_out=init_emb_out)
    if history:
        log.info(
            "word2vec_train: vocab %d, %d pairs, %d steps, loss %.4f → %.4f",
            len(vocab), len(pairs), cfg.steps, history[0], history[-1],
        )
    return Word2VecModel(vectors=emb, vocab=vocab)
