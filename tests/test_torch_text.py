"""The port's text ops (`predictionio_torch/ops/text.py`) on the CPU, held
against the reference's (`predictionio_tpu/ops/text.py`): tokenize,
hashing TF, IDF, the vocabulary and the skip-gram pair table array-equal
(the pair table in order: the sampler indexes into it); the SGNS loop,
fed the reference's `jax.random` draws from the same initial tables,
within rtol 1e-5 / atol 1e-6 of `_w2v_train_loop` (the reference's own
bar, tests/test_textclassification_template.py:263-265); the sparse step
against torch autograd over the full tables; the fixed-order scatter;
chunked ≡ single ≡ resumed bitwise and a changed config retraining (the
counterparts of tests/test_checkpoint.py:273-313); the reference's
co-occurrence case."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import text as ref
from predictionio_torch.ops import text as port
from predictionio_torch.utils.faults import FaultInjected
from predictionio_torch.workflow.checkpoint import CheckpointManager

LOOP_TOL = dict(rtol=1e-5, atol=1e-6)

torch.set_num_threads(1)


def port_cfg(cfg) -> port.Word2VecConfig:
    return port.Word2VecConfig(**dataclasses.asdict(cfg))


def corpus(seed: int, n_docs: int = 60, n_words: int = 40) -> list:
    """Seeded documents of 0-13 tokens over `n_words` words (Zipf-ish
    frequencies, so counts tie and differ), empty and one- or two-token
    documents among them."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)] + ["it's", "42"]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    lengths = rng.integers(0, 14, n_docs)
    lengths[:4] = (0, 1, 2, 0)
    return [[words[j] for j in rng.choice(len(words), n, p=p)]
            for n in lengths]


# -- host functions: array-equal ---------------------------------------------

def test_tokenize_matches_reference():
    rng = np.random.default_rng(0)
    alphabet = list("abcXYZ019' .,!?-é\t\n")
    texts = ["Hello, World! it's 42.", "", "  ", "DON'T stop--now"]
    texts += ["".join(rng.choice(alphabet, rng.integers(0, 40)))
              for _ in range(200)]
    for t in texts:
        assert port.tokenize(t) == ref.tokenize(t), t


@pytest.mark.parametrize("num_features", [7, 32, 1024])
def test_hashing_tf_matches_reference(num_features):
    docs = corpus(1)
    got = port.hashing_tf(docs, num_features)
    want = ref.hashing_tf(docs, num_features)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert port.hashing_tf([], num_features).shape == (0, num_features)


@pytest.mark.parametrize("min_doc_freq", [0, 2, 5])
def test_idf_matches_reference(min_doc_freq):
    tf = ref.hashing_tf(corpus(2), 64)
    got = port.idf_fit(tf, min_doc_freq)
    want = ref.idf_fit(tf, min_doc_freq)
    assert got.idf.dtype == want.idf.dtype
    np.testing.assert_array_equal(got.idf, want.idf)
    np.testing.assert_array_equal(got.transform(tf), want.transform(tf))


@pytest.mark.parametrize("min_count,max_size", [(1, None), (2, None),
                                                (1, 5), (3, 8)])
def test_build_vocab_matches_reference(min_count, max_size):
    docs = corpus(3)
    got = port.build_vocab(docs, min_count, max_size)
    want = ref.build_vocab(docs, min_count, max_size)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("window", [0, 1, 2, 5])
def test_skipgram_pairs_match_reference(seed, window):
    """In order and dtype, with out-of-vocabulary tokens (a vocabulary cut
    to its 20 most frequent words), empty documents and documents shorter
    than the window."""
    docs = corpus(seed)
    vocab = ref.build_vocab(docs, max_size=20)
    assert any(t not in vocab for doc in docs for t in doc)
    got = port.skipgram_pairs(docs, vocab, window)
    want = ref.skipgram_pairs(docs, vocab, window)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_skipgram_pairs_without_pairs_match_reference():
    vocab = {"a": 0, "b": 1}
    for docs in ([], [[]], [["a"], ["b"]], [["x", "a", "y"], ["z"]]):
        got = port.skipgram_pairs(docs, vocab, 2)
        want = ref.skipgram_pairs(docs, vocab, 2)
        assert got.dtype == want.dtype and got.shape == want.shape == (0, 2)


def test_model_methods_match_reference():
    """Given the same vectors, `vector`, `doc_vector` (bit for bit) and
    `similar` answer alike."""
    docs = corpus(7)
    vocab = ref.build_vocab(docs)
    vectors = np.random.default_rng(7).normal(
        size=(len(vocab), 6)).astype(np.float32)
    got = port.Word2VecModel(vectors=vectors, vocab=vocab)
    want = ref.Word2VecModel(vectors=vectors, vocab=vocab)
    for tokens in docs + [["nope"], []]:
        np.testing.assert_array_equal(got.doc_vector(tokens),
                                      want.doc_vector(tokens))
    for token in ("w0", "w3", "it's", "nope"):
        assert got.similar(token, 5) == want.similar(token, 5)
        g, w = got.vector(token), want.vector(token)
        assert (g is None and w is None) or np.array_equal(g, w)


# -- the SGNS loop against the reference's ------------------------------------

def jax_draws(key, n_steps: int, cfg, n_pairs: int, vocab_size: int) -> list:
    """The draws `_w2v_train_loop` makes from `key`, step by step
    (text.py:184-190), as int64 tensors."""
    draws = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        idx = jax.random.randint(k1, (cfg.batch_size,), 0, n_pairs)
        neg = jax.random.randint(k2, (cfg.batch_size, cfg.negatives), 0,
                                 vocab_size)
        draws.append((torch.from_numpy(np.asarray(idx).astype(np.int64)),
                      torch.from_numpy(np.asarray(neg).astype(np.int64))))
    return draws


def loop_inputs(seed: int, v: int, p: int, dim: int):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, v, (p, 2)).astype(np.int32)
    emb_in = rng.normal(size=(v, dim)).astype(np.float32)
    emb_out = rng.normal(size=(v, dim)).astype(np.float32)
    return pairs, emb_in, emb_out


@pytest.mark.parametrize("v,p,batch,negatives,lr,steps", [
    (50, 200, 16, 4, 0.1, 5),
    (60, 300, 64, 5, 0.5, 8),
    (400, 2_000, 128, 3, 0.05, 6),
])
def test_sgns_loop_matches_reference_on_its_draws(v, p, batch, negatives,
                                                 lr, steps):
    """Tables and losses within rtol 1e-5 / atol 1e-6 after ≥ 5 steps in
    which rows repeat within a batch."""
    cfg = ref.Word2VecConfig(dim=8, steps=steps, batch_size=batch,
                             negatives=negatives, learning_rate=lr, seed=0)
    pairs, emb_in0, emb_out0 = loop_inputs(v + p, v, p, cfg.dim)
    key = jax.random.key(v)
    (want_in, want_out, _), want_losses = ref._w2v_train_loop(
        p, v, cfg, steps)(key, jnp.asarray(pairs), jnp.asarray(emb_in0),
                          jnp.asarray(emb_out0))
    draws = jax_draws(key, steps, cfg, p, v)
    # rows repeat inside a batch: the scatter's duplicates are exercised
    idx, neg = draws[0]
    assert len(torch.unique(neg)) < neg.numel()
    assert len(np.unique(pairs[idx.numpy(), 0])) < batch
    emb_in = torch.tensor(emb_in0)
    emb_out = torch.tensor(emb_out0)
    port.reset_sampler_calls()
    losses = port.sgns_loop(emb_in, emb_out,
                            torch.from_numpy(pairs).long(),
                            iter(draws).__next__, steps, port_cfg(cfg))
    assert port.sampler_calls["sgns"] == steps
    np.testing.assert_allclose(emb_in.numpy(), np.asarray(want_in),
                               **LOOP_TOL)
    np.testing.assert_allclose(emb_out.numpy(), np.asarray(want_out),
                               **LOOP_TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               **LOOP_TOL)


def test_sparse_step_matches_dense_autograd():
    """The hand-derived sparse step equals torch autograd over the full
    tables (loss → dense gradients → SGD on every row), on the same draws
    (the counterpart of TestWord2VecSparseStep)."""
    v, p = 50, 200
    cfg = port.Word2VecConfig(dim=8, steps=3, batch_size=16, negatives=4,
                              learning_rate=0.1)
    pairs, emb_in0, emb_out0 = loop_inputs(0, v, p, cfg.dim)
    gen = torch.Generator().manual_seed(7)
    draws = [port.TorchSampler(gen, p, v, cfg)() for _ in range(cfg.steps)]
    pairs_t = torch.from_numpy(pairs).long()

    emb_in, emb_out = torch.tensor(emb_in0), torch.tensor(emb_out0)
    losses = port.sgns_loop(emb_in, emb_out, pairs_t, iter(draws).__next__,
                            cfg.steps, cfg)

    d_in, d_out = torch.tensor(emb_in0), torch.tensor(emb_out0)
    dense_losses = []
    for idx, neg in draws:
        center, ctx = pairs_t[idx, 0], pairs_t[idx, 1]
        d_in.requires_grad_(True)
        d_out.requires_grad_(True)
        c, pos, ngs = d_in[center], d_out[ctx], d_out[neg]
        ps = (c * pos).sum(-1)
        ns = torch.einsum("bk,bnk->bn", c, ngs)
        loss = -(torch.nn.functional.logsigmoid(ps).mean()
                 + torch.nn.functional.logsigmoid(-ns).sum(-1).mean())
        g_in, g_out = torch.autograd.grad(loss, (d_in, d_out))
        with torch.no_grad():
            d_in = d_in - cfg.learning_rate * g_in
            d_out = d_out - cfg.learning_rate * g_out
        dense_losses.append(float(loss.detach()))
    np.testing.assert_allclose(emb_in.numpy(), d_in.numpy(), **LOOP_TOL)
    np.testing.assert_allclose(emb_out.numpy(), d_out.numpy(), **LOOP_TOL)
    np.testing.assert_allclose(losses.numpy(), dense_losses, rtol=1e-5)


def test_scatter_add_rows_sums_duplicates_in_a_fixed_order():
    """Every row gets the sum of its updates (against float64), rows not
    named stay as they were, and two calls give the same bits; with
    whole-number updates the sum is exact."""
    rng = np.random.default_rng(1)
    v, m, k = 30, 500, 6
    ids = torch.from_numpy(rng.integers(0, v - 5, m))
    rows = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    table0 = torch.from_numpy(rng.normal(size=(v, k)).astype(np.float32))
    want = table0.double().index_add(0, ids, rows.double())
    got = table0.clone()
    port.scatter_add_rows(got, ids, rows)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got[v - 5:], table0[v - 5:])
    again = table0.clone()
    port.scatter_add_rows(again, ids, rows)
    assert torch.equal(got, again)
    whole, start = torch.round(rows * 8), torch.round(table0 * 8)
    exact = start.clone()
    port.scatter_add_rows(exact, ids, whole)
    assert torch.equal(exact, start.index_add(0, ids, whole))


# -- word2vec_train: init, chunks, resume --------------------------------------

def docs_and_cfg():
    docs = [["the", "cat", "sat", "on", "mat"],
            ["dog", "ate", "cat", "food"],
            ["the", "dog", "sat"]] * 15
    return docs, port.Word2VecConfig(dim=8, steps=30, batch_size=32,
                                     negatives=3, seed=3)


def test_initial_tables_and_shared_init():
    """steps = 0 returns the initial tables: emb_in uniform in ±0.5/dim
    from the seed, emb_out zeros; given tables are taken as they are."""
    docs, cfg = docs_and_cfg()
    zero = dataclasses.replace(cfg, steps=0)
    m = port.word2vec_train(docs, zero, device="cpu")
    assert m.vectors.shape == (len(m.vocab), cfg.dim)
    assert np.abs(m.vectors).max() <= 0.5 / cfg.dim
    np.testing.assert_array_equal(
        m.vectors, port.word2vec_train(docs, zero, device="cpu").vectors)
    init = np.full((len(m.vocab), cfg.dim), 0.25, np.float32)
    emb_in, emb_out, history = port.word2vec_fit_pairs(
        np.zeros((4, 2), np.int32), len(m.vocab), zero, device="cpu",
        init_emb_in=init, init_emb_out=init * 2)
    np.testing.assert_array_equal(emb_in, init)
    np.testing.assert_array_equal(emb_out, init * 2)
    assert history == []
    with pytest.raises(ValueError, match="init_emb_in shape"):
        port.word2vec_fit_pairs(np.zeros((4, 2), np.int32), 3, zero,
                                device="cpu", init_emb_in=init)


def test_empty_inputs_raise():
    cfg = port.Word2VecConfig(steps=1)
    with pytest.raises(ValueError, match="empty vocabulary"):
        port.word2vec_train([[], []], cfg, device="cpu")
    with pytest.raises(ValueError, match="no skip-gram pairs"):
        port.word2vec_train([["a"], ["b"]], cfg, device="cpu")


def test_chunked_matches_single_dispatch(tmp_path):
    docs, cfg = docs_and_cfg()
    base = port.word2vec_train(docs, cfg, device="cpu")
    again = port.word2vec_train(docs, cfg, device="cpu")
    chunked = port.word2vec_train(docs, cfg, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=7)
    np.testing.assert_array_equal(again.vectors, base.vectors)
    np.testing.assert_array_equal(chunked.vectors, base.vectors)
    assert chunked.vocab == base.vocab
    assert CheckpointManager(str(tmp_path)).all_steps() == [21, 28, 30]


def test_resume_continues_sampling_sequence(tmp_path, caplog):
    """The checkpoint carries the draws' generator state, so a resumed
    run draws the batches the uninterrupted run would have: bitwise equal
    embeddings."""
    docs, cfg = docs_and_cfg()
    base = port.word2vec_train(docs, cfg, device="cpu")
    port.word2vec_train(docs, dataclasses.replace(cfg, steps=14),
                        device="cpu", checkpoint_dir=str(tmp_path),
                        checkpoint_every=7)
    port.reset_sampler_calls()
    with caplog.at_level(logging.INFO, "predictionio_torch.workflow"):
        got = port.word2vec_train(docs, cfg, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=7)
    assert "word2vec_train: resumed from checkpoint step 14" in caplog.text
    assert port.sampler_calls["sgns"] == cfg.steps - 14
    np.testing.assert_array_equal(got.vectors, base.vectors)


def test_changed_config_retrains(tmp_path, caplog):
    docs, cfg = docs_and_cfg()
    port.word2vec_train(docs, cfg, device="cpu",
                        checkpoint_dir=str(tmp_path), checkpoint_every=10)
    cfg2 = dataclasses.replace(cfg, learning_rate=0.01)
    base = port.word2vec_train(docs, cfg2, device="cpu")
    with caplog.at_level(logging.WARNING, "predictionio_torch.workflow"):
        got = port.word2vec_train(docs, cfg2, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=10)
    assert "different data/config" in caplog.text
    np.testing.assert_array_equal(got.vectors, base.vectors)


def test_fault_at_step_boundary_then_resume(tmp_path, monkeypatch):
    """`w2v.step_boundary:2=error` raises after the 2nd chunk, before its
    save: step 10 is left; the re-run resumes from it and ends on the
    uninterrupted vectors."""
    docs, cfg = docs_and_cfg()
    base = port.word2vec_train(docs, cfg, device="cpu")
    monkeypatch.setenv("PIO_FAULTS", "w2v.step_boundary:2=error")
    with pytest.raises(FaultInjected):
        port.word2vec_train(docs, cfg, device="cpu",
                            checkpoint_dir=str(tmp_path),
                            checkpoint_every=10)
    assert CheckpointManager(str(tmp_path)).all_steps() == [10]
    monkeypatch.delenv("PIO_FAULTS")
    got = port.word2vec_train(docs, cfg, device="cpu",
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=10)
    np.testing.assert_array_equal(got.vectors, base.vectors)


def test_reference_checkpoint_is_not_resumed(tmp_path, caplog):
    """A reference checkpoint in the same directory fingerprints
    otherwise: the port trains from scratch."""
    docs, cfg = docs_and_cfg()
    ref.word2vec_train(docs, ref.Word2VecConfig(**dataclasses.asdict(cfg)),
                       checkpoint_dir=str(tmp_path), checkpoint_every=10)
    base = port.word2vec_train(docs, cfg, device="cpu")
    with caplog.at_level(logging.WARNING, "predictionio_torch.workflow"):
        got = port.word2vec_train(docs, cfg, device="cpu",
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=10)
    assert "different data/config" in caplog.text
    np.testing.assert_array_equal(got.vectors, base.vectors)


def cooccurrence_docs() -> list:
    """The reference's case: "sun"/"moon" share contexts, "cat"/"dog"
    share others."""
    docs = []
    for _ in range(30):
        docs.append(["bright", "sun", "sky"])
        docs.append(["bright", "moon", "sky"])
        docs.append(["furry", "cat", "pet"])
        docs.append(["furry", "dog", "pet"])
    return docs


def moon_margin(model) -> float:
    sims = dict(model.similar("sun", num=len(model.vocab)))
    return sims["moon"] - max(sims["cat"], sims["dog"])


def test_word2vec_cooccurring_tokens_similar_on_the_references_draws():
    """The reference's case at its settings (dim 16, window 2, 400 steps
    of 128 at lr 0.05, seed 0), through the port's vocabulary, pair table
    and loop from the reference's initial tables and draws: the vectors
    within the loop's bar of the reference's `word2vec_train`, and "moon"
    nearer "sun" than "cat" and "dog". At these settings the margin is
    about 0.004 either way and follows the draws: the reference's own
    stream misses it at seeds 2, 11 and 15 of 0-19, the port's
    generator at 0, 6, 10 and 12 (measured), so the case is held on one
    stream."""
    docs = cooccurrence_docs()
    cfg = ref.Word2VecConfig(dim=16, window=2, steps=400, batch_size=128,
                             seed=0)
    want = ref.word2vec_train(docs, cfg)
    vocab = port.build_vocab(docs)
    pairs = port.skipgram_pairs(docs, vocab, cfg.window)
    k_init, k_run = jax.random.split(jax.random.key(cfg.seed))
    emb_in = torch.tensor(np.asarray(jax.random.uniform(
        k_init, (len(vocab), cfg.dim), minval=-0.5, maxval=0.5) / cfg.dim))
    emb_out = torch.zeros_like(emb_in)
    draws = jax_draws(k_run, cfg.steps, cfg, len(pairs), len(vocab))
    port.sgns_loop(emb_in, emb_out, torch.from_numpy(pairs).long(),
                   iter(draws).__next__, cfg.steps, port_cfg(cfg))
    got = port.Word2VecModel(vectors=emb_in.numpy(), vocab=vocab)
    assert vocab == want.vocab
    np.testing.assert_allclose(got.vectors, want.vectors, **LOOP_TOL)
    assert moon_margin(got) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_word2vec_cooccurring_tokens_similar_on_its_own_draws(seed):
    """The same corpus at learning rate 0.5, where the case is decided by
    the data and not by the draws (margin 0.56-0.73 in both packages at
    seeds 0-9, measured): the port's own generator puts "moon" nearer
    "sun" than "cat" and "dog" by more than 0.3."""
    m = port.word2vec_train(
        cooccurrence_docs(),
        port.Word2VecConfig(dim=16, window=2, steps=400, batch_size=128,
                            learning_rate=0.5, seed=seed), device="cpu")
    assert moon_margin(m) > 0.3
