"""Text Classification engine template (DASE components) — the port of
``predictionio_tpu/templates/textclassification/engine.py``.

Documents arrive as `$set` events on "content" entities with text and
category properties; features are hashing-TF → IDF («HashingTF» / «IDF»);
the classifiers are NaiveBayes (the template's default),
LogisticRegression, and the Word2Vec variant («mllib.feature.Word2Vec»)
that classifies mean document embeddings. `read_eval` gives the k-fold
cross-validation the upstream template's `DataSource.readEval` is known
for. The ops (`ops/text.py`, `ops/classify.py`) run on the context's
device.

Wire shapes (kept from the reference):
    query:  {"text": "cheap pills online"}
    result: {"category": "spam", "confidence": 0.93}
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

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
from predictionio_torch.ops.classify import (
    LogRegModel,
    NaiveBayesModel,
    logreg_train,
    logreg_train_grid,
    naive_bayes_train,
    naive_bayes_train_grid,
)
from predictionio_torch.ops.text import (
    IDFModel,
    Word2VecConfig,
    Word2VecModel,
    hashing_tf,
    idf_fit,
    tokenize,
    word2vec_train,
)
from predictionio_torch.templates.similarproduct.engine import store_of

log = logging.getLogger(__name__)

Query = dict  # {"text": str}
PredictedResult = dict  # {"category": str, "confidence": float}


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    entityType: str = "content"
    textProperty: str = "text"
    labelProperty: str = "category"
    evalK: int = 0


@dataclasses.dataclass
class TrainingData(SanityCheck):
    texts: list  # raw document strings
    labels: list  # category strings, aligned

    def sanity_check(self):
        if not self.texts:
            raise ValueError(
                "TrainingData has no documents; $set content entities with "
                "text + category properties first."
            )


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_docs(self, ctx) -> TrainingData:
        """One document per entity holding both properties, in entity-id
        order."""
        props = store_of(ctx).aggregate_properties(
            app_name=self.params.appName,
            entity_type=self.params.entityType,
            required=[self.params.textProperty, self.params.labelProperty],
        )
        texts, labels = [], []
        for eid in sorted(props):
            p = props[eid]
            texts.append(str(p[self.params.textProperty]))
            labels.append(str(p[self.params.labelProperty]))
        return TrainingData(texts, labels)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        td = self._read_docs(ctx)
        log.info("DataSource: %d documents, %d categories, app %r",
                 len(td.texts), len(set(td.labels)), self.params.appName)
        return td

    def read_eval(self, ctx: WorkflowContext):
        """k folds by document index («DataSource.readEval»)."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError("DataSourceParams.evalK must be >= 2 for evaluation")
        td = self._read_docs(ctx)
        n = len(td.texts)
        assign = np.arange(n) % k
        folds = []
        for fold in range(k):
            tr = np.nonzero(assign != fold)[0]
            te = np.nonzero(assign == fold)[0]
            fold_td = TrainingData(
                [td.texts[i] for i in tr], [td.labels[i] for i in tr]
            )
            qa = [
                ({"text": td.texts[i]}, {"category": td.labels[i]})
                for i in te
            ]
            folds.append((fold_td, qa))
        return folds


@dataclasses.dataclass
class PreparedData:
    tokens: list  # list[list[str]], per doc
    labels: list  # category strings
    classes: list  # sorted unique categories
    label_idx: np.ndarray  # [N] int32


class Preparator(BasePreparator):
    """Tokenize and index labels; feature extraction is per algorithm
    (NB / LR hash, Word2Vec embeds)."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        classes = sorted(set(td.labels))
        to_idx = {c: i for i, c in enumerate(classes)}
        return PreparedData(
            tokens=[tokenize(t) for t in td.texts],
            labels=list(td.labels),
            classes=classes,
            label_idx=np.asarray(
                [to_idx[label] for label in td.labels], dtype=np.int32
            ),
        )


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()


def _tfidf(pd: PreparedData, num_features: int,
           min_doc_freq: int) -> tuple[np.ndarray, IDFModel]:
    """The tf-idf features of the prepared documents and their IDF."""
    tf = hashing_tf(pd.tokens, num_features)
    idf = idf_fit(tf, min_doc_freq)
    return idf.transform(tf), idf


@dataclasses.dataclass
class TfIdfClassifierModel:
    """tf-idf features + linear classifier (NB or LR logits)."""

    kind: str  # "nb" | "lr"
    nb: Optional[NaiveBayesModel]
    lr: Optional[LogRegModel]
    idf: IDFModel
    num_features: int
    classes: list

    def classify(self, text: str) -> PredictedResult:
        tf = hashing_tf([tokenize(text)], self.num_features)
        x = self.idf.transform(tf)[0]
        logits = self.nb.logits(x) if self.kind == "nb" else self.lr.logits(x)
        probs = _softmax(logits)
        i = int(np.argmax(probs))
        return {"category": self.classes[i], "confidence": float(probs[i])}


@dataclasses.dataclass
class NBParams(Params):
    lambda_: float = 1.0
    numFeatures: int = 1024
    minDocFreq: int = 0

    _ALIASES = {"lambda": "lambda_"}


class NBAlgorithm(Algorithm):
    """«NBAlgorithm»: hashing-TF → IDF → multinomial NB."""

    params_class = NBParams

    def __init__(self, params: NBParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> TfIdfClassifierModel:
        x, idf = _tfidf(pd, self.params.numFeatures, self.params.minDocFreq)
        nb = naive_bayes_train(
            x, pd.label_idx, n_classes=len(pd.classes),
            smoothing=self.params.lambda_, device=ctx.device,
        )
        return TfIdfClassifierModel(
            kind="nb", nb=nb, lr=None, idf=idf,
            num_features=self.params.numFeatures, classes=pd.classes,
        )

    def predict(self, model: TfIdfClassifierModel, query: Query) -> PredictedResult:
        return model.classify(str(query["text"]))

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list]:
        """A λ grid over one featurization when the cells share
        (numFeatures, minDocFreq): hashing-TF and IDF once, the counts
        once, each λ's finish on top
        (`ops.classify.naive_bayes_train_grid`)."""
        if len({(a.params.numFeatures, a.params.minDocFreq)
                for a in algos}) != 1:
            return None
        x, idf = _tfidf(pd, algos[0].params.numFeatures,
                        algos[0].params.minDocFreq)
        nbs = naive_bayes_train_grid(
            x, pd.label_idx, n_classes=len(pd.classes),
            smoothings=[a.params.lambda_ for a in algos], device=ctx.device)
        return [
            TfIdfClassifierModel(
                kind="nb", nb=nb, lr=None, idf=idf,
                num_features=algos[0].params.numFeatures,
                classes=pd.classes)
            for nb in nbs
        ]


@dataclasses.dataclass
class LRParams(Params):
    iterations: int = 200
    stepSize: float = 0.1
    regParam: float = 0.0
    numFeatures: int = 1024
    minDocFreq: int = 0


class LRAlgorithm(Algorithm):
    """«LRAlgorithm» (the LogisticRegression variant): softmax regression
    over the tf-idf features."""

    params_class = LRParams
    checkpoint_tags = ("lr",)

    def __init__(self, params: LRParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> TfIdfClassifierModel:
        x, idf = _tfidf(pd, self.params.numFeatures, self.params.minDocFreq)
        lr = logreg_train(
            x, pd.label_idx, n_classes=len(pd.classes),
            iterations=self.params.iterations,
            learning_rate=self.params.stepSize,
            reg=self.params.regParam, device=ctx.device,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("lr"),
            checkpoint_every=ctx.checkpoint_every_or(
                max(1, self.params.iterations // 10)),
        )
        return TfIdfClassifierModel(
            kind="lr", nb=None, lr=lr, idf=idf,
            num_features=self.params.numFeatures, classes=pd.classes,
        )

    def predict(self, model: TfIdfClassifierModel, query: Query) -> PredictedResult:
        return model.classify(str(query["text"]))

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list]:
        """A (stepSize, regParam, iterations) grid trained together over
        one featurization (`ops.classify.logreg_train_grid`, each cell
        frozen at its own iteration count); cells that differ in
        (numFeatures, minDocFreq) train one by one."""
        if len({(a.params.numFeatures, a.params.minDocFreq)
                for a in algos}) != 1:
            return None
        x, idf = _tfidf(pd, algos[0].params.numFeatures,
                        algos[0].params.minDocFreq)
        lrs = logreg_train_grid(
            x, pd.label_idx, n_classes=len(pd.classes),
            iterations=[a.params.iterations for a in algos],
            learning_rates=[a.params.stepSize for a in algos],
            regs=[a.params.regParam for a in algos], device=ctx.device)
        return [
            TfIdfClassifierModel(
                kind="lr", nb=None, lr=lr, idf=idf,
                num_features=algos[0].params.numFeatures,
                classes=pd.classes)
            for lr in lrs
        ]


@dataclasses.dataclass
class W2VClassifierModel:
    """Word2Vec document embeddings + softmax regression on top."""

    w2v: Word2VecModel
    lr: LogRegModel
    classes: list

    def classify(self, text: str) -> PredictedResult:
        x = self.w2v.doc_vector(tokenize(text))
        probs = _softmax(self.lr.logits(x))
        i = int(np.argmax(probs))
        return {"category": self.classes[i], "confidence": float(probs[i])}


@dataclasses.dataclass
class Word2VecParams(Params):
    dim: int = 32
    window: int = 5
    negatives: int = 5
    steps: int = 300
    batchSize: int = 256
    learningRate: float = 0.05
    minCount: int = 1
    seed: Optional[int] = None
    # classifier head
    iterations: int = 200
    stepSize: float = 0.1
    regParam: float = 0.0


class Word2VecAlgorithm(Algorithm):
    """The Word2Vec variant: train embeddings, classify mean document
    vectors."""

    params_class = Word2VecParams
    checkpoint_tags = ("w2v", "w2v-head")

    def __init__(self, params: Word2VecParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> W2VClassifierModel:
        p = self.params
        cfg = Word2VecConfig(
            dim=p.dim, window=p.window, negatives=p.negatives,
            steps=p.steps, batch_size=p.batchSize,
            learning_rate=p.learningRate, min_count=p.minCount,
            seed=ctx.seed if p.seed is None else p.seed,
        )
        # two checkpointed phases under separate subdirs: a crash during
        # the head's train resumes the embeddings from their completed
        # checkpoint instead of running the SGNS loop again
        w2v = word2vec_train(
            pd.tokens, cfg, device=ctx.device,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("w2v"),
            checkpoint_every=ctx.checkpoint_every_or(
                max(1, cfg.steps // 10)),
        )
        docs = np.stack([w2v.doc_vector(t) for t in pd.tokens])
        lr = logreg_train(
            docs, pd.label_idx, n_classes=len(pd.classes),
            iterations=p.iterations, learning_rate=p.stepSize,
            reg=p.regParam, device=ctx.device,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("w2v-head"),
            checkpoint_every=ctx.checkpoint_every_or(
                max(1, p.iterations // 10)),
        )
        return W2VClassifierModel(w2v=w2v, lr=lr, classes=pd.classes)

    def predict(self, model: W2VClassifierModel, query: Query) -> PredictedResult:
        return model.classify(str(query["text"]))


class TextClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={
                "nb": NBAlgorithm,
                "lr": LRAlgorithm,
                "word2vec": Word2VecAlgorithm,
            },
            serving_class_map=FirstServing,
        )
