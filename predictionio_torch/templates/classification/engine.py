"""Classification engine template (DASE components) — the port of
``predictionio_tpu/templates/classification/engine.py``.

`DataSource` builds labeled points from `$set` entity properties
(`aggregate_properties` → attr0/attr1/attr2 features and the "plan" label,
the quickstart schema); the algorithms are NaiveBayes (the template's
default) and LogisticRegression (the documented variant), computed by
`predictionio_torch.ops.classify` on the context's device in place of
MLlib. Both train a hyperparameter grid together (`train_grid`) for
`Engine.eval_grid`.

Wire shapes (kept from the reference):
    query:  {"attr0": 2.0, "attr1": 0.0, "attr2": 0.0}
    result: {"label": 4.0}
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
from predictionio_torch.templates.similarproduct.engine import store_of

log = logging.getLogger(__name__)

Query = dict  # {"attr0": float, "attr1": float, "attr2": float}
PredictedResult = dict  # {"label": float}


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    entityType: str = "user"
    attributes: list = dataclasses.field(
        default_factory=lambda: ["attr0", "attr1", "attr2"]
    )
    labelAttribute: str = "plan"
    evalK: int = 0  # >1 enables read_eval with k folds


@dataclasses.dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # [N, D] float32
    labels: np.ndarray  # [N] float32: the label values as stored
    # the feature columns' order, carried to serving so that a query dict
    # is vectorised in training order
    attributes: list = dataclasses.field(default_factory=list)

    def sanity_check(self):
        if len(self.labels) == 0:
            raise ValueError(
                "TrainingData has no labeled points; $set entity properties "
                "with the configured attributes + label first."
            )


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_points(self, ctx) -> TrainingData:
        """One point per entity holding every attribute and the label,
        in entity-id order."""
        props = store_of(ctx).aggregate_properties(
            app_name=self.params.appName,
            entity_type=self.params.entityType,
            required=list(self.params.attributes) + [self.params.labelAttribute],
        )
        feats, labels = [], []
        for eid in sorted(props):
            p = props[eid]
            feats.append([float(p[a]) for a in self.params.attributes])
            labels.append(float(p[self.params.labelAttribute]))
        return TrainingData(
            np.asarray(feats, dtype=np.float32).reshape(
                len(labels), len(self.params.attributes)
            ),
            np.asarray(labels, dtype=np.float32),
            attributes=list(self.params.attributes),
        )

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        td = self._read_points(ctx)
        log.info(
            "DataSource: %d labeled points, %d classes, app %r",
            len(td.labels), len(np.unique(td.labels)), self.params.appName,
        )
        return td

    def read_eval(self, ctx: WorkflowContext):
        """k folds by point index («DataSource.readEval»); a query carries
        the point's feature dict, its actual {"label": value}."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError("DataSourceParams.evalK must be >= 2 for evaluation")
        td = self._read_points(ctx)
        n = len(td.labels)
        assign = np.arange(n) % k
        folds = []
        attrs = list(self.params.attributes)
        for fold in range(k):
            train_sel = assign != fold
            fold_td = TrainingData(
                td.features[train_sel], td.labels[train_sel], attributes=attrs
            )
            qa = [
                (
                    {a: float(td.features[j, i]) for i, a in enumerate(attrs)},
                    {"label": float(td.labels[j])},
                )
                for j in np.nonzero(~train_sel)[0]
            ]
            folds.append((fold_td, qa))
        return folds


@dataclasses.dataclass
class PreparedData:
    features: np.ndarray  # [N, D] float32
    label_idx: np.ndarray  # [N] int32: dense class index
    classes: np.ndarray  # [C] float32: class index → label value
    attributes: list  # feature-column order, for query vectorisation


class Preparator(BasePreparator):
    """Label values → dense class indices (the BiMap step of MLlib
    templates)."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        classes, label_idx = np.unique(td.labels, return_inverse=True)
        return PreparedData(
            features=td.features,
            label_idx=label_idx.astype(np.int32),
            classes=classes.astype(np.float32),
            attributes=list(td.attributes),
        )


def _query_vector(query: Query, attributes: list) -> np.ndarray:
    """A query dict vectorised in training column order (the configured
    attribute names); a "features" list is taken as it is."""
    if "features" in query:
        v = np.asarray(query["features"], dtype=np.float32)
        if v.shape[0] != len(attributes):
            raise ValueError(
                f"query has {v.shape[0]} features, model expects "
                f"{len(attributes)}"
            )
        return v
    try:
        return np.asarray(
            [float(query[a]) for a in attributes], dtype=np.float32
        )
    except KeyError as e:
        raise ValueError(
            f"query is missing attribute {e.args[0]!r} "
            f"(model features: {attributes})"
        ) from None


@dataclasses.dataclass
class NBServingModel:
    nb: NaiveBayesModel
    classes: np.ndarray
    attributes: list

    def predict_label(self, x: np.ndarray) -> float:
        return float(self.classes[int(np.argmax(self.nb.logits(x)))])


@dataclasses.dataclass
class NaiveBayesParams(Params):
    lambda_: float = 1.0  # engine.json key "lambda"

    _ALIASES = {"lambda": "lambda_"}


class NaiveBayesAlgorithm(Algorithm):
    """«NaiveBayesAlgorithm.train/predict» → `ops.classify` NB."""

    params_class = NaiveBayesParams

    def __init__(self, params: NaiveBayesParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> NBServingModel:
        nb = naive_bayes_train(
            pd.features, pd.label_idx, n_classes=len(pd.classes),
            smoothing=self.params.lambda_, device=ctx.device,
        )
        return NBServingModel(nb=nb, classes=pd.classes,
                              attributes=pd.attributes)

    def predict(self, model: NBServingModel, query: Query) -> PredictedResult:
        x = _query_vector(query, model.attributes)
        return {"label": model.predict_label(x)}

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list]:
        """A λ (smoothing) grid: the counts once, each λ's finish on
        top (`ops.classify.naive_bayes_train_grid`)."""
        smoothings = [a.params.lambda_ for a in algos]
        nbs = naive_bayes_train_grid(
            pd.features, pd.label_idx, n_classes=len(pd.classes),
            smoothings=smoothings, device=ctx.device)
        return [NBServingModel(nb=nb, classes=pd.classes,
                               attributes=pd.attributes) for nb in nbs]


@dataclasses.dataclass
class LRServingModel:
    lr: LogRegModel
    classes: np.ndarray
    attributes: list

    def predict_label(self, x: np.ndarray) -> float:
        return float(self.classes[int(np.argmax(self.lr.logits(x)))])


@dataclasses.dataclass
class LogisticRegressionParams(Params):
    iterations: int = 200
    stepSize: float = 0.1  # MLlib SGD naming
    regParam: float = 0.0


class LogisticRegressionAlgorithm(Algorithm):
    """«LogisticRegressionWithLBFGS» variant → softmax regression
    (full-batch Adam, `ops.classify.logreg_train`)."""

    params_class = LogisticRegressionParams
    checkpoint_tags = ("lr",)

    def __init__(self, params: LogisticRegressionParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> LRServingModel:
        lr = logreg_train(
            pd.features, pd.label_idx, n_classes=len(pd.classes),
            iterations=self.params.iterations,
            learning_rate=self.params.stepSize,
            reg=self.params.regParam, device=ctx.device,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("lr"),
            checkpoint_every=ctx.checkpoint_every_or(
                max(1, self.params.iterations // 10)),
        )
        return LRServingModel(lr=lr, classes=pd.classes,
                              attributes=pd.attributes)

    def predict(self, model: LRServingModel, query: Query) -> PredictedResult:
        x = _query_vector(query, model.attributes)
        return {"label": model.predict_label(x)}

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list]:
        """A (stepSize, regParam, iterations) grid trained together
        (`ops.classify.logreg_train_grid`), each cell frozen at its own
        iteration count."""
        lrs = logreg_train_grid(
            pd.features, pd.label_idx, n_classes=len(pd.classes),
            iterations=[a.params.iterations for a in algos],
            learning_rates=[a.params.stepSize for a in algos],
            regs=[a.params.regParam for a in algos], device=ctx.device)
        return [LRServingModel(lr=lr, classes=pd.classes,
                               attributes=pd.attributes) for lr in lrs]


class ClassificationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={
                "naive": NaiveBayesAlgorithm,
                "logisticregression": LogisticRegressionAlgorithm,
            },
            serving_class_map=FirstServing,
        )
