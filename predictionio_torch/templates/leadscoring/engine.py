"""Lead Scoring engine template (DASE components) — the port of
``predictionio_tpu/templates/leadscoring/engine.py``.

Scores how likely a visit converts (a `buy` happens in its session) from
the session's first-view attributes: landing page, referrer, browser. The
upstream gallery template («template-scala-parallel-leadscoring») trains
an MLlib RandomForest on those three categorical features; here, as in the
reference, the classifier is the softmax regression of `ops/classify.py`
over their one-hot encodings, on the context's device: a documented
substitution with the same feature contract and query shape.

Events:
    view: {"event": "view", "entityType": "user", properties:
           {"sessionId": "s1", "landingPageId": "lp1",
            "referrerId": "r1", "browser": "Chrome"}}
    buy:  {"event": "buy", "entityType": "user", properties:
           {"sessionId": "s1"}}

Wire shapes:
    query:  {"landingPageId": "lp1", "referrerId": "r1",
             "browser": "Chrome"}
    result: {"score": 0.73}
"""

from __future__ import annotations

import dataclasses
import logging

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
from predictionio_torch.e2.evaluation import cross_validation_splits
from predictionio_torch.ops.classify import LogRegModel, logreg_train
from predictionio_torch.templates.similarproduct.engine import store_of

log = logging.getLogger(__name__)

Query = dict
PredictedResult = dict

_FEATURE_FIELDS = ("landingPageId", "referrerId", "browser")


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    viewEvents: list = dataclasses.field(default_factory=lambda: ["view"])
    buyEvents: list = dataclasses.field(default_factory=lambda: ["buy"])
    evalK: int = 0  # >1 enables read_eval with k session folds


@dataclasses.dataclass
class Session:
    features: tuple  # (landingPageId, referrerId, browser)
    converted: bool


@dataclasses.dataclass
class TrainingData(SanityCheck):
    sessions: list  # of Session

    def sanity_check(self):
        if not self.sessions:
            raise ValueError(
                "TrainingData has no sessions; ingest view events with "
                "sessionId/landingPageId/referrerId/browser properties.")
        if all(s.converted for s in self.sessions) or not any(
                s.converted for s in self.sessions):
            log.warning("TrainingData: all sessions share one label; the "
                        "score will be degenerate")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        store = store_of(ctx)
        sessions: dict[str, tuple] = {}
        for ev in store.find(app_name=self.params.appName,
                             event_names=list(self.params.viewEvents)):
            sid = ev.properties.get("sessionId")
            if sid is None:
                continue
            sid = str(sid)  # a numeric id compares as its stored text
            if not sid or sid in sessions:
                continue  # the first view defines the session's features
            sessions[sid] = tuple(
                str(ev.properties.get(f, "")) for f in _FEATURE_FIELDS)
        converted = set()
        for ev in store.find(app_name=self.params.appName,
                             event_names=list(self.params.buyEvents)):
            sid = ev.properties.get("sessionId")
            if sid is not None and str(sid):
                converted.add(str(sid))
        out = [Session(features=f, converted=sid in converted)
               for sid, f in sessions.items()]
        log.info("DataSource: %d sessions (%d converted), app %r",
                 len(out), sum(s.converted for s in out),
                 self.params.appName)
        return TrainingData(sessions=out)

    def read_eval(self, ctx: WorkflowContext):
        """k folds over sessions («DataSource.readEval»): fold i tests on
        every k-th session. A query carries the session's features, its
        actual the conversion label, scored with `metrics.AUC`."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError(
                "DataSourceParams.evalK must be >= 2 for evaluation")
        td = self.read_training(ctx)
        return cross_validation_splits(
            td.sessions, k,
            create_training=lambda train: TrainingData(sessions=train),
            to_query_actual=lambda s: (
                dict(zip(_FEATURE_FIELDS, s.features)),
                {"label": 1 if s.converted else 0}))


@dataclasses.dataclass
class PreparedData:
    features: np.ndarray  # [n_sessions, D] one-hot blocks
    labels: np.ndarray  # [n_sessions] int32 (1 = converted)
    vocabs: list  # per feature field: {value: column offset within block}
    offsets: list  # per feature field: block start column


class Preparator(BasePreparator):
    """One-hot encodes the three categorical session features."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        vocabs: list[dict] = []
        offsets: list[int] = []
        d = 0
        for f_i in range(len(_FEATURE_FIELDS)):
            values = sorted({s.features[f_i] for s in td.sessions})
            vocabs.append({v: j for j, v in enumerate(values)})
            offsets.append(d)
            d += len(values)
        x = np.zeros((len(td.sessions), d), np.float32)
        y = np.zeros(len(td.sessions), np.int32)
        for r, s in enumerate(td.sessions):
            for f_i, v in enumerate(s.features):
                x[r, offsets[f_i] + vocabs[f_i][v]] = 1.0
            y[r] = 1 if s.converted else 0
        return PreparedData(features=x, labels=y, vocabs=vocabs,
                            offsets=offsets)


@dataclasses.dataclass
class LeadScoringModel:
    lr: LogRegModel
    vocabs: list
    offsets: list
    base_rate: float  # training conversion rate (unseen-feature fallback)

    def score(self, landing: str, referrer: str, browser: str) -> float:
        d = self.lr.weights.shape[0]
        x = np.zeros((1, d), np.float32)
        known = 0
        for f_i, v in enumerate((landing, referrer, browser)):
            j = self.vocabs[f_i].get(str(v))
            if j is not None:
                x[0, self.offsets[f_i] + j] = 1.0
                known += 1
        if known == 0:
            # a wholly unseen visit: the prior, not a logit of zeros
            return self.base_rate
        logits = self.lr.logits(x)[0]
        e = np.exp(logits - logits.max())
        return float(e[1] / e.sum())


@dataclasses.dataclass
class LeadScoringParams(Params):
    iterations: int = 300
    stepSize: float = 0.1
    regParam: float = 0.01


class LeadScoringAlgorithm(Algorithm):
    params_class = LeadScoringParams
    checkpoint_tags = ("lr",)

    def __init__(self, params: LeadScoringParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> LeadScoringModel:
        lr = logreg_train(
            pd.features, pd.labels, n_classes=2,
            iterations=self.params.iterations,
            learning_rate=self.params.stepSize,
            reg=self.params.regParam, device=ctx.device,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("lr"),
            checkpoint_every=ctx.checkpoint_every_or(
                max(1, self.params.iterations // 10)))
        rate = float(pd.labels.mean()) if len(pd.labels) else 0.0
        ctx.metrics.emit("train/leadscoring", sessions=len(pd.labels),
                         conversion_rate=rate)
        return LeadScoringModel(lr=lr, vocabs=pd.vocabs,
                                offsets=pd.offsets, base_rate=rate)

    def predict(self, model: LeadScoringModel, query: Query) -> PredictedResult:
        return {"score": model.score(
            str(query.get("landingPageId", "")),
            str(query.get("referrerId", "")),
            str(query.get("browser", "")))}


class LeadScoringEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"leadscoring": LeadScoringAlgorithm},
            serving_class_map=FirstServing,
        )
