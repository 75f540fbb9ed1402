"""Engine: binds DASE component classes + params into a trainable,
deployable unit — the port of ``predictionio_tpu/controller/engine.py``,
reduced to train, eval, eval_grid, model (de)serialization, predict,
predict_batch and degraded_predict. Every algorithm trains inside its
checkpoint scope (`_ckpt_suffixes`); a train's read, prepare and algorithm
stages are named ranges on a `--profile-dir` trace.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
from typing import Any, Optional, Sequence, Type

from predictionio_torch.controller.base import (
    Algorithm,
    DataSource,
    Doer,
    FirstServing,
    IdentityPreparator,
    Preparator,
    Serving,
    run_sanity_check,
)
from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.params import Params, params_to_dict
from predictionio_torch.utils.profiling import annotate

log = logging.getLogger(__name__)


def resolve_component(class_map: dict, name: str, role: str) -> Type:
    """An empty name falls back to a single-entry map's only class; a
    non-empty name must match exactly."""
    if name in class_map:
        return class_map[name]
    if name == "" and len(class_map) == 1:
        return next(iter(class_map.values()))
    raise KeyError(f"Unknown {role} name {name!r} (have {sorted(class_map)})")


def _ckpt_suffixes(algos) -> list[str]:
    """The checkpoint-dir suffix of each (name, algorithm) entry: "" for
    the first user of a checkpoint tag, ".1", ".2", … for later ones.
    Subdirs are keyed by the tags a class declares
    (`Algorithm.checkpoint_tags`), so two entries of one class and two
    classes that declare one tag would otherwise purge each other's saves.
    A class without tags is keyed by itself."""
    counts: dict = {}
    out = []
    for _, algo in algos:
        keys = tuple(getattr(algo, "checkpoint_tags", ()) or ()) or (type(algo),)
        # an instance of a class with several tags reuses none of them:
        # its ordinal is the largest over its tags
        n = max(counts.get(k, 0) for k in keys)
        for k in keys:
            counts[k] = n + 1
        out.append(f".{n}" if n else "")
    return out


@dataclasses.dataclass
class EngineParams:
    """Per-component (name, params) selections."""

    data_source_name: str = ""
    data_source_params: Optional[Params] = None
    preparator_name: str = ""
    preparator_params: Optional[Params] = None
    algorithm_params_list: list[tuple[str, Optional[Params]]] = dataclasses.field(
        default_factory=lambda: [("", None)])
    serving_name: str = ""
    serving_params: Optional[Params] = None


class Engine:
    def __init__(
        self,
        data_source_class_map,
        preparator_class_map=None,
        algorithm_class_map=None,
        serving_class_map=None,
    ):
        if data_source_class_map is None or algorithm_class_map is None:
            raise ValueError("Engine requires data_source_class_map and "
                             "algorithm_class_map")

        def as_map(x, default_cls=None):
            if x is None:
                return {"": default_cls}
            return x if isinstance(x, dict) else {"": x}

        self.data_source_class_map: dict[str, Type[DataSource]] = as_map(
            data_source_class_map)
        self.preparator_class_map: dict[str, Type[Preparator]] = as_map(
            preparator_class_map, IdentityPreparator)
        self.algorithm_class_map: dict[str, Type[Algorithm]] = as_map(
            algorithm_class_map)
        self.serving_class_map: dict[str, Type[Serving]] = as_map(
            serving_class_map, FirstServing)

    def components(self, engine_params: EngineParams):
        ds = Doer.apply(
            resolve_component(self.data_source_class_map,
                              engine_params.data_source_name, "data source"),
            engine_params.data_source_params)
        prep = Doer.apply(
            resolve_component(self.preparator_class_map,
                              engine_params.preparator_name, "preparator"),
            engine_params.preparator_params)
        algos = [
            (name, Doer.apply(
                resolve_component(self.algorithm_class_map, name,
                                  "algorithm"), params))
            for name, params in engine_params.algorithm_params_list
        ]
        serving = Doer.apply(
            resolve_component(self.serving_class_map,
                              engine_params.serving_name, "serving"),
            engine_params.serving_params)
        check = getattr(serving, "check_against_algorithms", None)
        if check is not None:
            check([name for name, _ in algos])
        return ds, prep, algos, serving

    def train(self, ctx: WorkflowContext, engine_params: EngineParams,
              sanity_check: bool = False) -> list[Any]:
        """Read → prepare → train every algorithm; returns the models."""
        ds, prep, algos, _ = self.components(engine_params)
        log.info("Engine.train: reading training data (%s)", type(ds).__name__)
        with annotate("Engine.train read"):
            td = ds.read_training(ctx)
        if sanity_check:
            run_sanity_check(td, "training data")
        with annotate("Engine.train prepare"):
            pd = prep.prepare(ctx, td)
        if sanity_check:
            run_sanity_check(pd, "prepared data")
        models = []
        for (name, algo), suffix in zip(algos, _ckpt_suffixes(algos)):
            log.info("Engine.train: training algorithm %r (%s)", name,
                     type(algo).__name__)
            with ctx.algo_checkpoint_scope(suffix), annotate(
                    f"Engine.train {name}"):
                model = algo.train(ctx, pd)
            if sanity_check:
                run_sanity_check(model, f"model[{name}]")
            models.append(model)
        return models

    def eval(self, ctx: WorkflowContext, engine_params: EngineParams
             ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        """Per fold: train on the fold's training split, batch-predict its
        queries. Returns [(fold_td, [(query, predicted, actual), ...])]."""
        ds, prep, algos, serving = self.components(engine_params)
        folds = ds.read_eval(ctx)
        suffixes = _ckpt_suffixes(algos)
        results = []
        for i, (td, qa_pairs) in enumerate(folds):
            log.info("Engine.eval: fold %d/%d (%d queries)", i + 1,
                     len(folds), len(qa_pairs))
            pd = prep.prepare(ctx, td)
            models = []
            for (_, algo), suffix in zip(algos, suffixes):
                with ctx.algo_checkpoint_scope(suffix):
                    models.append(algo.train(ctx, pd))
            results.append((td, _serve_fold(algos, models, serving,
                                            qa_pairs)))
        return results

    def eval_grid(
        self, ctx: WorkflowContext, engine_params_list: Sequence[EngineParams],
    ) -> Optional[list[list[tuple[Any, list[tuple[Any, Any, Any]]]]]]:
        """Evaluate every EngineParams in one pass: the folds are read and
        prepared once, and each algorithm position trains all its cells
        through `train_grid` (falling back to one `train` per cell when it
        returns None). Returns per-ep fold results, the shape `eval`
        returns, or None when the grid varies more than algorithm params
        (data source, preparator, serving, or the algorithm names) and the
        caller must evaluate each ep on its own."""
        if len(engine_params_list) < 2:
            return None
        base = engine_params_list[0]

        def shared_key(ep: EngineParams):
            def d(p):
                return params_to_dict(p) if p else {}

            return (ep.data_source_name, d(ep.data_source_params),
                    ep.preparator_name, d(ep.preparator_params),
                    ep.serving_name, d(ep.serving_params),
                    [name for name, _ in ep.algorithm_params_list])

        if any(shared_key(ep) != shared_key(base)
               for ep in engine_params_list[1:]):
            log.info("Engine.eval_grid: grid varies beyond algorithm "
                     "params — sequential evaluation")
            return None
        ds, prep, _, serving = self.components(base)
        algos_by_ep = [self.components(ep)[2] for ep in engine_params_list]
        folds = ds.read_eval(ctx)
        n_ep = len(engine_params_list)
        # suffixes by position (duplicates across positions collide as in
        # train); a position's cells share its subdir, last writer wins
        pos_suffixes = _ckpt_suffixes(algos_by_ep[0])
        results: list[list] = [[] for _ in range(n_ep)]
        for fi, (td, qa_pairs) in enumerate(folds):
            log.info("Engine.eval_grid: fold %d/%d (%d queries, %d grid "
                     "points)", fi + 1, len(folds), len(qa_pairs), n_ep)
            pd = prep.prepare(ctx, td)
            # models[e][j]: the model of ep e at algorithm position j
            models: list[list[Any]] = [[] for _ in range(n_ep)]
            for j in range(len(base.algorithm_params_list)):
                instances = [algos_by_ep[e][j][1] for e in range(n_ep)]
                cls = type(instances[0])
                with ctx.algo_checkpoint_scope(pos_suffixes[j]):
                    grid_models = None
                    if all(type(a) is cls for a in instances):
                        grid_models = cls.train_grid(ctx, pd, instances)
                    if grid_models is None:
                        grid_models = [a.train(ctx, pd) for a in instances]
                for e in range(n_ep):
                    models[e].append(grid_models[e])
            for e in range(n_ep):
                results[e].append((td, _serve_fold(
                    algos_by_ep[e], models[e], serving, qa_pairs)))
        return results

    @staticmethod
    def serialize_models(models: Sequence[Any]) -> bytes:
        return pickle.dumps(list(models))

    @staticmethod
    def deserialize_models(blob: bytes) -> list[Any]:
        """Models of a blob this package wrote (pickle runs code: load
        only model files you trust)."""
        return pickle.loads(blob)

    def predict(self, engine_params: EngineParams, models: Sequence[Any],
                query: Any, components=None) -> Any:
        """Serve one query; the server resolves `components` once."""
        if components is None:
            components = self.components(engine_params)
        _, _, algos, serving = components
        predictions = [algo.predict(model, query)
                       for (_, algo), model in zip(algos, models)]
        return serving.serve(query, predictions)

    def predict_batch(self, engine_params: EngineParams,
                      models: Sequence[Any], queries: Sequence[Any],
                      components=None) -> list[Any]:
        """Serve many queries in one pass: each algorithm scores the whole
        batch through `batch_predict`, then Serving combines per query as
        `predict` does, so results line up with per-query `predict`."""
        if components is None:
            components = self.components(engine_params)
        _, _, algos, serving = components
        return [p for _, p, _ in _serve_fold(
            algos, models, serving, [(q, None) for q in queries])]

    def degraded_predict(self, engine_params: EngineParams,
                         models: Sequence[Any], query: Any,
                         components=None) -> Optional[Any]:
        """Serve one query through the first `degraded_capable` algorithm
        alone (bypassing Serving combination — the other algorithms did
        not run). Returns None when no algorithm volunteers; the serving
        plane then sheds normally."""
        if components is None:
            components = self.components(engine_params)
        _, _, algos, _ = components
        for (_, algo), model in zip(algos, models):
            if getattr(algo, "degraded_capable", False):
                return algo.predict(model, query)
        return None


def _serve_fold(algos, models, serving, qa_pairs) -> list[tuple]:
    """[(query, served prediction, actual)]: every algorithm's
    `batch_predict` over the queries, combined per query by `serving`."""
    queries = [q for q, _ in qa_pairs]
    per_algo = [algo.batch_predict(model, queries)
                for (_, algo), model in zip(algos, models)]
    return [(q, serving.serve(q, [preds[j] for preds in per_algo]), a)
            for j, (q, a) in enumerate(qa_pairs)]


class EngineFactory:
    """Subclass and implement `apply()` returning an Engine; engine.json
    names it by dotted path."""

    def apply(self) -> Engine:
        raise NotImplementedError
