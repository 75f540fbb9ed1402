"""Template registry and scaffolding — the port of
``predictionio_tpu/templates/registry.py``.

The templates' DASE code ships inside the package, so getting a template
(`console template get NAME DIR`) scaffolds a user directory with its
`engine.json`, a `template.json` of metadata and a quickstart README;
`console build`, `train` and `deploy` then run against that directory.
Only the templates the port has are registered; each later one registers
when it lands.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import predictionio_torch

CONSOLE = "python -m predictionio_torch.tools.console"


@dataclasses.dataclass(frozen=True)
class TemplateInfo:
    name: str
    description: str
    engine_factory: str
    engine_json: dict  # default engine.json body (appName filled at get-time)
    sample_query: dict


BUILTIN_TEMPLATES: dict[str, TemplateInfo] = {
    t.name: t
    for t in [
        TemplateInfo(
            name="recommendation",
            description="Personalized item recommendation via ALS on one "
                        "GPU, blended with an item-popularity baseline",
            engine_factory=(
                "predictionio_torch.templates.recommendation."
                "RecommendationEngine"),
            engine_json={
                "datasource": {"params": {
                    "appName": "MyApp", "eventNames": ["rate", "buy"]}},
                # two algorithms blended by WeightedServing: popularity
                # backstops ALS for users the model has not seen
                "algorithms": [
                    {"name": "als", "params": {
                        "rank": 10, "numIterations": 10, "lambda": 0.01,
                        "seed": 3}},
                    {"name": "popular", "params": {
                        "weightByRating": False}},
                ],
                "serving": {"name": "weighted",
                            "params": {"weights": [0.8, 0.2]}},
            },
            sample_query={"user": "1", "num": 4},
        ),
        TemplateInfo(
            name="similarproduct",
            description="Items similar to those a user likes (item-item "
                        "cosine from implicit ALS factors)",
            engine_factory=(
                "predictionio_torch.templates.similarproduct."
                "SimilarProductEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 10, "numIterations": 10, "lambda": 0.01,
                    "seed": 3}}],
            },
            sample_query={"items": ["i1"], "num": 4},
        ),
        TemplateInfo(
            name="classification",
            description="Attribute classification (NaiveBayes / logistic "
                        "regression on $set entity properties)",
            engine_factory=(
                "predictionio_torch.templates.classification."
                "ClassificationEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}],
            },
            sample_query={"attr0": 2.0, "attr1": 0.0, "attr2": 0.0},
        ),
        TemplateInfo(
            name="ecommerce",
            description="E-commerce recommendation (implicit ALS + "
                        "serve-time business rules: seen/unavailable "
                        "filters, categories, cold start via recent views)",
            engine_factory=(
                "predictionio_torch.templates.ecommerce.ECommerceEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "ecomm", "params": {
                    "appName": "MyApp", "rank": 10, "numIterations": 20,
                    "lambda": 0.01, "seed": 3, "unseenOnly": True,
                    "seenEvents": ["buy", "view"],
                    "similarEvents": ["view"]}}],
            },
            sample_query={"user": "u1", "num": 4},
        ),
        TemplateInfo(
            name="textclassification",
            description="Text classification (tf-idf + NaiveBayes/LogReg, "
                        "Word2Vec variant)",
            engine_factory=("predictionio_torch.templates.textclassification."
                            "TextClassificationEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "nb", "params": {"lambda": 0.25}}],
            },
            sample_query={"text": "a great product"},
        ),
        TemplateInfo(
            name="productranking",
            description="Product Ranking (re-order a given item list for "
                        "a user via ALS)",
            engine_factory=("predictionio_torch.templates.productranking."
                            "ProductRankingEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 10, "numIterations": 20, "lambda": 0.01,
                    "seed": 3}}],
            },
            sample_query={"user": "u1", "items": ["i1", "i2", "i3"]},
        ),
        TemplateInfo(
            name="leadscoring",
            description="Lead Scoring (conversion probability from session "
                        "features via softmax regression)",
            engine_factory=("predictionio_torch.templates.leadscoring."
                            "LeadScoringEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "algorithms": [{"name": "leadscoring", "params": {
                    "iterations": 300, "stepSize": 0.1,
                    "regParam": 0.01}}],
            },
            sample_query={"landingPageId": "lp1", "referrerId": "r1",
                          "browser": "Chrome"},
        ),
        TemplateInfo(
            name="complementarypurchase",
            description="Complementary purchase (market-basket association "
                        "rules from buy events)",
            engine_factory=("predictionio_torch.templates."
                            "complementarypurchase."
                            "ComplementaryPurchaseEngine"),
            engine_json={
                "datasource": {"params": {"appName": "MyApp"}},
                "preparator": {"params": {"basketWindow": 3600}},
                "algorithms": [{"name": "association", "params": {
                    "minSupport": 0.001, "minConfidence": 0.05,
                    "minLift": 1.0, "numRulesPerCond": 10}}],
            },
            sample_query={"items": ["i1", "i3"], "num": 3},
        ),
        TemplateInfo(
            name="sessionrec",
            description="Session-based next-item recommendation (causal "
                        "self-attention over each user's recent-item "
                        "window)",
            engine_factory=(
                "predictionio_torch.templates.sessionrec.SessionRecEngine"),
            engine_json={
                "datasource": {"params": {
                    "appName": "MyApp", "eventNames": ["view", "buy"]}},
                "algorithms": [{"name": "attention", "params": {
                    "embedDim": 16, "numBlocks": 1, "numHeads": 2,
                    "maxSeqLen": 32, "epochs": 30, "stepSize": 0.05,
                    "seed": 3}}],
            },
            sample_query={"user": "u1", "num": 4},
        ),
    ]
}


def get_template(name: str) -> TemplateInfo:
    try:
        return BUILTIN_TEMPLATES[name]
    except KeyError:
        raise KeyError(
            f"Unknown template {name!r}; available: "
            f"{', '.join(sorted(BUILTIN_TEMPLATES))}") from None


def _fill_app_name(node, app_name: str) -> None:
    """Set every `appName` in the engine.json body (the datasource's and
    the serve-time algorithm params')."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "appName":
                node[k] = app_name
            else:
                _fill_app_name(v, app_name)
    elif isinstance(node, list):
        for v in node:
            _fill_app_name(v, app_name)


def scaffold(name: str, directory: str, app_name: Optional[str] = None,
             engine_id: Optional[str] = None) -> str:
    """Write engine.json, template.json and README.md into `directory`.

    Returns the directory. Refuses if any of those three files already
    exists there (other files in it are left alone and do not block).
    """
    info = get_template(name)
    directory = os.path.abspath(directory)
    clobber = [f for f in ("engine.json", "template.json", "README.md")
               if os.path.exists(os.path.join(directory, f))]
    if clobber:
        raise FileExistsError(
            f"{directory} already contains {', '.join(clobber)}; refusing "
            "to overwrite")
    os.makedirs(directory, exist_ok=True)

    engine = {
        "id": engine_id or name,
        "description": info.description,
        "engineFactory": info.engine_factory,
    }
    body = json.loads(json.dumps(info.engine_json))  # deep copy
    if app_name:
        _fill_app_name(body, app_name)
    engine.update(body)
    with open(os.path.join(directory, "engine.json"), "w") as f:
        json.dump(engine, f, indent=2)
        f.write("\n")

    # the reference's template.json shape: the least version it runs on
    with open(os.path.join(directory, "template.json"), "w") as f:
        json.dump({"pio": {"version": {"min": predictionio_torch.__version__}},
                   "name": info.name, "description": info.description}, f,
                  indent=2)
        f.write("\n")

    with open(os.path.join(directory, "README.md"), "w") as f:
        f.write(
            f"# {info.name} engine\n\n{info.description}\n\n"
            "## Quickstart\n\n"
            "Run from this directory; add `--device cpu` to `train` and\n"
            "`deploy` on a machine without a CUDA card.\n\n"
            "```sh\n"
            f"{CONSOLE} app new {app_name or 'MyApp'}\n"
            f"{CONSOLE} eventserver &   # ingest events on :7070\n"
            f"{CONSOLE} build\n"
            f"{CONSOLE} train\n"
            f"{CONSOLE} deploy &        # queries on :8000\n"
            "curl -s -X POST localhost:8000/queries.json "
            f"-d '{json.dumps(info.sample_query)}'\n"
            "```\n")
    return directory
