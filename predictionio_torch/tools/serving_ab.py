"""One-client A/B of the deployed query path of checkouts on one card.

Writes one model file of the `2m` scale's shape (13 850 users × 2 700
items, rank 64, factors drawn from a seed, the scale's training ratings
as seen items) with the package of the first arm's checkout, then serves
it from every arm at once: a child process an arm builds that checkout's
`PredictionServer` over the model file on the card. One keep-alive
client (`http.client`, this process, a connection an arm) sends each arm
200 unrecorded warm-up queries, then the same 2 000 seeded
{"user", "num": 10} queries, each after the last answer, in blocks of
100 that visit every arm in turn (the order reversed every other block),
so a drift of the host's speed reaches every arm alike. Every arm sets
TCP_NODELAY on its handler: a checkout without it answers a keep-alive
client only after the client's delayed ACK, which is not the path under
test. An arm ``ROOT:off`` serves with PIO_SERVING_BATCHING=0 (a checkout
without the serving plane ignores it); every other PIO_SERVING_* and
PIO_HTTP_RESULT_CACHE* knob is unset.

    python3 predictionio_torch/tools/serving_ab.py \\
        --arms PARENT . .:off --out ab.json

Prints a JSON line an arm (qps over its blocks' wall, p50, p99 and mean
ms, and whether every answer equals the first arm's as JSON) and writes
them all to --out; exits 1 when an arm's answers differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from datetime import datetime, timezone

QUERIES, WARMUP, BLOCK, RANK, SEED = 2_000, 200, 100, 64, 13
KNOBS = ("PIO_SERVING_BATCHING", "PIO_SERVING_MAX_BATCH",
         "PIO_SERVING_MAX_WAIT_MS", "PIO_SERVING_MAX_QUEUE",
         "PIO_SERVING_DEFAULT_DEADLINE_MS", "PIO_SERVING_RETRY_AFTER_S",
         "PIO_HTTP_RESULT_CACHE", "PIO_HTTP_RESULT_CACHE_SIZE",
         "PIO_HTTP_RESULT_CACHE_TTL_S", "PIO_ONLINE")
# serves the model file argv[2] for engine.json argv[1] on device argv[3]
# and prints its port
_SERVER = (
    "import sys\n"
    "from predictionio_torch.workflow import create_server as cs\n"
    "cs._Handler.disable_nagle_algorithm = True\n"
    "server = cs.PredictionServer(sys.argv[1], sys.argv[2], ip='127.0.0.1',\n"
    "                             port=0, device=sys.argv[3])\n"
    "print('port', server.port, flush=True)\n"
    "server.serve_forever()\n")


def write_model(root: str, out_dir: str) -> tuple[str, str, list]:
    """engine.json, the model file and the queries, made with the
    package at `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from predictionio_torch import convert
    from predictionio_torch.quality.datasets import synth_explicit
    from predictionio_torch.storage.base import EngineInstance
    from predictionio_torch.workflow.core_workflow import write_model_file
    from predictionio_torch.workflow.workflow_utils import (
        engine_params_to_json,
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    data = synth_explicit("2m")
    with open(os.path.join(root, "predictionio_torch", "templates",
                           "recommendation", "engine.json")) as f:
        variant = json.load(f)
    als = dict(variant["algorithms"][0])
    als["params"] = dict(als["params"], rank=RANK)
    variant["algorithms"] = [als]
    variant["serving"] = {"name": "first"}
    engine_json = os.path.join(out_dir, "engine-serving-ab.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    rng = np.random.default_rng(SEED)
    model = convert.als_model_from_arrays(
        rng.standard_normal((data.n_users, RANK), np.float32) * 0.1,
        rng.standard_normal((data.n_items, RANK), np.float32) * 0.1,
        {f"u{u}": u for u in range(data.n_users)},
        {f"i{i}": i for i in range(data.n_items)},
        np.asarray(data.train_u), np.asarray(data.train_i))
    parsed = read_engine_json(engine_json)
    engine = get_engine(parsed.engine_factory)
    now = datetime.now(timezone.utc)
    instance = EngineInstance(
        id="serving-ab", status="COMPLETED", start_time=now, end_time=now,
        engine_id=parsed.id, engine_version="1",
        engine_variant=parsed.variant, engine_factory=parsed.engine_factory,
        **engine_params_to_json(extract_engine_params(engine, parsed)))
    model_path = os.path.join(out_dir, "serving-ab.pio")
    write_model_file(model_path, instance, [model])
    queries = [{"user": f"u{int(u)}", "num": 10}
               for u in rng.integers(0, data.n_users, WARMUP + QUERIES)]
    return engine_json, model_path, queries


def start_server(arm: str, engine_json: str, model_path: str,
                 device: str) -> tuple:
    """The arm's server child and its port."""
    root, off = _parse(arm)
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env["PYTHONPATH"] = os.path.abspath(root)
    if off:
        env["PIO_SERVING_BATCHING"] = "0"
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER, engine_json, model_path, device],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=os.path.abspath(root), env=env)
    line = proc.stdout.readline()
    if not line.startswith("port "):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"{arm}: the server did not start")
    return proc, int(line.split()[1])


def _parse(arm: str) -> tuple[str, bool]:
    return (arm[:-4], True) if arm.endswith(":off") else (arm, False)


def _send(conn, query, arm: str) -> tuple[float, object]:
    body = json.dumps(query)
    t0 = time.perf_counter()
    conn.request("POST", "/queries.json", body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        raise RuntimeError(f"{arm}: {resp.status} {raw[:200]!r}")
    return ms, json.loads(raw)


def run(arms: list, engine_json: str, model_path: str, queries: list,
        device: str) -> list:
    """All arms' servers up at once; after the warm-up, the timed queries
    go in blocks of BLOCK, each block to every arm in turn (the order
    reversed every other block), so a drift of the host's speed reaches
    every arm alike."""
    import http.client

    import numpy as np

    procs, conns = [], []
    try:
        for arm in arms:
            proc, port = start_server(arm, engine_json, model_path, device)
            procs.append(proc)
            conns.append(http.client.HTTPConnection("127.0.0.1", port,
                                                    timeout=60))
        for arm, conn in zip(arms, conns):
            for query in queries[:WARMUP]:
                _send(conn, query, arm)
        timed = queries[WARMUP:]
        ms = [[] for _ in arms]
        answers = [[] for _ in arms]
        wall = [0.0] * len(arms)
        for b, lo in enumerate(range(0, len(timed), BLOCK)):
            order = range(len(arms)) if b % 2 == 0 \
                else range(len(arms) - 1, -1, -1)
            for a in order:
                t0 = time.perf_counter()
                for query in timed[lo:lo + BLOCK]:
                    t, answer = _send(conns[a], query, arms[a])
                    ms[a].append(t)
                    answers[a].append(answer)
                wall[a] += time.perf_counter() - t0
    finally:
        for conn in conns:
            conn.close()
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=60)
    rows = []
    for a, arm in enumerate(arms):
        root, off = _parse(arm)
        rows.append({"arm": arm, "root": root, "batching": not off,
                     "queries": len(ms[a]), "qps": len(ms[a]) / wall[a],
                     "p50_ms": float(np.percentile(ms[a], 50)),
                     "p99_ms": float(np.percentile(ms[a], 99)),
                     "mean_ms": float(np.mean(ms[a])),
                     "answers_equal_first": answers[a] == answers[0]})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arms", nargs="+", required=True,
                        help="checkout roots; ROOT:off serves with "
                             "PIO_SERVING_BATCHING=0")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="the servers' device (default: the card)")
    args = parser.parse_args(argv)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    engine_json, model_path, queries = write_model(
        _parse(args.arms[0])[0], out_dir)
    rows = run(args.arms, engine_json, model_path, queries, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0 if all(r["answers_equal_first"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
