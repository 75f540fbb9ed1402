#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`predictionio_torch`) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — nvcc builds every kernel under predictionio_torch/csrc;
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (max-rel < 1e-4, all-zero systems
             exactly 0), with its time, the plain version's, one library
             call's (Cholesky + cholesky_solve) and the card's bound;
3. train   — `als_train` on synth_explicit("2m") at rank 64 (aug kernel)
             and rank 128 (Schur recursion over the multi-RHS kernel); each
             RMSE trajectory within rtol 2e-3 of a solver="chol" run;
4. serve   — synth_explicit("100k") as a JSON-lines events file,
             `console train` on the card, `console deploy --port 0` in a
             subprocess, POST /queries.json answers equal the in-process
             model's and exclude seen items; one 1,024-user batch_predict
             through the device branch of recommend_topk agrees with the
             host branch wherever scores are not tied.

Launch counts are zeroed just before the main path (phases 3 and 4) and
read just after; every kernel must have launched there. `--report PATH`
also writes a JSON report with every number (the ptxas output, the
profile's kernel table). The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
REL_BAR = 1e-4
RMSE_RTOL = 2e-3
ITERATIONS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gj_operations(k: int, m: int) -> int:
    """FP32 operations of Gauss-Jordan on one [K | M] augmented system.
    Step p touches only the K + M - 1 - p columns right of the pivot: one
    division each in the pivot row, one multiply-add each in the K - 1
    other rows. Summed over the K steps: (2K - 1) · K(K + 2M - 1) / 2."""
    return (2 * k - 1) * k * (k + 2 * m - 1) // 2


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 1 -----------------------------------------------------------------

def phase_build(report: dict, card: str) -> None:
    from predictionio_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    _build.build(names)
    wall = time.perf_counter() - t0
    for name in names:
        seconds, ptxas = _build.build_log[name]
        print(ptxas.strip())
        emit({"phase": "build", "source": f"csrc/{name}.cu",
              "nvcc_s": seconds, "card": card})
    report["build"] = {"sources": names, "wall_s": wall}


# -- phase 2 -----------------------------------------------------------------

def _spd(gen, r, k, m, device):
    import torch

    y = torch.randn(r, k, k, generator=gen, device=device)
    a = y @ y.transpose(1, 2) + 0.5 * k * torch.eye(k, device=device)
    b = torch.randn(r, k, m, generator=gen, device=device)
    a[1] = 0.0  # an all-zero padding system must solve to exactly 0
    b[1] = 0.0
    return a, b


def _check_kernel(name, r, k, m, gen, device, reps):
    import torch

    from predictionio_torch.ops import spd_solve

    a, b = _spd(gen, r, k, m, device)
    if name == "gj_aug":
        kernel = lambda: spd_solve._solve_aug(a, b[..., 0])  # noqa: E731
        plain = lambda: spd_solve.gj_solve_plain(a, b[..., 0])  # noqa: E731
    else:
        kernel = lambda: spd_solve.gj_solve_multi(a, b)  # noqa: E731
        plain = lambda: spd_solve.gj_solve_multi_plain(a, b)  # noqa: E731
    x = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = (x - want).abs().max().item()
    rel = err / want.abs().max().item()
    zeros = bool((x[1] == 0).all().item())
    finite = bool(torch.isfinite(x).all().item())

    def library():
        chol, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(b, chol)

    row = {
        "name": name, "shape": [r, k, m],
        "shared_memory": spd_solve.shared_fits(k, m, device),
        "max_abs_err": err, "max_rel_err": rel, "zero_system_exact": zeros,
        "kernel_ms": time_ms(kernel, reps),
        "plain_ms": time_ms(plain, max(1, reps // 10), warmup=1),
        "library_ms": time_ms(library, reps),
    }
    row["bound_ms"], row["bound_by"] = bound_ms(
        4.0 * (r * k * k + 2 * r * k * m), float(gj_operations(k, m) * r))
    emit(dict(phase="kernels", **row))
    if not (rel < REL_BAR and zeros and finite):
        raise AssertionError(f"{name} at {[r, k, m]} disagrees with its "
                             f"plain version: {row}")
    return row


def phase_kernels(report: dict, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    rows = [
        _check_kernel("gj_aug", 13_850, 64, 1, gen, device, 20),
        _check_kernel("gj_aug", 943, 10, 1, gen, device, 50),
    ]
    rows += [_check_kernel("gj_aug_multi", 13_850, 32, m, gen, device, 20)
             for m in (1, 33, 65, 97)]
    deep = _check_kernel("gj_aug", 1_024, 255, 1, gen, device, 3)
    if deep["shared_memory"]:
        raise AssertionError("K = 255 should take the device-memory variant")
    rows.append(deep)
    report["kernels"] = rows
    # the main path's shape of each kernel: rank-64 users, and the largest
    # base call of the rank-128 Schur recursion
    return {"gj_aug": rows[0], "gj_aug_multi": rows[5]}


# -- phase 3 -----------------------------------------------------------------

def _train(data, rank, solver, device):
    from predictionio_torch.ops.als import ALSConfig, als_train

    cfg = ALSConfig(rank=rank, iterations=ITERATIONS, reg=0.01, seed=0,
                    solver=solver)
    t0 = time.perf_counter()
    res = als_train(data.train_u, data.train_i, data.train_r, data.n_users,
                    data.n_items, cfg, device=device, compute_rmse=True)
    wall = time.perf_counter() - t0
    if not res.rmse_history or not all(
            x == x and x < 10 for x in res.rmse_history):
        raise AssertionError(f"rank {rank} {solver}: bad RMSE "
                             f"{res.rmse_history}")
    return res, wall


def _profile_train(data, device) -> dict:
    """Device time by kernel over one rank-64 `als_train` call (bucket
    upload + ITERATIONS epochs), and the device's busy share of it."""
    import torch

    from predictionio_torch.ops.als import ALSConfig, als_train

    cfg = ALSConfig(rank=64, iterations=ITERATIONS, reg=0.01, seed=0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        als_train(data.train_u, data.train_i, data.train_r, data.n_users,
                  data.n_items, cfg, device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are counted below
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append({"name": ev.key[:90], "device_ms": dev_us / 1e3,
                     "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms, "top": rows[:12]}


def phase_train_reference(report: dict, data, device) -> dict:
    """The solver='chol' runs the kernels' trajectories are held to (no
    kernel launches), and a profile of one epoch."""
    from predictionio_torch.ops import spd_solve

    out = {}
    for rank in (64, 128):
        before = dict(spd_solve.launches)
        res, wall = _train(data, rank, "chol", device)
        if spd_solve.launches != before:
            raise AssertionError("solver='chol' launched a GJ kernel")
        out[rank] = res
        emit({"phase": "train", "rank": rank, "solver": "chol",
              "rmse": res.rmse_history, "epoch_s": res.epoch_times,
              "wall_s": wall})
    prof = _profile_train(data, device)
    report["profile_rank64"] = prof
    emit({"phase": "profile", "rank": 64,
          **{k: v for k, v in prof.items() if k != "top"},
          "top": prof["top"][:6]})
    return out


def phase_train(report: dict, data, device, chol: dict) -> dict:
    from predictionio_torch.ops import spd_solve

    per_rank = {}
    for rank in (64, 128):
        before = dict(spd_solve.launches)
        res, wall = _train(data, rank, "gj", device)
        launched = {k: spd_solve.launches[k] - before[k] for k in before}
        ref = chol[rank].rmse_history
        factor_diff = float(abs(res.item_factors
                                - chol[rank].item_factors).max())
        ok = all(abs(x - y) <= RMSE_RTOL * abs(y)
                 for x, y in zip(res.rmse_history, ref))
        row = {"rank": rank, "solver": "gj", "rmse": res.rmse_history,
               "rmse_chol": ref, "item_factor_max_abs_diff": factor_diff,
               "epoch_s": res.epoch_times,
               "wall_s": wall, "launches": launched,
               "launches_per_epoch": {k: v / ITERATIONS
                                      for k, v in launched.items()}}
        emit(dict(phase="train", **row))
        if not ok or len(res.rmse_history) != len(ref):
            raise AssertionError(f"rank {rank}: gj trajectory "
                                 f"{res.rmse_history} vs chol {ref}")
        per_rank[rank] = row
    if per_rank[64]["launches"]["gj_aug"] <= 0 or \
            per_rank[128]["launches"]["gj_aug_multi"] <= 0:
        raise AssertionError(f"kernels not on the train path: {per_rank}")
    report["train"] = per_rank
    return per_rank


# -- phase 4 -----------------------------------------------------------------

def _write_events(path, data) -> None:
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    with open(path, "w") as f:
        for n, (u, i, r) in enumerate(zip(data.train_u, data.train_i,
                                          data.train_r)):
            when = (t0 + timedelta(seconds=n)).isoformat()
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(r)},
                "eventTime": when.replace("+00:00", "Z"),
            }) + "\n")


def _read_deployed_line(proc, timeout_s: float) -> str:
    """The server's "deployed on ip:port" line; its output keeps being
    drained so the pipe never fills."""
    lines: "queue.Queue[str]" = queue.Queue()
    tail: list = []

    def pump():
        for line in proc.stdout:
            tail.append(line)
            del tail[:-40]
            lines.put(line)
        lines.put("")

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            continue
        if " deployed on " in line:
            return line
        if line == "":
            break
    raise AssertionError(f"deploy did not come up (exit {proc.poll()}):\n"
                         + "".join(tail))


def _post(url: str, query: dict) -> dict:
    req = urllib.request.Request(
        url + "/queries.json", data=json.dumps(query).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def phase_serve(report: dict, device, tmp: str) -> None:
    import numpy as np

    from predictionio_torch.ops import ranking
    from predictionio_torch.quality.datasets import synth_explicit
    from predictionio_torch.templates.recommendation.engine import ALSAlgorithm
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.core_workflow import read_model_file

    data = synth_explicit("100k")
    events = os.path.join(tmp, "events.jsonl")
    _write_events(events, data)
    with open(os.path.join(HERE, "predictionio_torch", "templates",
                           "recommendation", "engine.json")) as f:
        variant = json.load(f)
    # the ALS algorithm alone at rank 64, so each answer is the model's
    # recommend_products
    als_block = dict(variant["algorithms"][0])
    als_block["params"] = dict(als_block["params"], rank=64)
    variant["algorithms"] = [als_block]
    variant["serving"] = {"name": "first"}
    engine_json = os.path.join(tmp, "engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    model_path = os.path.join(tmp, "model.pio")

    t0 = time.perf_counter()
    rc = console.main(["train", "--engine-json", engine_json, "--events",
                       events, "--model-out", model_path,
                       "--device", str(device)])
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"console train exited {rc}")
    _instance, (model,) = read_model_file(model_path)
    model.device = str(device)

    seen: dict = {}
    for u, i in zip(data.train_u, data.train_i):
        seen.setdefault(f"u{u}", set()).add(f"i{i}")
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--engine-json", engine_json, "--model", model_path, "--ip",
         "127.0.0.1", "--port", "0", "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env)
    try:
        line = _read_deployed_line(proc, 300.0)
        url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
        queries = [{"user": f"u{u}", "num": n}
                   for u in (0, 1, 7, 42, 500, 942) for n in (5, 20)]
        queries.append({"user": "nobody", "num": 5})
        t_q = time.perf_counter()
        for q in queries:
            got = _post(url, q)
            want = {"itemScores": [
                {"item": i, "score": s}
                for i, s in model.recommend_products(q["user"], q["num"])]}
            if got != want:
                raise AssertionError(f"served {got} != in-process {want}")
            items = {s["item"] for s in got["itemScores"]}
            if items & seen.get(q["user"], set()):
                raise AssertionError(f"seen items served for {q}")
        query_ms = (time.perf_counter() - t_q) / len(queries) * 1e3
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    # one 1,024-user batch_predict through the device branch
    algo = ALSAlgorithm(None)
    users = [f"u{u % data.n_users}" for u in range(1_024)]
    bulk_q = [{"user": u, "num": 10} for u in users]
    t_b = time.perf_counter()
    bulk = algo.batch_predict(model, bulk_q)
    batch_ms = (time.perf_counter() - t_b) * 1e3
    ids = np.asarray([model.user_ids[u] for u in users], dtype=np.int32)
    exclude = {int(r): model.seen.get(int(r), np.empty(0, np.int32))
               for r in set(ids.tolist())}
    host_s, host_i = ranking.topk_host(model.user_factors,
                                       model.item_factors, ids, 10, exclude)
    inv = model.item_ids.inverse()
    compared = 0
    for row, got in enumerate(bulk):
        s = host_s[row]
        gaps = np.abs(np.diff(s))
        tied = np.zeros(len(s), bool)
        tied[:-1] |= gaps < 1e-5
        tied[1:] |= gaps < 1e-5
        got_items = [e["item"] for e in got["itemScores"]]
        for pos in np.nonzero(~tied)[0]:
            if got_items[pos] != inv[int(host_i[row][pos])]:
                raise AssertionError(f"device top-k differs from host for "
                                     f"{users[row]} at {pos}")
            compared += 1
    row = {"events": int(len(data.train_u)), "train_s": train_s,
           "queries": len(queries), "query_ms_mean": query_ms,
           "batch_users": len(users), "batch_predict_ms": batch_ms,
           "topk_positions_compared": compared}
    emit(dict(phase="serve", **row))
    report["serve"] = row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", default=None,
                        help="also write every number as JSON to this path")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from predictionio_torch.ops import spd_solve
        from predictionio_torch.quality.datasets import synth_explicit
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    t_all = time.perf_counter()

    phase_build(report, card)
    main_shapes = phase_kernels(report, device)
    data = synth_explicit("2m")
    chol = phase_train_reference(report, data, device)

    spd_solve.reset_launches()  # the main path starts here
    per_rank = phase_train(report, data, device, chol)
    with tempfile.TemporaryDirectory() as tmp:
        phase_serve(report, device, tmp)
    launches = dict(spd_solve.launches)  # ... and ends here
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    kernels = []
    for name, replaces in (
            ("gj_aug", "predictionio_tpu/ops/pallas_solve.py:249"),
            ("gj_aug_multi", "predictionio_tpu/ops/pallas_solve.py:296")):
        row = main_shapes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "predictionio_torch/csrc/gj_solve.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
            "launches_per_epoch_rank64": per_rank[64]["launches_per_epoch"][name],
            "launches_per_epoch_rank128": per_rank[128]["launches_per_epoch"][name],
        })
    report["kernels_line"] = kernels
    report["wall_s"] = time.perf_counter() - t_all
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)

    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
