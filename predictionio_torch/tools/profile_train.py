"""Epoch times and device time by kernel of one ALS train on a CUDA card.

    PYTHONPATH=<checkout> python3 predictionio_torch/tools/profile_train.py \\
        --rank 128 [--scale 2m] [--iterations 3] [--repeats 2]

Trains `als_train` (solver gj, the `auto` layout) on
``synth_explicit(scale)`` `--repeats` times, keeping each run's epoch
times and kernel launches, then once more under `torch.profiler` for the
device time by kernel and the device's busy share. Prints one JSON object
that names the card and the package it measured. The package is imported
from ``sys.path``, so ``PYTHONPATH`` picks the checkout: two checkouts can
be measured in turns on one card. `profile_train` is also what
chip_smoke.py's train phase reports.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def device_time_by_kernel(prof) -> list:
    """The device's rows of a finished `torch.profiler` trace (kernels,
    copies, sets), each with its device ms and count, longest first."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops: their kernels are counted here
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append({"name": ev.key[:90], "device_ms": dev_us / 1e3,
                     "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def profile_train(data, device, rank: int, iterations: int = 3) -> dict:
    """Device time by kernel over one `als_train` call at `rank` (bucket
    upload + `iterations` epochs), and the device's busy share of it."""
    import torch

    from predictionio_torch.ops.als import ALSConfig, als_train

    cfg = ALSConfig(rank=rank, iterations=iterations, reg=0.01, seed=0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        als_train(data.train_u, data.train_i, data.train_r, data.n_users,
                  data.n_items, cfg, device=device)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r["device_ms"] for r in rows)
    return {"rank": rank, "wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms, "top": rows[:12],
            "solve": [r for r in rows if "gj_" in r["name"]]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank", type=int, default=128)
    parser.add_argument("--scale", default="2m")
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args(argv)
    import torch

    import predictionio_torch
    from predictionio_torch.ops import spd_solve
    from predictionio_torch.ops.als import ALSConfig, als_train
    from predictionio_torch.quality.datasets import synth_explicit

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device is available")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    data = synth_explicit(args.scale)
    cfg = ALSConfig(rank=args.rank, iterations=args.iterations, reg=0.01,
                    seed=0, solver="gj")
    runs = []
    for _ in range(args.repeats):
        spd_solve.reset_launches()
        t0 = time.perf_counter()
        res = als_train(data.train_u, data.train_i, data.train_r,
                        data.n_users, data.n_items, cfg, device=device)
        runs.append({"wall_s": time.perf_counter() - t0,
                     "epoch_ms": [t * 1e3 for t in res.epoch_times],
                     "launches": {k: v for k, v in spd_solve.launches.items()
                                  if v}})
    print(json.dumps({
        "package": predictionio_torch.__file__, "card": card,
        "scale": args.scale, "rank": args.rank,
        "iterations": args.iterations, "runs": runs,
        "profile": profile_train(data, device, args.rank, args.iterations),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
