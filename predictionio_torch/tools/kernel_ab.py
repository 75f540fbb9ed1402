"""A/B of the solve kernels of two checkouts on one card.

Each run imports `predictionio_torch` from the checkout at ``--root``,
builds its kernels there, runs the aug, packed and blocked2 kernels
through `gj_solve` and the Schur base's register kernel
(`gj_aug_multi_reg`) through `gj_solve_multi` on the same seeded inputs
at the main paths' shapes (every instantiation of gj_reg.cu's, gj_cta.cu's
one-RHS kernels and gj_multi_reg.cu's at one shape or more; for
gj_multi_reg.cu the rank-128 recursion's base calls), and writes per
kernel and shape the SHA-256 of x's bytes, the call's time (CUDA events)
and the ptxas registers of every kernel of those three sources:

    python3 predictionio_torch/tools/kernel_ab.py --root A --out a.json
    python3 predictionio_torch/tools/kernel_ab.py --root B --out b.json
    python3 predictionio_torch/tools/kernel_ab.py --compare a.json b.json

Run A B B A in one call to the card and compare all four: equal digests
say the two sources compute bitwise the same x; the times of each side
give its spread. `--compare` exits 1 when a digest differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys

# (kernel, layout, [(R, K) or (R, K, M), ...]): a layout of `gj_solve`,
# or "multi" for `gj_solve_multi` with M right-hand sides
CASES = (
    ("gj_aug_reg", "aug", ((13_850, 64), (943, 10), (1_886, 8),
                           (1_886, 16), (13_850, 32))),
    ("gj_packed_reg", "packed", ((13_850, 64), (943, 10), (1_886, 8),
                                 (1_886, 16), (13_850, 32))),
    ("gj_aug_cta", "aug", ((13_850, 80), (13_850, 96), (13_850, 128))),
    ("gj_packed_cta", "packed", ((13_850, 80), (13_850, 128))),
    ("gj_aug_split", "aug", ((13_850, 192), (1_024, 255))),
    ("gj_packed_split", "packed", ((13_850, 192), (1_024, 255))),
    ("gj_blocked2_reg", "blocked2", ((13_850, 64), (943, 10), (1_886, 8),
                                     (1_886, 16))),
    ("gj_blocked2_cta", "blocked2", ((13_850, 80), (13_850, 96),
                                     (13_850, 128))),
    ("gj_blocked2_split", "blocked2", ((13_850, 192), (1_024, 256))),
    # the rank-128 Schur base calls ([R, 32, M]) at the whole user side and
    # at the path's largest bucket
    ("gj_aug_multi_reg", "multi", tuple((r, 32, m) for r in (13_850, 2_744)
                                        for m in (1, 33, 65, 97))),
)
REPS = 20


def run(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from predictionio_torch.ops import _build, spd_solve

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is available")
    device = torch.device("cuda", 0)
    out: dict = {"root": os.path.abspath(root),
                 "card": torch.cuda.get_device_name(0), "cases": {},
                 "ptxas": {}}
    for name, layout, shapes in CASES:
        for shape in shapes:
            r, k, m = (*shape, 1)[:3]
            gen = torch.Generator(device=device).manual_seed(
                (r * 1_000 + k) * 1_000 + m)
            y = torch.randn(r, k, k, generator=gen, device=device)
            a = y @ y.transpose(1, 2) + 0.5 * k * torch.eye(k, device=device)
            b = torch.randn(r, k, m, generator=gen, device=device)
            a[1] = 0.0
            b[1] = 0.0
            if layout == "multi":
                def solve():
                    return spd_solve.gj_solve_multi(a, b)
            else:
                def solve():
                    return spd_solve.gj_solve(a, b[..., 0], layout=layout)
            spd_solve.reset_launches()
            x = solve()
            if spd_solve.launches[name] != 1:
                raise AssertionError(f"{layout} at {shape} did not launch "
                                     f"{name}: {spd_solve.launches}")
            for _ in range(2):
                solve()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                solve()
            end.record()
            torch.cuda.synchronize()
            digest = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            out["cases"][f"{name}/{'x'.join(map(str, shape))}"] = {
                "sha256": digest, "ms": start.elapsed_time(end) / REPS}
    for source in ("gj_reg", "gj_cta", "gj_multi_reg"):
        report = _build.build_log[source][1]
        # the kernel's name and template arguments, without the
        # translation unit's anonymous namespace
        out["ptxas"][source] = {
            re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", fn):
            props.get("registers")
            for fn, props in _build.ptxas_kernels(report).items()}
    return out


def compare(paths: list) -> int:
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    differ = 0
    for case in runs[0]["cases"]:
        digests = {run["cases"][case]["sha256"] for run in runs}
        differ += len(digests) > 1
        print(json.dumps({"case": case, "bitwise_equal": len(digests) == 1,
                          "ms": [run["cases"][case]["ms"] for run in runs],
                          "roots": [run["root"] for run in runs]}))
    print(json.dumps({"ptxas_registers": [run["ptxas"] for run in runs]}))
    print(json.dumps({"cases": len(runs[0]["cases"]), "differ": differ}))
    return 1 if differ else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", help="checkout whose kernels to run")
    parser.add_argument("--out", help="write the run's JSON here")
    parser.add_argument("--compare", nargs="+", metavar="JSON",
                        help="compare the runs written to these files")
    args = parser.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    if not args.root or not args.out:
        parser.error("--root and --out, or --compare")
    result = run(args.root)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
