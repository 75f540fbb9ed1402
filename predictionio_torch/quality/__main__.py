"""`python -m predictionio_torch.quality`: quality parity at one scale —
the port's ALS (on the card, or the CPU with --cpu) and the MLlib-faithful
numpy ALS trained on the same synthetic split; prints one JSON line with
both sides' held-out RMSE (explicit) or MAP@k (implicit), their epoch
seconds and walls, and the port's device."""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_torch.quality",
        description="Quality parity: the port's ALS against the "
                    "MLlib-faithful CPU reference on one synthetic split")
    p.add_argument("--mode", choices=["explicit", "implicit"],
                   default="explicit")
    p.add_argument("--scale", choices=["100k", "2m", "20m"], default="100k")
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reg", type=float, default=0.1)
    p.add_argument("--alpha", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ref-iters", type=int, default=None,
                   help="cap the CPU reference's iterations (it is slow at "
                        "20m scale); metrics stay comparable once converged")
    p.add_argument("--map-max-users", type=int, default=20_000)
    p.add_argument("--cpu", action="store_true",
                   help="train the port's ALS on the CPU")
    args = p.parse_args(argv)

    from predictionio_torch.quality.parity import run_parity

    out = run_parity(mode=args.mode, scale=args.scale, rank=args.rank,
                     iterations=args.iters, reg=args.reg, alpha=args.alpha,
                     seed=args.seed, ref_iterations=args.ref_iters,
                     map_max_users=args.map_max_users,
                     device="cpu" if args.cpu else None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
