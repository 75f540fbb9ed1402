"""The port's console — `train` and `deploy`, the port of
``predictionio_tpu/tools/console.py::cmd_train`` / ``cmd_deploy``.

    python -m predictionio_torch.tools.console train \\
        --engine-json E --events F --model-out M [--device cuda|cpu]
    python -m predictionio_torch.tools.console deploy \\
        --engine-json E --model M [--port 0] [--device cuda|cpu]

`--events` is a JSON-lines events file (the `pio export` format).
Without `--device` the commands run on CUDA (or ``$PIO_TORCH_DEVICE``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import predictionio_torch


def cmd_train(args) -> int:
    from predictionio_torch.controller.context import WorkflowContext
    from predictionio_torch.workflow.core_workflow import CoreWorkflow
    from predictionio_torch.workflow.workflow_utils import (
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    try:
        variant = read_engine_json(args.engine_json)
        engine = get_engine(variant.engine_factory)
        engine_params = extract_engine_params(engine, variant)
        ctx = WorkflowContext(device=args.device, seed=args.seed,
                              events_path=args.events)
        instance = CoreWorkflow.run_train(engine, engine_params, variant,
                                          ctx, args.model_out)
    except FileNotFoundError as e:
        print(f"Cannot read input: {e}", file=sys.stderr)
        return 1
    except (RuntimeError, ImportError, AttributeError, ValueError, TypeError,
            KeyError) as e:
        print(f"Training failed: {e}", file=sys.stderr)
        return 1
    print(f"Training completed. Engine instance ID: {instance.id}")
    return 0


def cmd_deploy(args) -> int:
    from predictionio_torch.workflow.create_server import PredictionServer

    try:
        server = PredictionServer(args.engine_json, args.model, ip=args.ip,
                                  port=args.port, device=args.device)
    except FileNotFoundError as e:
        print(f"Deploy failed: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"Cannot bind {args.ip}:{args.port}: {e.strerror or e}",
              file=sys.stderr)
        return 1
    except (RuntimeError, ImportError, AttributeError, ValueError, TypeError,
            KeyError) as e:
        print(f"Deploy failed: {e}", file=sys.stderr)
        return 1
    print(f"Engine instance {server.instance.id} deployed on "
          f"{args.ip}:{server.port}", flush=True)
    return _serve_until_signal(server)


def _serve_until_signal(server) -> int:
    """Serve until SIGINT/SIGTERM, then stop accepting and close."""
    stop = threading.Event()

    def _terminate(signum, frame):
        stop.set()

    prev = {s: signal.signal(s, _terminate)
            for s in (signal.SIGTERM, signal.SIGINT)}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        stop.wait()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        for s, h in prev.items():
            signal.signal(s, h)
        sys.stdout.flush()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="predictionio_torch",
        description="PyTorch/CUDA port of the pio train/deploy lifecycle")
    p.add_argument("--version", action="version",
                   version=predictionio_torch.__version__)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train an engine from an events file")
    t.add_argument("--engine-json", default="engine.json")
    t.add_argument("--events", required=True,
                   help="JSON-lines events file (pio export format)")
    t.add_argument("--model-out", required=True,
                   help="where the trained model file is written")
    t.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("deploy", help="serve a trained model file")
    d.add_argument("--engine-json", default="engine.json")
    d.add_argument("--model", required=True)
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    d.set_defaults(fn=cmd_deploy)
    return p


def main(argv=None) -> int:
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
