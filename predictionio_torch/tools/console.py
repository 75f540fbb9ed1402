"""The port's console — `train`, `deploy`, `eval` and `batchpredict`, the
port of ``predictionio_tpu/tools/console.py``'s ``cmd_train``,
``cmd_deploy``, ``cmd_eval`` and ``cmd_batchpredict``.

    python -m predictionio_torch.tools.console train \\
        --engine-json E --events F --model-out M [--device cuda|cpu]
    python -m predictionio_torch.tools.console deploy \\
        --engine-json E --model M [--port 0] [--device cuda|cpu]
    python -m predictionio_torch.tools.console eval EVALUATION_CLASS \\
        [GENERATOR_CLASS] --events F [--out R] [--device cuda|cpu]
    python -m predictionio_torch.tools.console batchpredict \\
        --engine-json E --model M --input Q --output O [--device cuda|cpu]

`--events` is a JSON-lines events file (the `pio export` format); `eval
--out` writes the evaluation instance as JSON (the record the reference
keeps in storage). Without `--device` the commands run on CUDA (or
``$PIO_TORCH_DEVICE``).
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


def cmd_eval(args) -> int:
    from predictionio_torch.controller.context import WorkflowContext
    from predictionio_torch.workflow.core_workflow import CoreWorkflow
    from predictionio_torch.workflow.workflow_utils import resolve_symbol

    def instantiate(dotted: str):
        obj = resolve_symbol(dotted)
        return obj() if isinstance(obj, type) else obj

    try:
        evaluation = instantiate(args.evaluation_class)
        if args.generator_class:
            generator = instantiate(args.generator_class)
        elif hasattr(evaluation, "engine_params_list"):
            generator = evaluation  # an Evaluation doubling as generator
        else:
            raise ValueError("No engine params generator: pass "
                             "generator_class or give the Evaluation an "
                             "engine_params_list.")
        ctx = WorkflowContext(device=args.device, seed=args.seed,
                              events_path=args.events)
        instance, result = CoreWorkflow.run_evaluation(
            evaluation, generator, ctx,
            evaluation_class=args.evaluation_class,
            generator_class=args.generator_class or args.evaluation_class,
            out_path=args.out)
    except FileNotFoundError as e:
        print(f"Cannot read input: {e}", file=sys.stderr)
        return 1
    except (RuntimeError, ImportError, AttributeError, ValueError, TypeError,
            KeyError) as e:
        print(f"Evaluation failed: {e}", file=sys.stderr)
        return 1
    print(result.summary())
    print(f"Evaluation completed. Instance ID: {instance.id}")
    return 0


def cmd_batchpredict(args) -> int:
    from predictionio_torch.workflow.batch_predict import run_batch_predict

    try:
        n = run_batch_predict(args.input, args.output, args.engine_json,
                              args.model, device=args.device)
    except (RuntimeError, FileNotFoundError, ValueError, TypeError, KeyError,
            ImportError, AttributeError) as e:
        print(f"Batch predict failed: {e}", file=sys.stderr)
        return 1
    print(f"Batch predict completed: {n} queries → {args.output}")
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
    print(f"Engine instance {server.state.instance.id} deployed on "
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
        description="PyTorch/CUDA port of the pio train/deploy/eval "
                    "lifecycle")
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

    e = sub.add_parser("eval", help="evaluate a params grid on an events "
                                    "file")
    e.add_argument("evaluation_class")
    e.add_argument("generator_class", nargs="?", default=None)
    e.add_argument("--events", required=True,
                   help="JSON-lines events file (pio export format)")
    e.add_argument("--out", default=None,
                   help="write the evaluation instance here as JSON")
    e.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("batchpredict",
                       help="score a JSON-lines queries file")
    b.add_argument("--engine-json", default="engine.json")
    b.add_argument("--model", required=True)
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    b.set_defaults(fn=cmd_batchpredict)
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
