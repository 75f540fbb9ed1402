"""The port's console — `status`, `app`, `accesskey`, `eventserver`,
`import`, `export`, `template`, `new`, `build`, `train`, `deploy`, `eval`,
`batchpredict` and `run`, the port of ``predictionio_tpu/tools/console.py``'s
``cmd_status``, ``cmd_app`` (new, list, channel-new), ``cmd_accesskey``,
``cmd_eventserver``, ``cmd_import``, ``cmd_export``, ``cmd_template``
(list, get), ``cmd_new``, ``cmd_build``, ``cmd_train``, ``cmd_deploy``,
``cmd_eval``, ``cmd_batchpredict`` and ``cmd_run``.

    python -m predictionio_torch.tools.console status
    python -m predictionio_torch.tools.console app new NAME
    python -m predictionio_torch.tools.console app channel-new NAME CHANNEL
    python -m predictionio_torch.tools.console accesskey new NAME \
        [--event E ...]
    python -m predictionio_torch.tools.console eventserver \
        [--ip 0.0.0.0] [--port 7070] [--stats]
    python -m predictionio_torch.tools.console import --appname A --input F
    python -m predictionio_torch.tools.console template list
    python -m predictionio_torch.tools.console template get NAME DIR \\
        [--app-name A]
    python -m predictionio_torch.tools.console new DIR [--template NAME] \\
        [--app-name A]
    python -m predictionio_torch.tools.console build [--engine-json E]
    python -m predictionio_torch.tools.console train --engine-json E \\
        [--events F] [--model-out M] [--device cuda|cpu] \\
        [--checkpoint-dir D [--checkpoint-every N]] [--profile-dir P] \\
        [--metrics-file F] [--debug-nans] [--check-asserts] \\
        [--skip-sanity-check] [--batch LABEL] [--verbose N]
    python -m predictionio_torch.tools.console deploy --engine-json E \\
        [--model M] [--port 0] [--device cuda|cpu]
    python -m predictionio_torch.tools.console eval EVALUATION_CLASS \\
        [GENERATOR_CLASS] [--events F] [--out R] [--device cuda|cpu]
    python -m predictionio_torch.tools.console batchpredict \\
        --engine-json E [--model M] --input Q --output O [--device cuda|cpu]
    python -m predictionio_torch.tools.console run MODULE[:CALLABLE] \\
        [ARGS ...]

As in the reference, the verbs work against the storage that
``PIO_STORAGE_*`` configures (by default ``pio.db`` and ``models/``
under ``$PIO_FS_BASEDIR``, ``~/.pio_tpu``): training reads the app that
engine.json's ``appName`` names and records an engine instance with its
model blob; deploy and batchpredict load the latest completed instance
of engine.json's engine id and variant; eval records an evaluation
instance. `--events` (a JSON-lines events file, the `pio export` format)
reads events from a file instead; `--model-out`/`--model` write and read
a model file instead of the model repository; `eval --out` also writes
the evaluation instance as JSON. Without `--device` the commands run on
CUDA (or ``$PIO_TORCH_DEVICE``). The event server does no device work
and takes no `--device`: it never initialises CUDA. `template get`
scaffolds an engine directory from the registry
(`templates/registry.py`), and `build` checks its engine.json: the
factory resolves and every component's params extract.
`train --checkpoint-dir D` saves each algorithm's trainer state under
D/<tag> (ALS: its factors every `--checkpoint-every` epochs, default 1),
and the same command run again resumes from the latest step of the same
data and config. `run` calls a module's `main(args)` or a named callable
in this process.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import predictionio_torch
from predictionio_torch.storage.registry import Storage


def cmd_status(args) -> int:
    """Storage connectivity health check (`pio status`) + which native
    fast paths this host can run."""
    results = Storage.get().verify_all_data_objects()
    for name, ok in results.items():
        print(f"  {name}: {'OK' if ok else 'FAILED'}")
    ok = all(results.values())
    print("Storage status: " + ("all OK" if ok else "FAILURES detected"))
    # native tier: informational, never a failure, never a compile —
    # every native path has a bit-identical Python fallback and the
    # status reads cached state only
    from predictionio_torch import native

    print("Native fast paths (scan/bucketize/import/export/aggregate): "
          + native.native_status())
    return 0 if ok else 1


def cmd_app(args) -> int:
    from predictionio_torch.storage.base import AccessKey, App, Channel

    storage = Storage.get()
    if args.app_command == "channel-new":
        app = storage.meta_apps().get_by_name(args.name)
        if app is None:
            print(f"App {args.name!r} does not exist.", file=sys.stderr)
            return 1
        cid = storage.meta_channels().insert(
            Channel(id=0, name=args.channel, app_id=app.id))
        if cid is None:
            print(f"Invalid or duplicate channel name {args.channel!r}.",
                  file=sys.stderr)
            return 1
        print(f"Created channel {args.channel} (id={cid}) for app "
              f"{args.name}.")
        return 0
    if args.app_command == "new":
        app_id = storage.meta_apps().insert(
            App(id=0, name=args.name, description=args.description or ""))
        if app_id is None:
            print(f"App {args.name!r} already exists.", file=sys.stderr)
            return 1
        key = AccessKey.generate(app_id)
        storage.meta_access_keys().insert(key)
        print("Created a new app:")
        print(f"      Name: {args.name}")
        print(f"        ID: {app_id}")
        print(f"Access Key: {key.key}")
        return 0
    keys = storage.meta_access_keys()
    for app in storage.meta_apps().get_all():
        app_keys = [k.key for k in keys.get_by_app_id(app.id)]
        print(f"  {app.id} {app.name} key={app_keys[0] if app_keys else '(none)'}")
    return 0


def cmd_accesskey(args) -> int:
    from predictionio_torch.storage.base import AccessKey

    storage = Storage.get()
    keys = storage.meta_access_keys()
    if args.ak_command == "delete":
        ok = keys.delete(args.key)
        print("Deleted." if ok else "No such key.")
        return 0 if ok else 1
    app = storage.meta_apps().get_by_name(args.app_name)
    if app is None:
        print(f"App {args.app_name!r} does not exist.", file=sys.stderr)
        return 1
    if args.ak_command == "new":
        key = AccessKey.generate(app.id, events=args.event or [])
        keys.insert(key)
        print(f"Created new access key: {key.key}")
        return 0
    for k in keys.get_by_app_id(app.id):
        print(f"  {k.key} events={k.events or 'all'}")
    return 0


def cmd_eventserver(args) -> int:
    from predictionio_torch.data.api import EventServer, EventServerConfig

    config = EventServerConfig(ip=args.ip, port=args.port, stats=args.stats)
    try:
        server = EventServer(config)
    except OSError as e:
        print(f"Cannot bind {args.ip}:{args.port}: {e.strerror or e}",
              file=sys.stderr)
        return 1
    print(f"Event Server (stats={'on' if args.stats else 'off'}) listening "
          f"on {args.ip}:{server.port}", flush=True)
    return _serve_until_signal(server)


def cmd_import(args) -> int:
    from predictionio_torch.tools.transfer import file_to_events

    try:
        imported, skipped = file_to_events(args.input, args.appname,
                                           args.channel)
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Import failed: {e}", file=sys.stderr)
        return 1
    print(f"Imported {imported} events"
          + (f" ({skipped} invalid lines skipped)" if skipped else "") + ".")
    return 0


def cmd_export(args) -> int:
    from predictionio_torch.tools.transfer import events_to_file

    try:
        n = events_to_file(args.output, args.appname, args.channel)
    except (ValueError, OSError) as e:
        print(f"Export failed: {e}", file=sys.stderr)
        return 1
    print(f"Exported {n} events to {args.output}.")
    return 0


def cmd_template(args) -> int:
    from predictionio_torch.templates.registry import (
        BUILTIN_TEMPLATES,
        CONSOLE,
        scaffold,
    )

    if args.template_command == "list":
        for name, info in sorted(BUILTIN_TEMPLATES.items()):
            print(f"  {name:20s} {info.description}")
        return 0
    try:
        directory = scaffold(args.name, args.directory,
                             app_name=args.app_name)
    except (KeyError, FileExistsError) as e:
        print(e.args[0] if e.args else str(e), file=sys.stderr)
        return 1
    print(f"Engine template {args.name!r} created at {directory}")
    print(f"Edit engine.json, then: {CONSOLE} build && {CONSOLE} train "
          f"&& {CONSOLE} deploy")
    return 0


def cmd_new(args) -> int:
    """`new DIR`: `template get` of `--template` (recommendation)."""
    args.template_command = "get"
    args.name = args.template
    return cmd_template(args)


def cmd_build(args) -> int:
    """There is nothing to compile: building checks that engine.json
    parses, its factory resolves and every component's params extract."""
    from predictionio_torch.workflow.workflow_utils import (
        extract_engine_params,
        get_engine,
        read_engine_json,
    )

    try:
        variant = read_engine_json(args.engine_json)
        engine = get_engine(variant.engine_factory)
        extract_engine_params(engine, variant)
    except Exception as e:  # noqa: BLE001 — every failure is the build's
        print(f"Engine build failed: {e}", file=sys.stderr)
        return 1
    print(f"Engine {variant.id!r} ({variant.engine_factory}) is ready for "
          "training.")
    return 0


def cmd_train(args) -> int:
    from predictionio_torch.workflow.create_workflow import run_train

    try:
        instance = run_train(
            engine_json=args.engine_json,
            engine_version=args.engine_version,
            batch=args.batch,
            seed=args.seed,
            device=args.device,
            skip_sanity_check=args.skip_sanity_check,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            profile_dir=args.profile_dir,
            metrics_file=args.metrics_file,
            debug_nans=args.debug_nans,
            check_asserts=args.check_asserts,
            events_path=args.events,
            model_out=args.model_out,
        )
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
    from predictionio_torch.workflow.create_workflow import run_evaluation

    try:
        instance, result = run_evaluation(
            evaluation_class=args.evaluation_class,
            generator_class=args.generator_class,
            batch=args.batch,
            seed=args.seed,
            device=args.device,
            events_path=args.events,
            out_path=args.out,
        )
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
                              args.model, device=args.device,
                              engine_version=args.engine_version)
    except (RuntimeError, FileNotFoundError, ValueError, TypeError, KeyError,
            ImportError, AttributeError) as e:
        print(f"Batch predict failed: {e}", file=sys.stderr)
        return 1
    print(f"Batch predict completed: {n} queries → {args.output}")
    return 0


def cmd_run(args) -> int:
    """`run MODULE[:CALLABLE] [ARGS ...]`: the callable with ARGS, or the
    module's `main(ARGS)`, in this process; an int it returns is the exit
    code."""
    import importlib

    module_name, _, attr = args.target.partition(":")
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        print(f"Cannot import {module_name!r}: {e}", file=sys.stderr)
        return 1
    if attr:
        fn = getattr(module, attr, None)
        if fn is None:
            print(f"{module_name} has no attribute {attr!r}",
                  file=sys.stderr)
            return 1
        result = fn(*args.args)
    elif hasattr(module, "main"):
        result = module.main(args.args)
    else:
        print(f"{module_name} has no main(); use {module_name}:<callable>",
              file=sys.stderr)
        return 1
    return result if isinstance(result, int) else 0


def cmd_deploy(args) -> int:
    from predictionio_torch.workflow.create_server import PredictionServer

    try:
        server = PredictionServer(args.engine_json, args.model, ip=args.ip,
                                  port=args.port, device=args.device,
                                  engine_version=args.engine_version)
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
        description="PyTorch/CUDA port of the pio event server and "
                    "train/deploy/eval lifecycle")
    p.add_argument("--version", action="version",
                   version=predictionio_torch.__version__)
    sub = p.add_subparsers(dest="command", required=True)

    st = sub.add_parser("status", help="check the storage and the native "
                                       "fast paths")
    st.set_defaults(fn=cmd_status)

    a = sub.add_parser("app", help="manage apps in the metadata store")
    a_sub = a.add_subparsers(dest="app_command", required=True)
    a_new = a_sub.add_parser("new", help="create an app and its access key")
    a_new.add_argument("name")
    a_new.add_argument("--description", default="")
    a_sub.add_parser("list", help="list the apps and their first key")
    a_ch = a_sub.add_parser("channel-new", help="create a channel of an app")
    a_ch.add_argument("name")
    a_ch.add_argument("channel")
    a.set_defaults(fn=cmd_app)

    k = sub.add_parser("accesskey", help="manage an app's access keys")
    k_sub = k.add_subparsers(dest="ak_command", required=True)
    k_new = k_sub.add_parser("new", help="create an access key")
    k_new.add_argument("app_name")
    k_new.add_argument("--event", action="append",
                       help="an event name the key may write (repeatable; "
                            "none: every event)")
    k_list = k_sub.add_parser("list", help="list an app's access keys")
    k_list.add_argument("app_name")
    k_del = k_sub.add_parser("delete", help="delete an access key")
    k_del.add_argument("key")
    k.set_defaults(fn=cmd_accesskey)

    s = sub.add_parser("eventserver", help="serve the REST event API")
    s.add_argument("--ip", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7070)
    s.add_argument("--stats", action="store_true",
                   help="count events by app, name and status at "
                        "GET /stats.json")
    s.set_defaults(fn=cmd_eventserver)

    i = sub.add_parser("import", help="import a JSON-lines events file "
                                      "into an app's event store")
    i.add_argument("--appname", required=True)
    i.add_argument("--input", required=True)
    i.add_argument("--channel", default=None)
    i.set_defaults(fn=cmd_import)

    x = sub.add_parser("export", help="export an app's events as JSON "
                                      "lines")
    x.add_argument("--appname", required=True)
    x.add_argument("--output", required=True)
    x.add_argument("--channel", default=None)
    x.set_defaults(fn=cmd_export)

    tpl = sub.add_parser("template", help="list or scaffold the built-in "
                                          "engine templates")
    tpl_sub = tpl.add_subparsers(dest="template_command", required=True)
    tpl_sub.add_parser("list", help="list the templates")
    tpl_get = tpl_sub.add_parser("get", help="scaffold a template's "
                                             "engine directory")
    tpl_get.add_argument("name")
    tpl_get.add_argument("directory")
    tpl_get.add_argument("--app-name", default=None)
    tpl.set_defaults(fn=cmd_template)

    n = sub.add_parser("new", help="scaffold an engine directory "
                                   "(template get)")
    n.add_argument("directory")
    n.add_argument("--template", default="recommendation")
    n.add_argument("--app-name", default=None)
    n.set_defaults(fn=cmd_new)

    bd = sub.add_parser("build", help="check an engine.json")
    bd.add_argument("--engine-json", default="engine.json")
    bd.set_defaults(fn=cmd_build)

    def add_device(sp):
        sp.add_argument("--device", default=None,
                        help="cuda (default), cuda:N or cpu")

    def add_run_args(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--batch", default="",
                        help="a label of the run, kept on its instance")
        sp.add_argument("--verbose", type=int, default=0,
                        help="2 or more logs at DEBUG")

    t = sub.add_parser("train", help="train an engine")
    t.add_argument("--engine-json", default="engine.json")
    t.add_argument("--engine-version", default="1")
    t.add_argument("--events", default=None,
                   help="read this JSON-lines events file (pio export "
                        "format) instead of the event store")
    t.add_argument("--model-out", default=None,
                   help="write the trained models to this model file "
                        "instead of the model repository")
    add_device(t)
    add_run_args(t)
    t.add_argument("--skip-sanity-check", action="store_true",
                   help="skip the sanity checks after each stage")
    t.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint each algorithm's trainer state under "
                        "this directory every --checkpoint-every of its "
                        "steps (ALS: epochs); running train again resumes "
                        "from the latest step")
    t.add_argument("--checkpoint-every", type=int, default=None,
                   help="default: each algorithm's own (ALS: every "
                        "epoch)")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the train "
                        "(trace.json) here")
    t.add_argument("--metrics-file", default=None,
                   help="append per-epoch metrics here as JSON lines")
    t.add_argument("--debug-nans", action="store_true",
                   help="assert the factors finite after each half-epoch "
                        "(as --check-asserts)")
    t.add_argument("--check-asserts", action="store_true",
                   help="assert mode: the factors checked finite after "
                        "each half-epoch")
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("deploy", help="serve a trained engine")
    d.add_argument("--engine-json", default="engine.json")
    d.add_argument("--engine-version", default="1")
    d.add_argument("--model", default=None,
                   help="serve this model file instead of the latest "
                        "completed instance in storage")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    add_device(d)
    d.set_defaults(fn=cmd_deploy)

    e = sub.add_parser("eval", help="evaluate a params grid")
    e.add_argument("evaluation_class")
    e.add_argument("generator_class", nargs="?", default=None)
    e.add_argument("--events", default=None,
                   help="read this JSON-lines events file (pio export "
                        "format) instead of the event store")
    e.add_argument("--out", default=None,
                   help="also write the evaluation instance here as JSON")
    add_device(e)
    add_run_args(e)
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("batchpredict",
                       help="score a JSON-lines queries file")
    b.add_argument("--engine-json", default="engine.json")
    b.add_argument("--engine-version", default="1")
    b.add_argument("--model", default=None,
                   help="score with this model file instead of the latest "
                        "completed instance in storage")
    b.add_argument("--input", required=True)
    b.add_argument("--output", required=True)
    add_device(b)
    b.set_defaults(fn=cmd_batchpredict)

    r = sub.add_parser("run", help="run a module's main() or a callable "
                                   "in this process")
    r.add_argument("target", help="module or module:callable to run")
    r.add_argument("args", nargs=argparse.REMAINDER,
                   help="arguments passed on to the target")
    r.set_defaults(fn=cmd_run)
    return p


def main(argv=None) -> int:
    import logging

    args = build_parser().parse_args(argv)
    # --verbose 2 or more logs at DEBUG, as the reference's console does
    logging.basicConfig(level=logging.DEBUG if getattr(args, "verbose", 0)
                        >= 2 else logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    opened_here = Storage._instance is None
    try:
        return args.fn(args)
    finally:
        # the process storage this command opened goes with it: a later
        # command in the same process (a script, a test) reads the
        # environment afresh
        if opened_here and Storage._instance is not None:
            Storage._instance.close()
            Storage.reset(None)


if __name__ == "__main__":
    sys.exit(main())
