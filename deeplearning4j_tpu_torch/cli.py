"""Command-line entry points.

The reference exposes exactly two ``main()``s (SURVEY.md §1): training via
``ParallelWrapperMain`` (`deeplearning4j-scaleout/.../parallelism/main/ParallelWrapperMain.java`,
JCommander flags: modelPath, workers, averagingFrequency, prefetchSize,
modelOutputPath, uiUrl) and serving via ``NearestNeighborsServer``
(`NearestNeighborsServer.java:3-10`). This module provides both:

- ``python -m deeplearning4j_tpu_torch.cli train ...`` — data-parallel training
  over a mesh; in the port it waits for ROADMAP §A 8c.
- ``python -m deeplearning4j_tpu_torch.cli nn-server ...`` — serve k-NN queries
  (delegates to :meth:`NearestNeighborsServer.main`).

The port's counterpart of the JAX package's ``cli.py``: every subcommand
takes ``--device`` (the card by default); ``train`` waits for ROADMAP
§A 8c, and ``profile`` reads torch.profiler (ROADMAP §C).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


TRAIN_WAITS = (
    "train: the command (--workers, --mesh, --elastic) comes with the "
    "elastic supervisor and the checkpointer (ROADMAP §A 8c); meanwhile "
    "train through parallel/trainer.py's ParallelWrapper over "
    "parallel/mesh.py's make_mesh, or with a network's fit()")


def parallel_wrapper_main(argv: Optional[List[str]] = None):
    """ParallelWrapperMain's flags (``--modelPath``, ``--workers``,
    ``--mesh``, ``--elastic``, ...) wait for the elastic supervisor and
    the checkpointer (ROADMAP §A 8c): the command exits with status 2 and
    says so, whatever its arguments."""
    print(TRAIN_WAITS, file=sys.stderr)
    raise SystemExit(2)


def cluster_setup_main(argv: Optional[List[str]] = None, runner=None):
    """``ClusterSetup`` parity (``aws/ec2/provision/ClusterSetup.java``
    JCommander flags → argparse): bring up N TPU VMs, wait until READY,
    provision each with the worker script. ``runner`` is injectable for
    tests/dry runs; ``--dry-run`` prints the gcloud commands instead."""
    ap = argparse.ArgumentParser("cloud-setup")
    ap.add_argument("-w", "--workers", type=int, default=1,
                    help="number of TPU VMs (ClusterSetup -w)")
    ap.add_argument("--project", required=True)
    ap.add_argument("--zone", required=True,
                    help="GCP zone (the -region flag's role)")
    ap.add_argument("--accelerator-type", default="v5p-8",
                    help="TPU slice type (the -s instance-size flag's role)")
    ap.add_argument("--version", default="tpu-ubuntu2204-base",
                    help="TPU VM image (the -ami flag's role)")
    ap.add_argument("--name-prefix", default="dl4j-tpu")
    ap.add_argument("--wscript", default=None,
                    help="worker setup script to upload and run on every VM")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the gcloud commands; execute nothing")
    ap.add_argument("--device", default=None,
                    help="taken by every subcommand; provisioning places "
                         "nothing on a device")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.cloud import ClusterProvisioner, TpuProvisioner

    if args.dry_run:
        import shlex
        runner = lambda cmd: (print(shlex.join(cmd)), "READY")[-1]
    prov = TpuProvisioner(args.project, args.zone, runner=runner)
    cluster = ClusterProvisioner(prov, num_workers=args.workers,
                                 accelerator_type=args.accelerator_type,
                                 version=args.version,
                                 name_prefix=args.name_prefix)
    cluster.create()
    cluster.block_till_all_running(poll_seconds=0.0 if args.dry_run else 10.0)
    if args.wscript:
        cluster.provision_workers(args.wscript)
    return cluster


# profile buckets: (bucket, substrings of a kernel or op name), first match
# wins; on the CPU the names are aten ops (a kernel's plain version)
PROFILE_GROUPS = (
    ("K3a flash_attention_fwd", ("flash_attention_fwd_kernel",)),
    ("K3b flash_attention_bwd_dq", ("flash_attention_bwd_dq_kernel",)),
    ("K3b flash_attention_bwd_dkv", ("flash_attention_bwd_dkv_kernel",)),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("K1 lstm_sequence", ("lstm_sequence_kernel", "lstm_sequence_cluster_kernel")),
    ("convolutions and pooling", ("conv", "fprop", "dgrad", "wgrad", "pool")),
    ("random draws", ("distribution", "philox", "bernoulli")),
    ("matrix products", ("gemm", "cutlass", "xmma", "sm90_", "ampere_",
                         "aten::mm", "aten::addmm", "aten::bmm")),
    ("softmax", ("softmax",)),
    ("gathers and scatters", ("index", "scatter", "gather", "embedding")),
    ("reductions", ("reduce", "aten::sum", "aten::mean")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_bucket(name: str) -> str:
    low = name.lower()
    for bucket, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return bucket
    return "other"


def profile_main(argv: Optional[List[str]] = None):
    """Profile a saved model's training step on its device: ``--steps``
    fit steps on the first ``--batchSize`` rows of ``--dataPath`` (after
    one untimed step) under ``torch.profiler``, each kernel's device time
    bucketed by kernel group (the hand-written kernels K1, K2, K3a, K3b,
    then the library's products, convolutions, ...). The report has the
    reference's keys: ``device_ms_per_step`` and ``buckets`` with
    ``share_pct``, ``ms_per_step`` and ``tflops`` (null: no FLOP count is
    known per kernel). On the CPU the buckets are the ops' CPU time. The
    trace is written under ``--logDir``."""
    import json as _json
    import os as _os

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser("profile")
    ap.add_argument("--modelPath", required=True,
                    help="model zip written by ModelSerializer")
    ap.add_argument("--dataPath", required=True,
                    help=".npz with 'features' and 'labels' arrays")
    ap.add_argument("--batchSize", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4,
                    help="profiled fit steps (after one untimed step)")
    ap.add_argument("--logDir", default=None,
                    help="write the Chrome trace of the profiled steps here")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    ap.add_argument("--device", default=None,
                    help="device to restore the model on (default: the "
                         "card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error(f"--steps must be >= 1, got {args.steps}")

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.util import model_serializer

    net = model_serializer.restore_model(args.modelPath, device=args.device)
    z = np.load(args.dataPath)
    ds = DataSet(z["features"][:args.batchSize],
                 z["labels"][:args.batchSize])
    on_card = net.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(net.device)

    net.fit(ds)  # untimed: kernel builds and first-call costs
    sync()
    activities = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            net.fit(ds)
        sync()
    if args.logDir:
        _os.makedirs(args.logDir, exist_ok=True)
        prof.export_chrome_trace(_os.path.join(args.logDir, "profile_trace.json"))
    times = {}
    for e in prof.key_averages():
        if on_card:
            if "cuda" not in str(getattr(e, "device_type", "")).lower():
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
        else:
            us = e.self_cpu_time_total
        if us > 0:
            times[e.key] = times.get(e.key, 0.0) + us / 1e6
    total = sum(times.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no time")
    buckets = {}
    for nm, t in times.items():
        bucket = profile_bucket(nm)
        buckets[bucket] = buckets.get(bucket, 0.0) + t
    report = {
        "device_ms_per_step": round(total / args.steps * 1e3, 3),
        "buckets": {k: {"share_pct": round(t / total * 100, 1),
                        "ms_per_step": round(t / args.steps * 1e3, 3),
                        "tflops": None}
                    for k, t in sorted(buckets.items(), key=lambda kv: -kv[1])},
    }
    print(_json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            _json.dump(report, fh, indent=1)
    return report


def evaluate_main(argv: Optional[List[str]] = None):
    """``evaluate`` subcommand: load any supported model artifact
    (ModelGuesser chain) and print classification metrics over a CSV
    dataset — the ``MultiLayerNetwork.evaluate`` flow from the shell."""
    p = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch evaluate")
    p.add_argument("--model", required=True,
                   help="model artifact (own/DL4J zip or Keras h5)")
    p.add_argument("--csv", required=True, help="delimited dataset file")
    p.add_argument("--label-index", type=int, default=-1,
                   help="label column (default: last column)")
    p.add_argument("--classes", type=int, required=True,
                   help="number of classes")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--delimiter", default=",")
    p.add_argument("--skip-lines", type=int, default=0)
    p.add_argument("--top-n", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="device to load the model on (default: the card; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess

    model = load_model_guess(args.model, device=args.device)
    reader = CSVRecordReader(args.csv, skip_lines=args.skip_lines,
                             delimiter=args.delimiter)
    label_index = args.label_index
    if label_index < 0:
        first = reader.next_record()
        reader.reset()
        label_index = len(first) - 1  # a Record is a list of values
    it = RecordReaderDataSetIterator(reader, args.batch,
                                     label_index=label_index,
                                     num_possible_labels=args.classes)
    e = model.evaluate(it, top_n=args.top_n)
    print(e.stats())
    return e


def serve_main(argv: Optional[List[str]] = None, block: bool = True):
    """``serve`` subcommand: stand up the production serving tier from the
    shell — register one or more model artifacts (ModelGuesser chain:
    own/DL4J zips, Keras h5) under names and serve them over HTTP with
    admission control and ``/metrics``. With ``--mesh`` every rank of the
    ``torch.distributed`` world runs the command (the world is opened by
    the launcher, e.g. ``parallel.master.init_distributed``; with none,
    ``make_mesh`` opens a world of one rank): rank 0 returns the server,
    a follower rank follows rank 0's forwards (``block=False`` returns
    its registry, whose ``follow()`` the caller runs)."""
    p = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch serve")
    p.add_argument("--model", action="append", required=True,
                   metavar="NAME=PATH",
                   help="model to register (repeatable); NAME=PATH, or a "
                        "bare PATH served under its file stem")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500,
                   help="listen port (0 → ephemeral)")
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--wait-ms", type=float, default=2.0,
                   help="batching window measured from the oldest request")
    p.add_argument("--mesh", default=None, metavar="AXES",
                   help="serve every --model sharded over this 2-D mesh "
                        "of the torch.distributed world's ranks, e.g. "
                        "data=4,model=2 (-1 infers one axis): params placed "
                        "by --sharding-rules, request batches sharded over "
                        "data, buckets rounded to the data-axis size. Every "
                        "rank runs the command; rank 0 serves HTTP and the "
                        "others follow its forwards in lockstep")
    p.add_argument("--sharding-rules", default=None, dest="sharding_rules",
                   metavar="RULES.json",
                   help="partition rule file for --mesh (default: the "
                        "built-in Megatron 2-D rule set); lint with "
                        "tools/validate_sharding_rules.py")
    p.add_argument("--buckets", default=None, metavar="N,N,...",
                   help="declared batch buckets (default: powers of two up "
                        "to --max-batch-size); these are pre-compiled at "
                        "registration and the dispatcher pads to them")
    p.add_argument("--warmup", choices=("sync", "async", "off"),
                   default="sync",
                   help="AOT bucket warmup at registration: sync blocks "
                        "until every bucket is compiled, async warms in "
                        "the background (/readyz lists cold buckets), off "
                        "restores lazy first-request compilation")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="persistent XLA compilation cache: restarts and "
                        "rollbacks re-warm from disk instead of compiling")
    p.add_argument("--dtype-policy", action="append", default=[],
                   metavar="NAME=POLICY",
                   help="serve NAME quantized: POLICY is int8, bf16 or "
                        "float32 (repeatable)")
    p.add_argument("--input-shape", action="append", default=[],
                   metavar="NAME=DIMS",
                   help="per-row input shape for warmup when the model "
                        "conf does not declare one, e.g. lenet=28x28x1 "
                        "(repeatable)")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="admission limit before requests shed as 429")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline (504 past expiry)")
    p.add_argument("--max-dispatcher-restarts", type=int, default=2,
                   help="in-place restarts of a crashed batching "
                        "dispatcher before the crash is terminal "
                        "(exponential backoff between restarts; 0 "
                        "restores the old die-forever behavior)")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="forward crashes within --breaker-window that "
                        "quarantine a model version (per-version circuit "
                        "breaker; 0 disables breakers)")
    p.add_argument("--breaker-window", type=float, default=30.0,
                   help="rolling window (seconds) the crash threshold "
                        "counts over")
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   help="seconds an open breaker waits before letting a "
                        "half-open probe through")
    p.add_argument("--breaker-probes", type=int, default=1,
                   help="consecutive probe successes that close a "
                        "half-open breaker")
    p.add_argument("--fallback", action="append", default=[],
                   metavar="NAME=VERSION",
                   help="failover chain for NAME while its live version "
                        "is quarantined/crashed: a version number, "
                        "'previous', or a comma list (repeatable)")
    p.add_argument("--brownout", action="store_true",
                   help="enable brownout degradation: under sustained "
                        "admission saturation, shed X-Priority<=0 "
                        "traffic with 429 and route un-pinned predicts "
                        "to the --fallback chain until pressure clears")
    p.add_argument("--brownout-saturation", type=float, default=0.9,
                   help="fraction of --max-inflight that counts as "
                        "saturation pressure")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="trace requests (spans across HTTP, dispatcher and "
                        "device) and write a Chrome trace here on shutdown")
    p.add_argument("--log-json", default=None, metavar="OUT.jsonl",
                   dest="log_json",
                   help="structured JSON-lines logging with trace "
                        "correlation to this file ('-' for stderr)")
    p.add_argument("--alerts", default=None, metavar="RULES.json",
                   help="alert rules evaluated against /metrics in the "
                        "background; state served at /alerts")
    p.add_argument("--alert-interval", type=float, default=15.0,
                   help="seconds between alert evaluation rounds")
    p.add_argument("--slo", default=None, metavar="SLO.json",
                   help="load SLO definitions (observe/slo.py schema): "
                        "their burn-rate rules join --alerts evaluation "
                        "and compliance is served at /slo")
    p.add_argument("--device", default=None,
                   help="device to serve the models on (default: the card; "
                        "'cpu' serves on the CPU)")
    args = p.parse_args(argv)

    import os

    from deeplearning4j_tpu_torch.serving import (DTYPE_POLICIES,
                                            ModelRegistry, ModelServer,
                                            default_registry)

    tracer = None
    if args.trace:
        from deeplearning4j_tpu_torch.observe import enable_tracing
        tracer = enable_tracing(metrics=default_registry())
    if args.log_json:
        from deeplearning4j_tpu_torch.observe import enable_structured_logging
        if args.log_json == "-":
            enable_structured_logging(stream=sys.stderr)
        else:
            enable_structured_logging(path=args.log_json)
    slo_set = None
    if args.slo:
        from deeplearning4j_tpu_torch.observe import load_slos
        try:
            slo_set = load_slos(args.slo)
        except (ValueError, OSError) as e:
            p.error(f"--slo: {e}")
        print(f"serving {len(slo_set.slos)} SLO(s) from {args.slo} "
              "(compliance at /slo)")
    alert_mgr = None
    if args.alerts or slo_set is not None:
        from deeplearning4j_tpu_torch.observe import (AlertManager, LogSink,
                                                load_rules)
        rules = list(load_rules(args.alerts)) if args.alerts else []
        if slo_set is not None:
            rules += slo_set.rules()
        alert_mgr = AlertManager(default_registry(),
                                 rules, [LogSink()],
                                 interval_s=args.alert_interval).start()
        print(f"alerting on {len(alert_mgr.rules)} rule(s) from "
              f"{args.alerts or args.slo} (state at /alerts)")

    serve_mesh = None
    serve_rules = None
    if args.sharding_rules and not args.mesh:
        p.error("--sharding-rules needs --mesh (the rules place params "
                "over the mesh's model axes)")
    if args.mesh:
        if args.dtype_policy:
            p.error("--dtype-policy cannot combine with --mesh (sharded "
                    "serving is float32-only)")
        from deeplearning4j_tpu_torch.parallel.mesh import (make_mesh,
                                                            parse_mesh_axes)
        try:
            axes = parse_mesh_axes(args.mesh)
        except ValueError as e:
            p.error(f"--mesh: {e}")
        if args.sharding_rules:
            from deeplearning4j_tpu_torch.parallel.sharding import (
                load_sharding_rules)
            try:
                serve_rules = load_sharding_rules(args.sharding_rules)
            except (OSError, ValueError) as e:
                p.error(f"--sharding-rules: {e}")
        import torch
        try:
            serve_mesh = make_mesh(axes, device_type=None if args.device is None
                                   else torch.device(args.device).type)
        except (ValueError, RuntimeError) as e:
            p.error(f"--mesh: {e}")

    buckets = None
    if args.buckets:
        try:
            buckets = [int(b) for b in args.buckets.split(",") if b.strip()]
        except ValueError:
            p.error(f"--buckets needs comma-separated batch sizes, "
                    f"got {args.buckets!r}")
        if not buckets or min(buckets) < 1:
            p.error(f"--buckets needs positive batch sizes, "
                    f"got {args.buckets!r}")
    policies = {}
    for spec in args.dtype_policy:
        name, sep, policy = spec.partition("=")
        if not sep:
            p.error(f"--dtype-policy needs NAME=POLICY, got {spec!r}")
        if policy not in DTYPE_POLICIES:
            p.error(f"--dtype-policy {name}={policy!r}: unknown policy "
                    f"(one of {', '.join(DTYPE_POLICIES)})")
        policies[name] = policy
    shapes = {}
    for spec in args.input_shape:
        name, sep, dims = spec.partition("=")
        if not sep:
            p.error(f"--input-shape needs NAME=DIMS, got {spec!r}")
        try:
            shapes[name] = tuple(int(d) for d in dims.lower().split("x"))
        except ValueError:
            p.error(f"--input-shape needs DIMS like 28x28x1, got {dims!r}")
        if not shapes[name] or min(shapes[name]) < 1:
            p.error(f"--input-shape needs positive DIMS, got {dims!r}")
    fallbacks = {}
    for spec in args.fallback:
        name, sep, chain = spec.partition("=")
        if not sep or not chain:
            p.error(f"--fallback needs NAME=VERSION, got {spec!r}")
        parsed_chain = []
        for entry in chain.split(","):
            entry = entry.strip()
            if entry == "previous":
                parsed_chain.append("previous")
                continue
            try:
                parsed_chain.append(int(entry))
            except ValueError:
                p.error(f"--fallback {spec!r}: entries are version "
                        f"numbers or 'previous', got {entry!r}")
        fallbacks[name] = parsed_chain
    if args.max_dispatcher_restarts < 0:
        p.error("--max-dispatcher-restarts must be >= 0")
    if args.breaker_threshold < 0:
        p.error("--breaker-threshold must be >= 0 (0 disables)")
    breaker = None
    if args.breaker_threshold > 0:
        breaker = dict(failure_threshold=args.breaker_threshold,
                       window_s=args.breaker_window,
                       cooldown_s=args.breaker_cooldown,
                       half_open_probes=args.breaker_probes)
    registry = ModelRegistry(metrics=default_registry(),
                             device=args.device,
                             max_batch_size=args.max_batch_size,
                             wait_ms=args.wait_ms, buckets=buckets,
                             warmup=args.warmup,
                             compile_cache_dir=args.compile_cache_dir,
                             max_dispatcher_restarts=(
                                 args.max_dispatcher_restarts),
                             breaker=breaker)
    models = []
    for spec in args.model:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        models.append((name, path))
    model_names = [n for n, _ in models]
    # a typo'd NAME in a per-model flag must not silently serve the model
    # unquantized / unwarmed
    for flag, mapping in (("--dtype-policy", policies),
                          ("--input-shape", shapes),
                          ("--fallback", fallbacks)):
        unknown = sorted(set(mapping) - set(model_names))
        if unknown:
            p.error(f"{flag} names no registered --model: "
                    f"{', '.join(unknown)} (models: "
                    f"{', '.join(model_names)})")
    for name, path in models:
        version = registry.register(
            name, path=path, dtype_policy=policies.get(name, "float32"),
            input_shape=shapes.get(name),
            mesh=serve_mesh, sharding_rules=serve_rules)
        state = registry.warmup_state(name, version)
        mesh_tag = "" if serve_mesh is None else f" [mesh {args.mesh}]"
        extra = ""
        if state["status"] == "warm":
            extra = (f" (warmed {len(state['warm'])} bucket(s) in "
                     f"{state['seconds']:.2f}s)")
        elif state["status"] in ("pending", "warming"):
            extra = " (warming in background)"
        elif state["status"] == "skipped":
            extra = f" (warmup skipped: {state['reason']})"
        elif state["status"] == "error":
            extra = f" (warmup FAILED: {state['reason']})"
        print(f"registered {name!r} v{version} from {path}{mesh_tag}{extra}")
    for name, chain in fallbacks.items():
        try:
            registry.set_fallback(name, chain)
        except (KeyError, ValueError) as e:
            p.error(f"--fallback {name}: {e}")
        print(f"fallback chain for {name!r}: {chain}")
    if serve_mesh is not None:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            # a follower rank: no HTTP; it runs rank 0's forwards until
            # rank 0 stops (block=False hands the registry to the caller,
            # who calls follow())
            print(f"rank {dist.get_rank()} follows rank 0's forwards on the "
                  f"mesh {args.mesh}")
            if block:
                try:
                    registry.follow()
                finally:
                    registry.shutdown()
            return registry
    brownout = None
    if args.brownout:
        brownout = dict(saturation=args.brownout_saturation)
    server = ModelServer(
        registry, host=args.host, port=args.port, metrics=default_registry(),
        max_inflight=args.max_inflight,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms is not None else None),
        alerts=alert_mgr, brownout=brownout, slo=slo_set)
    port = server.start()
    print(f"model server listening on {server.url} "
          f"(models: {', '.join(registry.names())}); port {port}")
    if tracer is not None:
        # the trace flushes when the server stops, however it is stopped —
        # the blocking KeyboardInterrupt path AND block=False callers
        server.tracer = tracer
        orig_stop = server.stop

        def _stop_and_flush(*a, **kw):
            from deeplearning4j_tpu_torch.observe import disable_tracing
            try:
                return orig_stop(*a, **kw)
            finally:
                n = tracer.flush(args.trace)
                print(f"wrote Chrome trace ({n} spans) to {args.trace}")
                disable_tracing()

        server.stop = _stop_and_flush
    if block:
        try:
            server._thread.join()
        except KeyboardInterrupt:
            server.stop(drain=True, shutdown_registry=True)
    return server


def pipeline_main(argv: Optional[List[str]] = None):
    """``pipeline`` subcommand: the continuous-training loop
    (``deeplearning4j_tpu_torch/pipeline/``) as a self-contained product —
    register the saved model as the serving baseline, stream the dataset
    through mini-epoch retraining, gate the candidate on a held-out
    split, canary it at ramped traffic fractions (self-driven synthetic
    traffic from the eval split; a production deployment attaches a
    ModelServer and real traffic), and auto-promote or roll back.  The
    journal under ``--state-dir`` makes the run crash-safe: re-running
    the same command after a kill resumes at the crashed stage
    (``DL4J_TPU_FAULT_PLAN`` with worker ``"pipeline"`` injects such
    kills deterministically).  SIGTERM drains cleanly: the open run is
    decided as a journaled rollback instead of dying mid-stage."""
    import signal

    p = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch pipeline")
    p.add_argument("--modelPath", required=True,
                   help="serving baseline (model zip / DL4J / Keras h5)")
    p.add_argument("--dataPath", required=True,
                   help=".npz with 'features' and 'labels': the stream "
                        "source and (split off) the held-out eval set")
    p.add_argument("--config", required=True, metavar="PIPELINE.json",
                   help="pipeline config (schema: pipeline.PipelineConfig; "
                        "lint with tools/validate_pipeline_config.py)")
    p.add_argument("--state-dir", required=True, dest="state_dir",
                   help="journal + candidate-checkpoint directory (the "
                        "crash-recovery substrate; reuse it to resume)")
    p.add_argument("--eval-fraction", type=float, default=0.2,
                   dest="eval_fraction",
                   help="tail fraction of the dataset held out for the "
                        "eval gate (never streamed)")
    p.add_argument("--cycles", type=int, default=None,
                   help="pipeline runs to execute (default: config)")
    p.add_argument("--modelOutputPath", default=None,
                   help="write the final serving model here on exit")
    p.add_argument("--log-json", default=None, metavar="OUT.jsonl",
                   dest="log_json",
                   help="structured JSON-lines logging with trace "
                        "correlation to this file ('-' for stderr)")
    p.add_argument("--alerts", default=None, metavar="RULES.json",
                   help="alert rules evaluated against the pipeline's "
                        "metrics registry; firing rules roll a canary "
                        "back (config canary.abort_on_alerts)")
    p.add_argument("--alert-interval", type=float, default=5.0,
                   help="seconds between alert evaluation rounds")
    p.add_argument("--device", default=None,
                   help="device to serve and train on (default: the card; "
                        "'cpu' runs on the CPU)")
    # in-process-only flags are rejected, not silently ignored — the
    # same contract train --elastic applies to its worker processes
    p.add_argument("--trace", default=None, help=argparse.SUPPRESS)
    p.add_argument("--watchdog", default=None, help=argparse.SUPPRESS)
    p.add_argument("--uiUrl", default=None, help=argparse.SUPPRESS)
    p.add_argument("--workers", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    unsupported = [flag for flag, hit in (
        ("--trace", args.trace is not None),
        ("--watchdog", args.watchdog is not None),
        ("--uiUrl", args.uiUrl is not None),
        ("--workers", args.workers is not None),
    ) if hit]
    if unsupported:
        p.error(f"{', '.join(unsupported)} affect(s) in-process training "
                "and is not a pipeline flag: the watchdog is configured "
                "in the pipeline config (train.watchdog) and tracing/UI "
                "belong to the train subcommand. --log-json and --alerts "
                "ARE supported (they observe the pipeline)")
    if not 0.0 < args.eval_fraction < 1.0:
        p.error(f"--eval-fraction must be in (0, 1), "
                f"got {args.eval_fraction}")

    import time

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.observe.metrics import default_registry
    from deeplearning4j_tpu_torch.pipeline import (ContinuousPipeline,
                                             PipelineConfig, StreamBuffer)
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.streaming import Route
    from deeplearning4j_tpu_torch.util import model_serializer

    config = PipelineConfig.parse(args.config)
    if args.log_json:
        from deeplearning4j_tpu_torch.observe import enable_structured_logging
        if args.log_json == "-":
            enable_structured_logging(stream=sys.stderr)
        else:
            enable_structured_logging(path=args.log_json)
    metrics = default_registry()
    alert_mgr = None
    if args.alerts:
        from deeplearning4j_tpu_torch.observe import (AlertManager, LogSink,
                                                load_rules)
        alert_mgr = AlertManager(metrics, load_rules(args.alerts),
                                 [LogSink()],
                                 interval_s=args.alert_interval).start()

    z = np.load(args.dataPath)
    features = np.asarray(z["features"], np.float32)
    labels = np.asarray(z["labels"], np.float32)
    n_eval = max(1, int(len(features) * args.eval_fraction))
    eval_set = DataSet(features[-n_eval:], labels[-n_eval:])
    stream_x, stream_y = features[:-n_eval], labels[:-n_eval]

    registry = ModelRegistry(metrics=metrics, wait_ms=1.0,
                             device=args.device)
    registry.register(config.name, path=args.modelPath,
                      sample_input=features[:1])

    bs = config.train["batch_size"]
    batches = [DataSet(stream_x[i:i + bs], stream_y[i:i + bs])
               for i in range(0, len(stream_x), bs)]
    cycles = args.cycles if args.cycles is not None else config.cycles
    # hold every cycle's pass outright (buffer stores references to the
    # already-materialized batch list): a cycle that drains less than a
    # full pass must not leave a later cycle's route blocked in put()
    buffer = StreamBuffer(
        capacity=max(1024, (cycles + 1) * max(1, len(batches))))

    def canary_traffic(poll_s):
        # self-driven canary traffic so weighted routing and shadow
        # diffs observe real forwards between ticks
        for i in range(4):
            registry.predict(config.name,
                             eval_set.features[i % n_eval:][:2])
        time.sleep(poll_s)

    pipe = ContinuousPipeline(
        registry, config.name, args.state_dir, config=config,
        buffer=buffer, eval_set=eval_set, metrics=metrics,
        alerts=alert_mgr, sample_input=features[:1],
        canary_wait=canary_traffic)
    previous_sigterm = signal.signal(signal.SIGTERM,
                                     lambda *a: pipe.request_stop())
    # a restarted process registers the ORIGINAL artifact as baseline;
    # if the journal already committed a promotion, re-apply it so the
    # resumed pipeline (and --modelOutputPath) serve the promoted weights
    restored = pipe.restore_promoted()
    if restored is not None:
        print(f"restored journaled promotion as v{restored}")

    try:
        # ONE stream pass per cycle (a real deployment points the route
        # at a broker): replaying all passes up front would let the
        # trainer's greedy drain starve later cycles into aborted runs
        summaries = []
        for _ in range(cycles):
            route = (Route().from_source(list(batches))
                     .to_callable(buffer.put).start())
            pipe.route = route
            summaries.append(pipe.run_cycle())
            route.join(timeout=60)
            if pipe.stopped:
                break
    finally:
        if alert_mgr is not None:
            alert_mgr.evaluate_once()
            alert_mgr.stop()
            firing = alert_mgr.firing()
            print(f"alerts firing at exit: {firing if firing else 'none'}")
        registry.shutdown()
        signal.signal(signal.SIGTERM, previous_sigterm)
        if args.log_json:
            from deeplearning4j_tpu_torch.observe import (
                disable_structured_logging)
            disable_structured_logging()
    for s in summaries:
        print(f"run {s['run']}: {s['outcome']} "
              f"(live version {s['live_version']})")
    if args.modelOutputPath:
        served = registry.get(config.name)
        model_serializer.write_model(
            served.versions[served.current_version].model,
            args.modelOutputPath)
        print(f"wrote {args.modelOutputPath}")
    return summaries


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m deeplearning4j_tpu_torch.cli "
              "{train,evaluate,serve,pipeline,nn-server,cloud-setup,"
              "profile} ...")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        serve_main(rest)
        return 0
    if cmd == "pipeline":
        pipeline_main(rest)
        return 0
    if cmd == "train":
        parallel_wrapper_main(rest)
        return 0
    if cmd == "evaluate":
        evaluate_main(rest)
        return 0
    if cmd == "profile":
        profile_main(rest)
        return 0
    if cmd == "nn-server":
        from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer
        dev = argparse.ArgumentParser(add_help=False)
        dev.add_argument("--device", default=None)
        known, rest = dev.parse_known_args(rest)
        server = NearestNeighborsServer.main(rest, device=known.device)
        print(f"nearest-neighbors server listening on port {server.port}")
        try:
            server._thread.join()
        except KeyboardInterrupt:
            server.stop()
        return 0
    if cmd == "cloud-setup":
        cluster_setup_main(rest)
        return 0
    print(f"unknown command {cmd!r}; expected 'train', 'evaluate', "
          "'serve', 'pipeline', 'nn-server', 'cloud-setup', or 'profile'")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
