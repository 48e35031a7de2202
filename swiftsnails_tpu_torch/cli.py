"""Command-line entry points of the port — the JAX package's ``cli.py``.

Reference contract (survey §2.7): per-app ``master``/``server``/``worker``
binaries taking ``-config <file>`` (``src/tools/run_master.sh``) and workers
additionally ``-data <file>`` (``run_worker.sh``). Here the three roles are
one ``train`` role: the parameter tables live on the cards that compute.
With ``expected_node_num: N`` > 1 (and ``master_addr``), ``train`` joins an
N-process ``torch.distributed`` cluster first (``parallel/cluster.py``; the
rank from ``RANK`` as torchrun sets it), trains the ``model`` family
(word2vec, a CTR family or ``seqlm``) under a ``(data, model)`` mesh of the
N ranks, and meets the others at the end-of-training barrier;
``local_train: 1`` trains each process alone. Checkpoints and resume work
under the mesh (every rank saves its shards into one checkpoint), and
``export`` reads such a checkpoint on one process. So do the loop's guards
(``guardrail``, ``tier_verify_period``, ``freshness_publish``,
``cluster_workers``): the ranks agree before any acts, and rank 0 writes
the ledger and the delta log (``framework/trainer.py``).

Usage::

    python -m swiftsnails_tpu_torch train  -config train.conf [-data corpus.txt]
    python -m swiftsnails_tpu_torch export -config train.conf -checkpoint ROOT -out vec.txt
    python -m swiftsnails_tpu_torch serve  -config train.conf -checkpoint ROOT [-replicas N]
    # in the serve REPL: `subscribe <dir>` follows the trainer's live
    # hot-row delta log (freshness_publish + freshness_dir on the trainer);
    # `subscribe tcp://HOST:PORT` streams it over a socket instead (the
    # trainer side sets `freshness_listen`)
    python -m swiftsnails_tpu_torch net-serve --root ROOT --listen HOST:PORT [--device cpu]
    #   one replica process serving pull/topk/score/health over TCP
    #   (the unit a NetFleet spawns; net.fleet.ReplicaSpawner)
    python -m swiftsnails_tpu_torch models
    python -m swiftsnails_tpu_torch worker -config ...   # alias of train (parity)
    python -m swiftsnails_tpu_torch ledger-report [LEDGER] [--failures | --diff A B | --check-regression PCT]
    python -m swiftsnails_tpu_torch trace-summary FILE   # a trace_path or metrics JSONL file
    python -m swiftsnails_tpu_torch ops [LEDGER]         # the one-screen ops dashboard
    python -m swiftsnails_tpu_torch supervisor-status [LEDGER]  # cluster membership view

Every ``-key value`` flag overrides the config key ``key``. The runs go on
the card (``cuda``) and fail without one, unless ``-device cpu`` asks for the
CPU, where every kernel wrapper runs its plain PyTorch version.

Checkpoints: with ``param_backup_root`` set, ``train`` saves
``step_<n>/`` there every ``param_backup_period`` steps (one raw-bytes file
a tensor and a ``manifest.json`` with the step, config hash, a CRC of every
tensor and the data cursor; see ``framework/checkpoint.py``), keeping the
newest ``param_backup_keep``. ``resume: auto`` continues an interrupted run
from the newest verified checkpoint (tables and data cursor); a SIGTERM
drains with a final save; ``guardrail: 1`` arms the NaN/rollback step
guardrail; ``chaos_spec`` injects faults. ``export`` writes the text
vectors of the newest checkpoint, verified.

Telemetry: ``ledger_path`` keeps the run ledger (checkpoint, chaos,
outage, ``cache_error`` and run records); ``telemetry: 1`` or a
``trace_path`` arms the span tracer, metric registry, black box and goodput
block; ``profile_dir`` captures ``profile_steps`` with ``torch.profiler``.
``ledger-report`` renders a ledger (``--failures``: the failure timeline;
``--diff A B``: regression attribution between two run records;
``--check-regression PCT``: the gate) and ``trace-summary`` a trace or
metrics file.

Serving: ``serve`` loads the newest verified checkpoint under
``-checkpoint`` into a :class:`~swiftsnails_tpu_torch.serving.engine.Servant`
(or, with ``-replicas N`` > 1, a fleet of N replicas sharing its tables)
and answers one request a stdin line, one JSON line each (see
:func:`cmd_serve`). ``ops`` renders the offline ops dashboard of a ledger.
``net-serve`` runs one replica process over TCP
(:mod:`swiftsnails_tpu_torch.net.replica_server`), on the card unless
``--device cpu``.

Cluster: ``cluster_workers: N`` (or ``TrainLoop(cluster=...)``) trains
on a range-leased stream with exactly-once batch accounting;
``supervisor-status`` replays a ledger's ``membership`` events into the
supervisor's view (who joined, who was lost and why, where each reassigned
range went, the stragglers) and the newest ``chaos_cluster`` verdict.

``master`` / ``server`` are accepted for parity and explain the collapse.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from swiftsnails_tpu_torch.utils.config import Config, ConfigError
from swiftsnails_tpu_torch.utils.flags import parse_role_argv
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger


def _world_mesh(cfg: Config):
    """The JAX CLI's mesh over the world (its ``_serve_mesh`` too): ``None``
    with ``local_train: 1`` or a world of one process, else ``model_axis``
    ranks on ``model`` (default: the first of 4, 2, 1 that divides the world
    and is smaller than it), the rest on ``data``, on the ``device`` key's
    device."""
    from swiftsnails_tpu_torch.parallel.cluster import process_info
    from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    _, n = process_info()
    if cfg.get_bool("local_train", False) or n == 1:
        return None
    model_axis = cfg.get_int("model_axis", 0)
    if model_axis <= 0:
        model_axis = next((c for c in (4, 2, 1) if n % c == 0 and n > c), 1)
    return make_mesh({DATA_AXIS: n // model_axis, MODEL_AXIS: model_axis},
                     device=cfg.get_str("device", "") or None)


def _build_trainer(cfg: Config):
    """The ``model`` key's trainer on the ``device`` key's device (default:
    the card), under :func:`_world_mesh`'s mesh where there is one."""
    from swiftsnails_tpu_torch.models.registry import get_model

    name = cfg.get_str("model", "word2vec")
    trainer_cls = get_model(name)
    device = cfg.get_str("device", "") or None
    mesh = _world_mesh(cfg)
    if mesh is None:
        return trainer_cls(cfg, device=device)
    return trainer_cls(cfg, mesh=mesh, device=device)


def cmd_train(argv: List[str]) -> int:
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.parallel.cluster import (
        barrier, initialize_cluster, process_info)

    cfg = parse_role_argv(argv)
    joined = initialize_cluster(cfg)
    if joined:
        rank, world = process_info()
        # one write: the ranks of one host often share the launcher's stderr
        sys.stderr.write(f"joined cluster: process {rank}/{world} via "
                         f"{cfg.get_str('master_addr')}\n")
        sys.stderr.flush()
    trainer = _build_trainer(cfg)
    metrics = MetricsLogger(path=cfg.get_str("metrics_path", "") or None, echo=True)
    loop = TrainLoop(trainer, metrics=metrics, log_every=cfg.get_int("log_every", 100))
    state = loop.run(seed=cfg.get_int("seed", 0))
    if loop.preempted:
        print(
            "preempted (SIGTERM): drained with a final checkpoint; "
            "restart with `resume: auto` to continue this run",
            file=sys.stderr,
        )
    barrier("end_of_training")  # MasterTerminate parity
    out = cfg.get_str("output", "")
    if out:
        trainer.export_text(state, out)  # under a mesh, rank 0 writes
        if trainer.mesh is None or process_info()[0] == 0:
            print(f"exported parameters to {out}", file=sys.stderr)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def cmd_export(argv: List[str]) -> int:
    from swiftsnails_tpu_torch.framework.checkpoint import restore_checkpoint

    cfg = parse_role_argv(argv)
    trainer = _build_trainer(cfg)
    root = cfg.get_str("checkpoint")
    out = cfg.get_str("out")
    state = restore_checkpoint(root, trainer.init_state(), mesh=trainer.mesh)
    trainer.export_text(state, out)
    print(f"exported {root} -> {out}", file=sys.stderr)
    return 0


def cmd_serve(argv: List[str]) -> int:
    """Query-only REPL over a verified checkpoint, on the card unless
    ``-device cpu`` is given.

    One request per stdin line, one JSON response per stdout line::

        pull <id> [id...]            row values
        topk <id> [k]                nearest rows to row <id> (cosine)
        score <f0> <f1> ...          CTR probability (registry models)
        stats                        latency/cache/shed snapshot
        health                       breaker / version state
        ops                          one-screen dashboard (SLO / traces)
        add                          (fleet) add a replica to the ring
        drain <replica>              (fleet) drain + remove a replica
        subscribe <dir|tcp://h:p>    follow a hot-row delta log (freshness)
        freshness                    applied-seq watermark / lag / fallbacks
        quit

    then a ``{"final_stats": ...}`` line. ``-replicas N`` (or config
    ``serve_replicas``) > 1 serves through a
    :class:`~swiftsnails_tpu_torch.serving.fleet.Fleet` of N replicas
    sharing the loaded tables.

    ``subscribe <dir>`` attaches a background
    :class:`~swiftsnails_tpu_torch.freshness.subscriber.DeltaSubscriber`
    polling the trainer's delta log: hot-row batches apply behind the
    version-keyed cache with atomic cutover, and any gap / publisher
    restart / CRC mismatch falls back to a full ``reload_from_checkpoint``
    of this checkpoint root. ``subscribe tcp://HOST:PORT`` feeds the same
    subscriber from a :class:`~swiftsnails_tpu_torch.net.delta_stream.
    TcpDeltaSource` instead. ``freshness`` reports the applied-seq
    watermark, lag, and fallback count (also rolled into ``health``;
    fleets add per-replica versions).

    With ``expected_node_num`` N > 1 (and ``master_addr``; the rank from
    ``RANK``) the N processes join a cluster and serve one checkpoint under
    a training run's mesh (:func:`_world_mesh`): rank 0 reads stdin and
    answers, the others follow it (:mod:`~swiftsnails_tpu_torch.serving.mesh_serve`)
    and print nothing; they exit when rank 0 does.
    """
    from swiftsnails_tpu_torch.parallel.cluster import initialize_cluster
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    cfg = parse_role_argv(argv)
    root = cfg.get_str("checkpoint")
    device = cfg.get_str("device", "") or None
    ledger_path = cfg.get_str("ledger_path", "")
    ledger = Ledger(ledger_path) if ledger_path else None
    replicas = cfg.get_int("replicas", cfg.get_int("serve_replicas", 1))
    fleet_mode = replicas > 1
    joined = initialize_cluster(cfg)
    try:
        return _serve_repl(cfg, root, device, ledger, replicas, fleet_mode, _world_mesh(cfg))
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve_repl(cfg, root, device, ledger, replicas, fleet_mode, mesh) -> int:
    """:func:`cmd_serve`'s server and REPL (a follower rank: its loop)."""
    import contextlib
    import json

    from swiftsnails_tpu_torch.serving import Fleet, Overloaded, Servant, Unavailable, mesh_serve

    if fleet_mode:
        server_cm = Fleet.from_checkpoint(root, cfg, device=device, mesh=mesh,
                                          replicas=replicas, ledger=ledger)
    else:
        server_cm = Servant.from_checkpoint(root, cfg, device=device, mesh=mesh,
                                            ledger=ledger)
    if mesh is not None and not mesh_serve.channel(mesh).leader:
        with server_cm:
            mesh_serve.follow(mesh)
        return 0
    subscriber = None
    delta_source = None
    with server_cm as servant, (mesh_serve.leading(mesh) if mesh is not None
                                else contextlib.nullcontext()):
        if fleet_mode:
            banner = (f"serving fleet of {replicas} replicas "
                      "(one request per line; pull/topk/score/stats/"
                      "health/ops/add/drain/subscribe/freshness/quit)")
        else:
            banner = (f"serving step {servant.step} tables "
                      f"{servant.stats()['tables']} on {servant.device} (one "
                      "request per line; pull/topk/score/stats/health/ops/"
                      "subscribe/freshness/quit)")
        print(banner, file=sys.stderr)
        for line in sys.stdin:
            toks = line.split()
            if not toks:
                continue
            op, args = toks[0], toks[1:]
            try:
                if op in ("quit", "exit"):
                    break
                elif op == "pull":
                    rows = servant.pull([int(a) for a in args])
                    out = {"rows": [[round(float(v), 6) for v in r]
                                    for r in rows]}
                elif op == "topk":
                    row = int(args[0])
                    k = int(args[1]) if len(args) > 1 else None
                    query = servant.pull([row])[0]
                    out = {"topk": servant.topk(query, k=k, exclude=(row,))}
                elif op == "score":
                    scores = servant.score([int(a) for a in args])
                    out = {"scores": [round(float(s), 6) for s in scores]}
                elif op == "stats":
                    out = servant.stats()
                elif op == "health":
                    out = servant.health()
                elif op == "ops":
                    from swiftsnails_tpu_torch.telemetry.ops import render_ops

                    tracer = getattr(servant, "request_tracer", None)
                    anomalies = ([c.to_dict()
                                  for c in tracer.anomaly_traces(5)]
                                 if tracer is not None else None)
                    text = render_ops(servant.stats(),
                                      health=servant.health(),
                                      anomalies=anomalies)
                    print(text, file=sys.stderr)
                    out = {"ops": "printed"}
                elif op == "add" and fleet_mode:
                    out = {"added": servant.add_replica()}
                elif op == "drain" and fleet_mode:
                    out = {"drained": servant.drain(args[0])}
                elif op == "subscribe":
                    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber

                    if subscriber is not None:
                        subscriber.stop()
                    if delta_source is not None:
                        delta_source.stop()
                        delta_source = None
                    target = args[0]
                    tcp = target.startswith("tcp://")
                    # socket-fed: the TCP source drives apply_batch and the
                    # subscriber never polls a local directory; base
                    # adoption, gap detection and the fallback ladder are
                    # unchanged
                    subscriber = DeltaSubscriber(
                        servant, (cfg.get_str("freshness_dir", "") or root + ".deltas")
                        if tcp else target, config=cfg, checkpoint_root=root,
                        max_lag_ms=cfg.get_float("freshness_max_lag_ms", 0.0),
                        ledger=ledger)
                    if tcp:
                        from swiftsnails_tpu_torch.net.delta_stream import TcpDeltaSource

                        host, _, port = target[len("tcp://"):].rpartition(":")
                        delta_source = TcpDeltaSource(
                            subscriber, host, int(port), config=cfg, ledger=ledger).start()
                        found = True
                    else:
                        found = subscriber.subscribe()
                        subscriber.start()
                    servant.attach_freshness(subscriber)
                    out = {"subscribed": target, "stream_open": found}
                elif op == "freshness":
                    if subscriber is None:
                        out = {"error": "not subscribed (use: subscribe "
                               "<dir> or subscribe tcp://HOST:PORT)"}
                    else:
                        out = subscriber.status()
                        if delta_source is not None:
                            out["source"] = delta_source.status()
                else:
                    out = {"error": f"unknown op {op!r}"}
            except Overloaded as e:
                out = {"error": f"overloaded: {e}", "shed": True}
            except Unavailable as e:
                out = {"error": f"unavailable: {e}", "shed": True}
            except Exception as e:  # noqa: BLE001 — a REPL must not die
                out = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps(out), flush=True)
        if delta_source is not None:
            delta_source.stop()
        if subscriber is not None:
            subscriber.stop()
        print(json.dumps({"final_stats": servant.stats()}), flush=True)
    return 0


def cmd_ops(argv: List[str]) -> int:
    """One-screen ops dashboard from the run ledger: the newest serving
    bench blocks, SLO error budget from ``slo_burn`` events, and the recent
    ``trace_anomaly`` tail with drillable trace ids."""
    from swiftsnails_tpu_torch.telemetry.ops import main as ops_main

    return ops_main(argv)


def cmd_net_serve(argv: List[str]) -> int:
    """One replica process serving a checkpoint over TCP: pull/topk/score/
    health RPCs behind the SSD1 frame codec, spawnable by hand here or by
    ``net.fleet.ReplicaSpawner``; prints one JSON ready line (``{"port":
    ..., "incarnation": ...}``) and serves until killed. On the card unless
    ``--device cpu``."""
    from swiftsnails_tpu_torch.net.replica_server import main as replica_main

    return replica_main(argv)


def cmd_supervisor_status(argv: List[str]) -> int:
    """Replay a run ledger's membership events into the supervisor's view:
    per-worker state (alive/lost, joins, straggler flags, where reassigned
    ranges went) plus the newest exactly-once accounting verdict."""
    import os

    from swiftsnails_tpu_torch.cluster.status import render_supervisor_status
    from swiftsnails_tpu_torch.telemetry.ledger import DEFAULT_LEDGER, Ledger

    path = argv[0] if argv else os.environ.get("SSN_LEDGER_PATH", DEFAULT_LEDGER)
    ledger = Ledger(path)
    if not os.path.exists(ledger.path):
        print(f"supervisor-status: no ledger at {ledger.path}", file=sys.stderr)
        return 1
    print(render_supervisor_status(ledger))
    return 0


def cmd_ledger_report(argv: List[str]) -> int:
    from swiftsnails_tpu_torch.telemetry.ledger import main as ledger_main

    return ledger_main(argv)


def cmd_trace_summary(argv: List[str]) -> int:
    from swiftsnails_tpu_torch.telemetry.summary import main as summary_main

    return summary_main(argv)


def cmd_models(argv: List[str]) -> int:
    from swiftsnails_tpu_torch.models.registry import available_models

    for name in available_models():
        print(name)
    return 0


_ROLE_NOTE = (
    "swiftsnails_tpu_torch has no separate {role} role: the parameter tables\n"
    "live on the card that trains. Run\n"
    "  python -m swiftsnails_tpu_torch train -config <file>"
)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    try:
        if cmd in ("train", "worker"):
            return cmd_train(rest)
        if cmd == "export":
            return cmd_export(rest)
        if cmd == "serve":
            return cmd_serve(rest)
        if cmd == "ops":
            return cmd_ops(rest)
        if cmd == "models":
            return cmd_models(rest)
        if cmd == "ledger-report":
            return cmd_ledger_report(rest)
        if cmd == "trace-summary":
            return cmd_trace_summary(rest)
        if cmd == "supervisor-status":
            return cmd_supervisor_status(rest)
        if cmd == "net-serve":
            return cmd_net_serve(rest)
        if cmd in ("master", "server"):
            print(_ROLE_NOTE.format(role=cmd), file=sys.stderr)
            return 0
        print(f"unknown command {cmd!r}; try: train, export, serve, models, "
              "ledger-report, trace-summary, supervisor-status, ops, net-serve",
              file=sys.stderr)
        return 2
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
