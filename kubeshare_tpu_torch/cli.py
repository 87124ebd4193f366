"""Component entry points of the port: ``python -m kubeshare_tpu_torch
<component>``, the subcommands of kubeshare_tpu/cli.py with the same
flags, so a cluster of CUDA cards runs what ``deploy/`` asks of the JAX
package:

    python -m kubeshare_tpu_torch collector [--port 9004] [--fake-chips N]
    python -m kubeshare_tpu_torch launcher [--chip-uuids GPU-...,GPU-...]
    python -m kubeshare_tpu_torch scheduler --cluster fake [--collector-urls URL,...]
    python -m kubeshare_tpu_torch aggregator --cluster fake [--port 9005]
    python -m kubeshare_tpu_torch configd --cluster fake [--config-dir DIR]
    python -m kubeshare_tpu_torch simulate --trace examples/trace-small.txt

The collector exports the node's CUDA devices (``CudaEnumerator``); the
launcher runs one ``ChipSupervisor`` (tokend + pod managers) a device,
for the UUIDs ``discover_local_chips`` finds when ``--chip-uuids`` is
empty.  The scheduler places pods on cells of the inventory the
collectors export (``PromInventory``) and injects a CUDA pod's env; the
config daemon writes the placements into the files tokend and the pod
managers read, from the cluster API or, with ``--aggregator-url``, from
the aggregator's ``gpu_requirement`` samples (the reference's wiring).
``simulate`` replays an arrival trace through the scheduler on a virtual
clock and prints its report as JSON on the last line.  The cluster
backend is the in-memory FakeCluster, or ``--cluster k8s`` where the
``kubernetes`` package is installed.  Only ``scheduler`` and
``simulate --kubeshare-config`` read YAML (PyYAML).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import time

from . import constants
from .utils.logger import configure_logger


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--level", type=int, default=2,
                        help="log level 0=error..3=debug (ref logger flag)")
    parser.add_argument("--log-dir", default=None,
                        help=f"log directory (default stderr; ref {constants.LOG_DIR})")
    parser.add_argument("--node-name", default=os.environ.get("NODE_NAME")
                        or socket.gethostname())


def _install_stop() -> list:
    stop: list = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    return stop


def _serve_forever() -> None:
    stop = _install_stop()
    while not stop:
        time.sleep(1)


def cmd_collector(args: argparse.Namespace) -> int:
    from .collector import Collector, CudaEnumerator, FakeEnumerator

    log = configure_logger("kubeshare-collector", args.level, args.log_dir)
    if args.fake_chips:
        from .cell.allocator import ChipInfo

        chips = [
            ChipInfo(f"{args.node_name}-gpu-{i}", args.fake_hbm_gb << 30,
                     args.fake_model, i)
            for i in range(args.fake_chips)
        ]
        enumerator = FakeEnumerator(chips)
    else:
        enumerator = CudaEnumerator()
    collector = Collector(enumerator, node_name=args.node_name)
    server = collector.serve(port=args.port)
    log.info("collector serving on :%d/kubeshare-collector", server.port)
    _serve_forever()
    server.stop()
    return 0


def cmd_aggregator(args: argparse.Namespace) -> int:
    from .aggregator import Aggregator

    log = configure_logger("kubeshare-aggregator", args.level, args.log_dir)
    cluster = _make_cluster(args)
    aggregator = Aggregator(cluster)
    server = aggregator.serve(port=args.port)
    log.info("aggregator serving on :%d/kubeshare-aggregator", server.port)
    _serve_forever()
    server.stop()
    return 0


def cmd_configd(args: argparse.Namespace) -> int:
    from .configd import ConfigDaemon, write_scheduler_ip

    log = configure_logger("kubeshare-config", args.level, args.log_dir)
    # own IP for in-pod hooks (ref kubeshare-query-ip): flag, else the
    # downward-API POD_IP env the manifests inject
    scheduler_ip = args.write_scheduler_ip or os.environ.get("POD_IP")
    if scheduler_ip:
        path = write_scheduler_ip(scheduler_ip, args.library_path)
        log.info("wrote scheduler IP to %s", path)
    daemon = ConfigDaemon(
        args.node_name,
        cluster=None if args.aggregator_url else _make_cluster(args),
        aggregator_url=args.aggregator_url,
        config_dir=args.config_dir,
        port_dir=args.port_dir,
    )
    log.info("configd for node %s -> %s", args.node_name, args.config_dir)
    interval = args.sync_interval
    stop = _install_stop()
    while not stop:
        try:
            daemon.sync()
        except Exception as e:  # keep the daemon alive through blips
            log.warning("sync failed: %s", e)
        time.sleep(interval)
    return 0


def cmd_launcher(args: argparse.Namespace) -> int:
    from .runtime import ChipSupervisor

    log = configure_logger("kubeshare-launcher", args.level, args.log_dir)
    supervisors = []
    uuids = args.chip_uuids.split(",") if args.chip_uuids else []
    if not uuids:
        # enumerate local chips (the launcher-multigpus.sh role,
        # ref docker/kubeshare-gemini-scheduler/launcher-multigpus.sh)
        from .cell.topology import discover_local_chips

        uuids = [chip.uuid for chip in discover_local_chips()]
    if not uuids:
        log.error("no chips found and none specified via --chip-uuids")
        return 1
    metric_servers = []
    all_ports = [args.base_port + i for i in range(len(uuids))]
    for i, uuid in enumerate(uuids):
        # every other chip of this node is a gang sibling: tokend -G keeps
        # multi-chip fractional pods' grants aligned (docs/token-protocol.md)
        siblings = tuple(p for p in all_ports if p != all_ports[i]) \
            if args.gang_coordination else ()
        supervisor = ChipSupervisor(
            uuid,
            config_dir=args.config_dir,
            port_dir=args.port_dir,
            tokend_port=args.base_port + i,
            base_quota_ms=args.base_quota,
            min_quota_ms=args.min_quota,
            window_ms=args.window,
            log_dir=args.log_dir,
            gang_peer_ports=siblings,
        )
        supervisor.start()
        supervisors.append(supervisor)
        log.info("chip %s: tokend on port %d", uuid, args.base_port + i)
        if args.metrics_base_port >= 0:
            server = supervisor.serve_metrics(port=args.metrics_base_port + i)
            metric_servers.append(server)
            log.info("chip %s: metrics on :%d/metrics", uuid, server.port)
    _serve_forever()
    for server in metric_servers:
        server.stop()
    for supervisor in supervisors:
        supervisor.stop()
    return 0


def cmd_scheduler(args: argparse.Namespace) -> int:
    from .cell import load_config
    from .collector import PromInventory
    from .scheduler import KubeShareScheduler, SchedulerArgs, SchedulerEngine

    log = configure_logger("kubeshare-scheduler", args.level, args.log_dir)
    topology = load_config(path=args.kubeshare_config)
    cluster = _make_cluster(args)
    inventory = PromInventory(args.collector_urls.split(",")) if args.collector_urls \
        else (lambda node: [])
    plugin = KubeShareScheduler(
        topology, cluster, inventory,
        args=SchedulerArgs(level=args.level, bind_mode=args.bind_mode),
        log_dir=args.log_dir,
    )
    engine = SchedulerEngine(plugin, cluster)
    metric_server = None
    if args.metrics_port >= 0:
        from .utils.promtext import MetricServer

        metric_server = MetricServer(plugin.collect_metrics, port=args.metrics_port)
        metric_server.start()
        log.info("scheduler metrics on :%d/metrics", metric_server.port)
    elector = None
    if getattr(args, "leader_elect", False):
        from .scheduler.leader import LeaderElector

        identity = args.leader_identity or (
            f"{socket.gethostname()}-{os.getpid()}")
        elector = LeaderElector(
            cluster, identity, lease_duration_s=args.lease_duration)
        log.info("leader election on (identity=%s)", identity)
    log.info("scheduler running (bind_mode=%s)", args.bind_mode)
    stop = _install_stop()
    while not stop:
        if elector is not None and not elector.is_leader():
            time.sleep(args.idle_interval)
            continue
        result = engine.run_once()
        if result is None:
            time.sleep(args.idle_interval)
        else:
            log.info("cycle: %s -> %s %s", result.pod_key, result.result,
                     result.message)
            if result.result in ("unschedulable", "error"):
                # back off instead of hot-spinning on a stuck head-of-queue
                time.sleep(args.idle_interval)
    if metric_server is not None:
        metric_server.stop()
    return 0


def cmd_simulate(args: argparse.Namespace) -> int:
    from .simulator import run_trace

    report = run_trace(
        trace_path=args.trace,
        topology_path=args.kubeshare_config,
        nodes=args.nodes,
        chips_per_node=args.chips_per_node,
        time_scale=args.time_scale,
        seed=args.seed,
        gang_fraction=args.gang_fraction,
    )
    print(report.to_json())
    return 0


def _make_cluster(args: argparse.Namespace):
    backend = getattr(args, "cluster", "fake")
    if backend == "fake":
        from .cluster.fake import FakeCluster

        return FakeCluster()
    if backend == "k8s":
        try:
            from .cluster.k8s import K8sCluster
        except Exception as e:
            raise SystemExit(
                "the kubernetes client package is not available in this "
                "environment; run components with --cluster fake or install "
                "the kubernetes package (the adapter is import-gated)"
            ) from e
        try:
            return K8sCluster(kubeconfig=getattr(args, "kubeconfig", None))
        except RuntimeError as e:
            raise SystemExit(str(e)) from e
    raise SystemExit(f"unknown cluster backend {backend}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kubeshare_tpu_torch")
    sub = parser.add_subparsers(dest="component", required=True)

    p = sub.add_parser("collector", help="chip inventory exporter (ref pkg/collector)")
    _add_common(p)
    p.add_argument("--port", type=int, default=constants.COLLECTOR_PORT)
    p.add_argument("--fake-chips", type=int, default=0,
                   help="export N fake chips instead of probing hardware")
    p.add_argument("--fake-model", default="NVIDIA-H100-80GB-HBM3")
    p.add_argument("--fake-hbm-gb", type=int, default=80)
    p.set_defaults(fn=cmd_collector)

    p = sub.add_parser("aggregator", help="placement exporter (ref pkg/aggregator)")
    _add_common(p)
    p.add_argument("--port", type=int, default=constants.AGGREGATOR_PORT)
    p.add_argument("--cluster", default="fake", choices=["fake", "k8s"])
    p.set_defaults(fn=cmd_aggregator)

    p = sub.add_parser("configd", help="per-node config daemon (ref pkg/config)")
    _add_common(p)
    p.add_argument("--cluster", default="fake", choices=["fake", "k8s"])
    p.add_argument("--aggregator-url", default=None)
    p.add_argument("--config-dir", default=constants.CHIP_CONFIG_DIR)
    p.add_argument("--port-dir", default=constants.POD_MANAGER_PORT_DIR)
    p.add_argument("--sync-interval", type=float, default=5.0)
    p.add_argument("--library-path", default=constants.LIBRARY_PATH)
    p.add_argument("--write-scheduler-ip", default=None,
                   help="also write schedulerIP.txt (ref kubeshare-query-ip)")
    p.set_defaults(fn=cmd_configd)

    p = sub.add_parser("launcher", help="per-chip token runtime supervisor "
                       "(ref gemini launcher.py)")
    _add_common(p)
    p.add_argument("--chip-uuids", default="",
                   help="comma-separated; default: discover local chips")
    p.add_argument("--config-dir", default=constants.CHIP_CONFIG_DIR)
    p.add_argument("--port-dir", default=constants.POD_MANAGER_PORT_DIR)
    p.add_argument("--base-port", type=int, default=constants.TOKEND_BASE_PORT)
    p.add_argument("--metrics-base-port", type=int, default=9010,
                   help="per-chip runtime metrics ports; -1 disables")
    p.add_argument("--base-quota", type=float,
                   default=constants.TOKEN_BASE_QUOTA_MS,
                   help="token base quota ms (ref launcher.py:78)")
    p.add_argument("--min-quota", type=float,
                   default=constants.TOKEN_MIN_QUOTA_MS)
    p.add_argument("--window", type=float, default=constants.TOKEN_WINDOW_MS,
                   help="sliding accounting window ms (ref launcher.py:80)")
    p.add_argument("--no-gang-coordination", dest="gang_coordination",
                   action="store_false", default=True,
                   help="run per-chip tokends independently (reference "
                        "behavior) instead of gang-aligning grants via -G")
    p.set_defaults(fn=cmd_launcher)

    p = sub.add_parser("scheduler", help="scheduling control loop (ref pkg/scheduler)")
    _add_common(p)
    p.add_argument("--cluster", default="fake", choices=["fake", "k8s"])
    p.add_argument("--kubeshare-config", default=constants.CONFIG_FILE)
    p.add_argument("--collector-urls", default="")
    p.add_argument("--bind-mode", default="patch", choices=["patch", "shadow"])
    p.add_argument("--idle-interval", type=float, default=0.5)
    p.add_argument("--metrics-port", type=int, default=9006,
                   help="scheduler-state metrics port; -1 disables")
    p.add_argument("--leader-elect", action="store_true",
                   help="lease-based leader election: only the holder of "
                        "the kubeshare-scheduler lease runs scheduling "
                        "cycles (HA replicas; the reference rode "
                        "kube-scheduler's elector)")
    p.add_argument("--leader-identity", default="",
                   help="lease holder identity (default: hostname-pid)")
    p.add_argument("--lease-duration", type=float, default=15.0)
    p.set_defaults(fn=cmd_scheduler)

    p = sub.add_parser("simulate", help="trace-driven load simulation "
                       "(ref test/simulator)")
    p.add_argument("--trace", required=True)
    p.add_argument("--kubeshare-config", default=None)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--chips-per-node", type=int, default=4)
    p.add_argument("--time-scale", type=float, default=0.0,
                   help="0 = as fast as possible")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gang-fraction", type=float, default=0.0,
                   help="fraction of arrivals that are coscheduled gangs")
    p.set_defaults(fn=cmd_simulate)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
