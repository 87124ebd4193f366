"""Node-daemon entry points of the port: ``python -m kubeshare_tpu_torch
collector|launcher``, the ``collector`` and ``launcher`` subcommands of
kubeshare_tpu/cli.py with the same flags, so a node of CUDA cards runs
what ``deploy/node-daemon.yaml`` asks of the JAX package:

    python -m kubeshare_tpu_torch collector [--port 9004] [--fake-chips N]
    python -m kubeshare_tpu_torch launcher [--chip-uuids GPU-...,GPU-...]

The collector exports the node's CUDA devices (``CudaEnumerator``); the
launcher runs one ``ChipSupervisor`` (tokend + pod managers) a device,
for the UUIDs ``discover_local_chips`` finds when ``--chip-uuids`` is
empty.  The other subcommands of the JAX package (scheduler, aggregator,
configd, simulate) are control plane that serves both packages and run
from it.
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


def _serve_forever() -> None:
    stop: list = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
