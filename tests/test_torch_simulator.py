"""The port's trace simulator against the JAX package's (tests/
test_tooling.py's TestSimulator, tests/test_soak.py's gang churn): the
same trace entries, and reports equal to JAX's apart from
``wall_seconds`` over seeds, gang fractions and the default and a
heterogeneous cluster; the port's default cluster is built without
PyYAML; ``python -m kubeshare_tpu_torch simulate`` prints the same JSON,
and the ``aggregator`` and ``simulate`` subcommands take JAX's flags and
defaults."""

import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kubeshare_tpu import cli as jax_cli
from kubeshare_tpu.simulator import parse_trace as jax_parse_trace
from kubeshare_tpu.simulator import run_trace as jax_run_trace
from kubeshare_tpu_torch import cli
from kubeshare_tpu_torch.simulator import parse_trace, run_trace
from kubeshare_tpu_torch.simulator import simulator as port_simulator

REPO = Path(__file__).resolve().parent.parent
TRACE = str(REPO / "examples" / "trace-small.txt")
V4_CLUSTER = str(REPO / "deploy" / "config" / "kubeshare-config-v4-cluster.yaml")


def _python(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _report(result):
    out = dict(result.__dict__)
    out.pop("wall_seconds")
    return out


def test_parse_trace_equals_jax(tmp_path):
    entries = parse_trace(TRACE)
    assert len(entries) == 60 and all(e.chips >= 1 for e in entries)
    assert [e.__dict__ for e in entries] == [
        e.__dict__ for e in jax_parse_trace(TRACE)]
    # short and malformed lines are skipped alike
    odd = tmp_path / "odd.txt"
    odd.write_text("1\t2\n3\tx\t4\n5\t1\t2.5\n\n0.5\t4\t7\textra\n")
    assert [e.__dict__ for e in parse_trace(str(odd))] == [
        e.__dict__ for e in jax_parse_trace(str(odd))] == [
        {"start_offset_s": 5.0, "chips": 1, "runtime_s": 2.5},
        {"start_offset_s": 0.5, "chips": 4, "runtime_s": 7.0}]


@pytest.mark.parametrize("topology", [None, V4_CLUSTER],
                         ids=["default", "v4-cluster"])
@pytest.mark.parametrize("gang_fraction", [0.0, 0.4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_trace_equals_jax(seed, gang_fraction, topology):
    port = run_trace(TRACE, topology_path=topology, seed=seed,
                     gang_fraction=gang_fraction)
    jax = jax_run_trace(TRACE, topology_path=topology, seed=seed,
                        gang_fraction=gang_fraction)
    assert _report(port) == _report(jax)
    assert port.bound + port.unschedulable == port.submitted
    assert port.bound > 0
    if gang_fraction == 0.0:
        assert port.submitted == 60
    if topology is None:
        assert set(port.placements_per_node) <= {
            f"sim-node-{i}" for i in range(4)}
    else:
        assert set(port.placements_per_node) <= {
            "tpu-v4-host-a", "tpu-v4-host-b", "tpu-v5e-host-c"}


def test_default_cluster_is_the_cards():
    """The default inventory names the card's leaves, as
    discover_local_chips names an H100, where JAX's names TPU-v4 chips."""
    topology = port_simulator.generate_tpu_topology_config(
        [("n0", port_simulator.DEFAULT_CHIP_MODEL, 2)])
    chips = port_simulator._inventory_from_topology(topology)["n0"]
    assert [(c.uuid, c.model, c.memory, c.index) for c in chips] == [
        ("n0-gpu-0", "NVIDIA-H100-80GB-HBM3", 80 << 30, 0),
        ("n0-gpu-1", "NVIDIA-H100-80GB-HBM3", 80 << 30, 1)]


def test_gang_churn_simulation_invariants():
    """tests/test_soak.py's gang churn through the port: no partial-gang
    leaks, every submitted pod bound or refused, equal to JAX's."""
    report = run_trace(TRACE, nodes=2, chips_per_node=4, gang_fraction=0.4,
                       seed=3)
    assert report.submitted > 60  # gangs add members
    assert report.bound + report.unschedulable == report.submitted
    assert report.bound > 0
    assert _report(report) == _report(jax_run_trace(
        TRACE, nodes=2, chips_per_node=4, gang_fraction=0.4, seed=3))


def test_cli_simulate_prints_jaxs_report():
    args = ["simulate", "--trace", TRACE, "--nodes", "2",
            "--chips-per-node", "4", "--gang-fraction", "0.4", "--seed", "1"]
    port, jax = (_python("-m", package, *args)
                 for package in ("kubeshare_tpu_torch", "kubeshare_tpu"))
    assert port.returncode == 0, port.stderr
    assert jax.returncode == 0, jax.stderr
    port_report, jax_report = (json.loads(p.stdout.strip().splitlines()[-1])
                               for p in (port, jax))
    assert list(port_report) == list(jax_report)
    port_report.pop("wall_seconds")
    jax_report.pop("wall_seconds")
    assert port_report == jax_report and port_report["submitted"] > 60


def test_simulator_runs_without_yaml():
    """The card's machine has no PyYAML: the simulator and the CLI import
    without it, and the default cluster runs; only a config file needs
    it."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        import kubeshare_tpu_torch.cli
        from kubeshare_tpu_torch.simulator import run_trace
        report = run_trace({TRACE!r}, gang_fraction=0.4)
        assert report.submitted > 60 and report.bound > 0, report
        try:
            run_trace({TRACE!r}, topology_path={V4_CLUSTER!r})
        except ImportError:
            print("yaml refused only for a config file")
    """)
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "yaml refused only for a config file" in proc.stdout


def _actions(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return [(a.dest, a.option_strings, a.default, a.type, a.required,
             a.choices) for a in sub.choices[name]._actions
            if a.dest not in ("help", "fn")]


@pytest.mark.parametrize("name", ["aggregator", "simulate"])
def test_subcommand_flags_equal_jaxs(name):
    port, jax = _actions(cli.build_parser(), name), _actions(
        jax_cli.build_parser(), name)
    # the node's hostname is read where the parser is built: equal here
    assert port == jax
    defaults = cli.build_parser().parse_args(
        [name] + (["--trace", TRACE] if name == "simulate" else []))
    assert defaults.fn is getattr(cli, f"cmd_{name}")
    if name == "aggregator":
        assert (defaults.port, defaults.cluster) == (9005, "fake")
