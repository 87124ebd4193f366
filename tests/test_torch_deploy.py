"""The port's deployment on a Kubernetes cluster of CUDA nodes
(deploy/cuda/, docker/Dockerfile.torch, the Makefile's *-torch targets),
held as tests/test_tooling.py holds JAX's deploy/, examples/*.yaml and
docker/Dockerfile: every manifest parses and runs the port's CLI with
flags it accepts, the ServiceMonitors and topologies, every example pod
placed by the port's scheduler on an H100 inventory, the image's build
surface without a container runtime, the kind walk up to its SKIP, the
scheduler's inventory read through Prometheus's /federate endpoint (and
the one-node-at-a-time Service it replaces), and the constants
chip_smoke.py's placement phase holds for the MNIST manifest."""

import glob
import http.server
import importlib
import os
import subprocess
import sys
import threading

import pytest
import yaml

from kubeshare_tpu_torch import cli, constants
from kubeshare_tpu_torch.cell import (build_cell_chains, build_cell_forest,
                                      load_config)
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cell.spec import check_physical_cells
from kubeshare_tpu_torch.cell.topology import _normalize_kind, slice_key
from kubeshare_tpu_torch.cluster.api import Container, FakeClock, Node, Pod
from kubeshare_tpu_torch.cluster.fake import FakeCluster
from kubeshare_tpu_torch.collector import PromInventory
from kubeshare_tpu_torch.scheduler import (KubeShareScheduler, SchedulerArgs,
                                           SchedulerEngine, parse_pod_labels)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DEPLOY = os.path.join(REPO, "deploy", "cuda")
DOCKERFILE = os.path.join(REPO, "docker", "Dockerfile.torch")
IMAGE = "kubeshare-tpu-torch:latest"
H100 = "NVIDIA-H100-80GB-HBM3"
# nvidia-smi's names of the cards the topologies hold
CARD_NAMES = ("NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB")
MANIFESTS = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(DEPLOY, "*.yaml")))
TOPOLOGIES = sorted(glob.glob(os.path.join(DEPLOY, "config", "*.yaml")))
EXAMPLES = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(DEPLOY, "examples", "*.yaml")))


def load_all(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def pod_specs(doc):
    """(metadata, spec) of the pods a manifest document makes."""
    if doc["kind"] == "Pod":
        return [(doc["metadata"], doc["spec"])]
    if doc["kind"] in ("Deployment", "DaemonSet", "Job"):
        template = doc["spec"]["template"]
        return [(template["metadata"], template["spec"])]
    return []


def containers_of(path):
    return [c for doc in load_all(path) for _, spec in pod_specs(doc)
            for c in spec.get("initContainers", []) + spec["containers"]]


def by_kind(name, kind):
    return [d for d in load_all(os.path.join(DEPLOY, name)) if d["kind"] == kind]


@pytest.mark.parametrize("name", MANIFESTS)
def test_manifest_parses_and_runs_the_port(name):
    docs = load_all(os.path.join(DEPLOY, name))
    assert docs
    for doc in docs:
        assert "kind" in doc and "apiVersion" in doc, name
    commands = 0
    for container in containers_of(os.path.join(DEPLOY, name)):
        assert container["image"] == IMAGE, (name, container["name"])
        command = container["command"]
        assert "kubeshare_tpu " not in " ".join(command) + " "
        if command[:3] == ["python", "-m", "kubeshare_tpu_torch"]:
            args = cli.build_parser().parse_args(command[3:])  # exits if refused
            assert args.component == command[3]
            commands += 1
    assert commands == {"scheduler.yaml": 1, "scheduler-test.yaml": 1,
                        "node-daemon.yaml": 3, "aggregator.yaml": 1,
                        "collector.yaml": 0}[name]


def test_servicemonitors_cover_both_exporters():
    monitors, services = {}, {}
    for name in ("aggregator.yaml", "collector.yaml"):
        for doc in by_kind(name, "ServiceMonitor"):
            monitors[doc["metadata"]["name"]] = doc
        for doc in by_kind(name, "Service"):
            services[doc["metadata"]["name"]] = doc
    assert set(monitors) == {"kubeshare-aggregator", "kubeshare-collector"}
    for name, monitor in monitors.items():
        [endpoint] = monitor["spec"]["endpoints"]
        assert endpoint["interval"] == "5s"
        assert endpoint["path"] == f"/{name}"
        # the exporters' node / pod / namespace labels survive the scrape
        assert endpoint["honorLabels"] is True
        match = monitor["spec"]["selector"]["matchLabels"]
        labels = services[name]["metadata"]["labels"]
        assert all(labels.get(k) == v for k, v in match.items()), name
    # the collector's Service selects the node daemon's pods
    [daemon] = by_kind("node-daemon.yaml", "DaemonSet")
    selector = services["kubeshare-collector"]["spec"]["selector"]
    pod_labels = daemon["spec"]["template"]["metadata"]["labels"]
    assert all(pod_labels.get(k) == v for k, v in selector.items())


def scheduler_args(name):
    [container] = containers_of(os.path.join(DEPLOY, name))
    return cli.build_parser().parse_args(container["command"][3:])


@pytest.mark.parametrize("name", ["scheduler.yaml", "scheduler-test.yaml"])
def test_scheduler_binds_in_shadow_mode_over_the_federate_endpoint(name):
    """Patch mode cannot reach a container's env, so the deployed
    scheduler binds in shadow mode; its inventory comes from
    Prometheus's /federate, matched on the collectors' capacity series,
    which holds every node (a Service reaches one collector a scrape)."""
    args = scheduler_args(name)
    assert args.bind_mode == "shadow" and args.cluster == "k8s"
    [url] = args.collector_urls.split(",")
    assert url.endswith(f"/federate?match%5B%5D={constants.METRIC_CAPACITY}")
    assert args.kubeshare_config == constants.CONFIG_FILE


def test_scheduler_test_pod_variant():
    docs = load_all(os.path.join(DEPLOY, "scheduler-test.yaml"))
    assert [d["kind"] for d in docs] == ["Pod"]
    assert docs[0]["spec"]["restartPolicy"] == "Never"
    assert scheduler_args("scheduler-test.yaml").level == 4
    assert docs[0]["spec"]["serviceAccountName"] == "kubeshare-scheduler"


def test_scheduler_topology_configmap_builds():
    [configmap] = by_kind("scheduler.yaml", "ConfigMap")
    config = load_config(text=configmap["data"]["kubeshare-config.yaml"])
    check_physical_cells(config)
    elements, _, _ = build_cell_chains(config.cell_types)
    assert build_cell_forest(elements, config.cells)
    assert {t.child_cell_type for t in config.cell_types.values()} >= {H100}


def test_node_daemon():
    """hook-init puts the hook where the scheduler's LD_PRELOAD names it;
    the collector and the launcher see every card and claim none."""
    [daemon] = by_kind("node-daemon.yaml", "DaemonSet")
    spec = daemon["spec"]["template"]["spec"]
    assert spec["hostNetwork"] is True
    assert spec["nodeSelector"] == {constants.NODE_LABEL_FILTER: "true"}
    [init] = spec["initContainers"]
    assert init["name"] == "hook-init"
    source, target = init["command"][-1].split()[-2:]
    assert target == constants.SHIM_LIBRARY
    assert source == "/opt/cudahook/libcudahook.so.1"
    volumes = {v["name"]: v for v in spec["volumes"]}
    [mount] = init["volumeMounts"]
    assert mount["mountPath"] == constants.LIBRARY_PATH
    assert volumes[mount["name"]]["hostPath"]["path"] == constants.LIBRARY_PATH
    containers = {c["name"]: c for c in spec["containers"]}
    assert set(containers) == {"collector", "configd", "launcher"}
    for name in ("collector", "launcher"):
        env = {e["name"]: e.get("value") for e in containers[name]["env"]}
        assert env[constants.ENV_VISIBLE_DEVICES] == "all"
        assert env[constants.ENV_DRIVER_CAPABILITIES] == \
            constants.DRIVER_CAPABILITIES
        assert "nvidia.com/gpu" not in str(containers[name].get("resources"))
    assert containers["launcher"]["securityContext"]["privileged"] is True
    configd = containers["configd"]
    assert "--cluster=k8s" in configd["command"]
    assert "POD_IP" in {e["name"] for e in configd["env"]}
    assert constants.LIBRARY_PATH in {
        m["mountPath"] for m in configd["volumeMounts"]}


def forest_of(path):
    config = load_config(path=path)
    check_physical_cells(config)
    elements, priority, _ = build_cell_chains(config.cell_types)
    forest = build_cell_forest(elements, config.cells)
    assert forest and priority, path
    return config, forest


def leaves_of(forest):
    return [leaf for by_level in forest.values()
            for roots in by_level.values()
            for root in roots for leaf in root.leaves()]


@pytest.mark.parametrize("path", TOPOLOGIES, ids=os.path.basename)
def test_topology_builds_with_collector_names(path):
    config, forest = forest_of(path)
    names = {_normalize_kind(n) for n in CARD_NAMES}
    leaf_types = {leaf.cell_type for leaf in leaves_of(forest)}
    assert leaf_types and leaf_types <= names, leaf_types
    assert H100 in leaf_types


def test_topologies_cover_the_layouts():
    assert len(TOPOLOGIES) >= 4
    by_name = {os.path.basename(p): forest_of(p) for p in TOPOLOGIES}
    single = by_name["kubeshare-config-h100-node.yaml"][1]
    assert len(leaves_of(single)) == 8
    cluster_config = by_name["kubeshare-config-h100-cluster.yaml"][0]
    elements, _, _ = build_cell_chains(cluster_config.cell_types)
    assert any(e.is_multi_nodes for e in elements.values())
    mixed = by_name["kubeshare-config-heterogeneous.yaml"][1]
    assert {leaf.cell_type for leaf in leaves_of(mixed)} == \
        {_normalize_kind(n) for n in CARD_NAMES}


def test_multislice_topology_has_two_slice_keys():
    config, forest = forest_of(
        os.path.join(DEPLOY, "config", "kubeshare-config-multislice.yaml"))
    slice_types = frozenset(
        name for name, t in config.cell_types.items() if t.is_slice_level)
    assert slice_types == {"NVIDIA-H100-SLICE"}
    keys = {slice_key(leaf, slice_types) for leaf in leaves_of(forest)}
    assert len(keys) == 2


def example_pods():
    """(file, metadata, container) of every pod the examples make."""
    out = []
    for name in EXAMPLES:
        for doc in load_all(os.path.join(DEPLOY, "examples", name)):
            for metadata, spec in pod_specs(doc):
                out.append((name, metadata, spec["containers"][0]))
    return out


@pytest.mark.parametrize("name", sorted({
    "mnist-fractional.yaml", "serve-fractional.yaml", "mixed-priority.yaml",
    "cifar10-gang-job.yaml", "distributed-ddp.yaml",
    "multislice-gang-job.yaml"}))
def test_example_twins_jax_labels(name):
    """Each twin keeps the labels of JAX's manifest of the same name,
    apart from the model selector, which names the H100."""
    def labels(root):
        return [{str(k): str(v) for k, v in (m.get("labels") or {}).items()}
                for doc in load_all(os.path.join(root, name))
                for m, _ in pod_specs(doc)]

    port, jax = labels(os.path.join(DEPLOY, "examples")), labels(
        os.path.join(REPO, "examples"))
    for ours, theirs in zip(port, jax, strict=True):
        if constants.POD_GPU_MODEL in theirs:
            assert ours.pop(constants.POD_GPU_MODEL) == H100
            theirs.pop(constants.POD_GPU_MODEL)
        assert ours == theirs


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_command_runs_a_root_twin(name):
    """The container runs a root script of the port with arguments its
    parser accepts."""
    for _, _, container in [p for p in example_pods() if p[0] == name]:
        assert container["image"] == IMAGE
        command = container["command"]
        assert command[0] == "python" and command[1].endswith("_torch.py")
        assert os.path.isfile(os.path.join(REPO, command[1]))
        module = importlib.import_module(command[1][:-3])
        module.parse_args(command[2:])


def test_example_pods_place_on_h100s():
    """Every example pod, each gang copy included, places through the
    port's scheduler (shadow bind) on a node of eight H100 cards; each
    fractional pod preloads the file hook-init writes and sees a card of
    the inventory.  Each file is judged against an empty node."""
    manifests = example_pods()
    assert len(manifests) >= 7
    topology = load_config(
        path=os.path.join(DEPLOY, "config", "kubeshare-config-h100-node.yaml"))
    node = "h100-node-0"
    chips = [ChipInfo(f"GPU-{i:08x}", 80 << 30, H100, i) for i in range(8)]
    uuids = {c.uuid for c in chips}
    [daemon] = by_kind("node-daemon.yaml", "DaemonSet")
    hook_file = daemon["spec"]["template"]["spec"]["initContainers"][0][
        "command"][-1].split()[-1]
    cluster = FakeCluster()
    cluster.add_node(Node(node, {constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(0.0)
    plugin = KubeShareScheduler(topology, cluster,
                                lambda n: chips if n == node else [],
                                args=SchedulerArgs(bind_mode="shadow"),
                                clock=clock)
    engine = SchedulerEngine(plugin, cluster, clock)
    fractional = 0
    for i, (name, metadata, container) in enumerate(manifests):
        labels = {str(k): str(v) for k, v in metadata["labels"].items()}
        status = parse_pod_labels(Pod(name=f"x{i}", labels=labels))
        assert status.limit >= status.request > 0, name
        copies = status.min_available if status.pod_group else 1
        if status.pod_group:
            labels[constants.POD_GROUP_NAME] = f"g{i}"
        names = [f"{name[:-5]}-{i}-{j}" for j in range(copies)]
        for pod_name in names:
            cluster.create_pod(Pod(
                name=pod_name, labels=labels,
                scheduler_name=constants.SCHEDULER_NAME,
                containers=[Container(name=container["name"])]))
        engine.run_until_idle()
        for pod_name in names:
            pod = cluster.get_pod("default", pod_name)
            assert pod.is_bound() and pod.node_name == node, (name, pod_name)
            env = pod.containers[0].env
            visible = env[constants.ENV_VISIBLE_DEVICES].split(",")
            assert set(visible) <= uuids and len(visible) == \
                max(1, int(status.request)), (name, env)
            if status.request <= 1:
                fractional += 1
                assert env[constants.ENV_SHIM_PRELOAD] == hook_file
                assert constants.LIBRARY_PATH in \
                    pod.containers[0].volume_mounts
            else:
                assert constants.ENV_SHIM_PRELOAD not in env
        for pod_name in names:
            cluster.delete_pod("default", pod_name)
    assert fractional >= 5


def dockerfile_copies():
    sys.path.insert(0, DEPLOY)
    try:
        import image_check
    finally:
        sys.path.remove(DEPLOY)
    with open(DOCKERFILE) as f:
        return image_check.copied_paths(f.read())


def test_dockerfile_builds_the_port_and_publishes_the_hook():
    """The hook lands where hook-init copies it from, the port's package
    and twins are copied and the JAX package is not, the base is a
    -devel image (nvcc), and tokend / pmgr go onto find_binary's path."""
    with open(DOCKERFILE) as f:
        text = f.read()
    [daemon] = by_kind("node-daemon.yaml", "DaemonSet")
    source = daemon["spec"]["template"]["spec"]["initContainers"][0][
        "command"][-1].split()[-2]
    assert source == "/opt/cudahook/libcudahook.so.1"
    assert "hook_path()" in text and source in text.replace("\\\n", " ").split()
    copies = dockerfile_copies()
    assert "kubeshare_tpu_torch/" in copies and "native/" in copies
    assert "deploy/cuda/config/" in copies
    assert not [c for c in copies if c.rstrip("/") == "kubeshare_tpu"
                or c.startswith("examples")]
    assert "COPY kubeshare_tpu/" not in text
    for pod in example_pods():
        assert pod[2]["command"][1] in copies
    assert "_build.build_all()" in text
    assert "ARG BASE_IMAGE=pytorch/pytorch:" in text
    assert text.split("ARG BASE_IMAGE=")[1].split()[0].endswith("-devel")
    assert "/usr/local/bin" in text
    assert "tpushare-tokend" in text and "tpushare-pmgr" in text


def test_make_image_check_torch():
    out = subprocess.run(["make", "image-check-torch"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "image-check-torch: ok" in out.stdout
    assert "6 subcommands" in out.stdout


def test_make_images_torch_reports_missing_runtime():
    """Without docker or podman, `make images-torch` fails loudly with
    the build command: it never pretends an image was built."""
    out = subprocess.run(["make", "images-torch"], cwd=REPO,
                         env=dict(os.environ, DOCKER=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "neither docker nor podman found" in out.stderr
    assert "docker build -f docker/Dockerfile.torch" in out.stderr


def test_e2e_kind_runs_to_kubectl_boundary():
    out = subprocess.run(["sh", os.path.join(DEPLOY, "e2e-kind.sh")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_yaml = len(MANIFESTS) + len(TOPOLOGIES) + len(EXAMPLES)
    assert f"manifests parse: ok ({n_yaml} files)" in out.stdout
    assert "fake-cluster placement: ok (shadow bind" in out.stdout
    assert ("SKIP" in out.stdout) or ("PASS" in out.stdout)


# ---- the scheduler's inventory: the federate endpoint against a Service ----

def collector_lines(node, uuids):
    return [f'{constants.METRIC_CAPACITY}{{node="{node}",uuid="{u}",'
            f'model="{H100}",memory="85520809984",index="{i}"}} 1'
            for i, u in enumerate(uuids)]


def federate_text():
    """Two nodes' series as Prometheus's /federate returns them: a TYPE
    line, the target's labels beside the exporter's (honorLabels), a
    millisecond timestamp on every sample, and another metric."""
    lines = [f"# TYPE {constants.METRIC_CAPACITY} untyped"]
    for n, node in enumerate(("h100-node-0", "h100-node-1")):
        for line in collector_lines(node, [f"GPU-{n}{i}" for i in range(2)]):
            head, value = line.rsplit(" ", 1)
            lines.append(
                head[:-1] + f',instance="10.0.0.{n}:9004",job='
                f'"kubeshare-collector",namespace="kube-system",pod='
                f'"kubeshare-node-daemon-{n}",endpoint="metrics"}} '
                f"{value} 1760800000{n}00")
    lines.append('up{job="kubeshare-collector"} 1 1760800000000')
    return "\n".join(lines) + "\n"


@pytest.fixture
def serve_texts():
    """An HTTP server on 127.0.0.1 answering each GET with the next of
    the given texts (the last one over and over)."""
    servers = []

    def start(texts):
        texts = list(texts)

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = (texts.pop(0) if len(texts) > 1 else texts[0]).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_port}"

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def test_prom_inventory_reads_every_node_from_federate(serve_texts):
    url = serve_texts([federate_text()])
    inventory = PromInventory(
        [f"{url}/federate?match%5B%5D={constants.METRIC_CAPACITY}"], ttl=0)
    for n, node in enumerate(("h100-node-0", "h100-node-1")):
        chips = inventory(node)
        assert [c.uuid for c in chips] == [f"GPU-{n}0", f"GPU-{n}1"]
        assert {c.model for c in chips} == {H100}
        assert [c.index for c in chips] == [0, 1]
        assert {c.memory for c in chips} == {85520809984}


def test_a_service_url_sees_one_node_a_scrape(serve_texts):
    """The fault the federate URL repairs: a ClusterIP Service routes
    each scrape to one collector, and each refresh replaces the whole
    cache with that node's chips, so the other node's cards vanish."""
    texts = ["\n".join(collector_lines(node, [f"GPU-{node}"])) + "\n"
             for node in ("h100-node-0", "h100-node-1")]
    inventory = PromInventory([serve_texts(texts)], ttl=0)
    assert [c.uuid for c in inventory("h100-node-0")] == ["GPU-h100-node-0"]
    assert inventory("h100-node-0") == []  # the next scrape hit node 1
    assert [c.uuid for c in inventory("h100-node-1")] == ["GPU-h100-node-1"]


def test_chip_smoke_holds_the_mnist_manifest():
    """chip_smoke.py's placement phase runs the MNIST manifest's pod from
    constants (the card's machine has no PyYAML): they equal the file."""
    sys.path.insert(0, REPO)
    import chip_smoke

    [doc] = load_all(os.path.join(REPO, chip_smoke.MNIST_MANIFEST))
    assert os.path.dirname(chip_smoke.MNIST_MANIFEST) == "deploy/cuda/examples"
    assert doc["metadata"]["name"] == chip_smoke.MNIST_MANIFEST_POD
    assert doc["metadata"]["labels"] == chip_smoke.MNIST_MANIFEST_LABELS
    [container] = doc["spec"]["containers"]
    assert container["name"] == chip_smoke.MNIST_MANIFEST_CONTAINER
    assert tuple(container["command"]) == chip_smoke.MNIST_MANIFEST_COMMAND
    module = importlib.import_module(container["command"][1][:-3])
    args = module.parse_args(
        ["--steps", str(chip_smoke.MNIST_MANIFEST_STEPS)])
    assert args.steps == chip_smoke.MNIST_MANIFEST_STEPS
