"""The port's cluster API (cluster/api.py, cluster/fake.py, cluster/k8s.py)
against the JAX package's (tests/test_k8s_adapter.py): the Kubernetes
adapter's translation and manifests equal JAX's on the same objects, its
client paths run against tests/fake_kubernetes.py (the kubernetes package
is not installed, so the adapter is import-gated as JAX's is), and the
in-memory FakeCluster dispatches the same events and keeps the same
state as JAX's under the same calls.  The storm cases drive the port's
scheduler over the adapter."""

import dataclasses
import threading
import time
import types

import pytest

import fake_kubernetes
from kubeshare_tpu.cluster import api as jax_api
from kubeshare_tpu.cluster import k8s as jax_k8s
from kubeshare_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.cell import load_config
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cluster import api as port_api
from kubeshare_tpu_torch.cluster import k8s as port_k8s
from kubeshare_tpu_torch.cluster.api import ClusterAPI, Container, Pod, PodPhase
from kubeshare_tpu_torch.cluster.fake import FakeCluster as PortFakeCluster
from kubeshare_tpu_torch.scheduler import (KubeShareScheduler, SchedulerArgs,
                                           SchedulerEngine)
from kubeshare_tpu_torch.scheduler.leader import LeaderElector


def attrdict(**kw):
    return types.SimpleNamespace(**kw)


def k8s_pod(name="p", namespace="ns", labels=None, annotations=None,
            node_name="", phase="Pending", env=None,
            scheduler="kubeshare-scheduler", mounts=("/kubeshare/library",),
            containers=1, stamp=None):
    made = [attrdict(
        name=f"c{i}",
        env=[attrdict(name=k, value=v) for k, v in (env or {}).items()]
        + [attrdict(name="EMPTY", value=None)],
        volume_mounts=[attrdict(mount_path=m) for m in mounts],
    ) for i in range(containers)]
    return attrdict(
        metadata=attrdict(
            name=name, namespace=namespace, uid="uid-1",
            labels=labels or {}, annotations=annotations or {},
            creation_timestamp=stamp,
        ),
        spec=attrdict(
            scheduler_name=scheduler, node_name=node_name,
            containers=made, volumes=[attrdict(name="v0")],
        ),
        status=attrdict(phase=phase),
    )


def k8s_node(name, labels=None, unschedulable=None, ready="True"):
    return attrdict(
        metadata=attrdict(name=name, labels=labels),
        spec=attrdict(unschedulable=unschedulable),
        status=attrdict(conditions=[attrdict(type="Ready", status=ready)]),
    )


class _Stamp:
    def timestamp(self):
        return 1700000000.5


POD_OBJECTS = {
    "cuda_pod": k8s_pod(
        labels={"sharedgpu/gpu_request": "0.5", "sharedgpu/gpu_limit": "1.0"},
        annotations={"sharedgpu/gpu_uuid": "GPU-0f3a"}, node_name="gpu-a",
        phase="Running", env={"NVIDIA_VISIBLE_DEVICES": "GPU-0f3a",
                              "LD_PRELOAD": constants.SHIM_LIBRARY,
                              "POD_MANAGER_PORT": "50051"}),
    "defaults": k8s_pod(scheduler=None, phase="Bogus", containers=0,
                        namespace=None),
    "two_containers": k8s_pod(containers=2, phase="Failed", mounts=(),
                              stamp=_Stamp()),
    "succeeded": k8s_pod(phase="Succeeded", env={"A": "1"}),
}
NODE_OBJECTS = {
    "ready": k8s_node("n1", {"SharedGPU": "true"}),
    "cordoned": k8s_node("n2", {}, unschedulable=True),
    "not_ready": k8s_node("n3", None, ready="False"),
}


@pytest.mark.parametrize("name", sorted(POD_OBJECTS))
def test_pod_translation_matches(name):
    jax_pod = jax_k8s._to_pod(POD_OBJECTS[name])
    port_pod = port_k8s._to_pod(POD_OBJECTS[name])
    assert dataclasses.asdict(port_pod) == dataclasses.asdict(jax_pod)
    assert port_pod.key == jax_pod.key
    # tests/test_k8s_adapter.py's round trip, on the port
    if name == "cuda_pod":
        assert port_pod.key == "ns/p" and port_pod.node_name == "gpu-a"
        assert port_pod.phase == PodPhase.RUNNING
        assert port_pod.get_env("POD_MANAGER_PORT") == "50051"
        assert port_pod.containers[0].volume_mounts == ["/kubeshare/library"]
    if name == "defaults":
        assert port_pod.scheduler_name == "default-scheduler"
        assert port_pod.phase == PodPhase.PENDING
        assert len(port_pod.containers) == 1


@pytest.mark.parametrize("name", sorted(NODE_OBJECTS))
def test_node_translation_matches(name):
    jax_node = jax_k8s._to_node(NODE_OBJECTS[name])
    port_node = port_k8s._to_node(NODE_OBJECTS[name])
    assert dataclasses.asdict(port_node) == dataclasses.asdict(jax_node)
    assert port_node.is_healthy() == (name == "ready")


def _pod_pair(**kwargs):
    out = []
    for api in (jax_api, port_api):
        kw = dict(kwargs)
        kw["containers"] = [api.Container(**c) for c in kw.get("containers", [{}])]
        out.append(api.Pod(**kw))
    return out


MANIFESTS = {
    "placed": dict(namespace="ns", name="p",
                   labels={"sharedgpu/gpu_request": "0.5"},
                   annotations={"sharedgpu/gpu_uuid": "GPU-0f3a"},
                   scheduler_name="kubeshare-scheduler", node_name="gpu-a",
                   containers=[{"name": "c", "env": {"POD_NAME": "ns/p"},
                                "volume_mounts": ["/kubeshare/library"]}],
                   volumes=["/kubeshare/library"]),
    "pending": dict(namespace="default", name="q",
                    scheduler_name="kubeshare-scheduler"),
}


LIBRARY_VOLUME = {"name": "kubeshare-library",
                  "hostPath": {"path": "/kubeshare/library",
                               "type": "DirectoryOrCreate"}}
LIBRARY_MOUNT = {"name": "kubeshare-library", "mountPath": "/kubeshare/library"}


def _holds(small, big):
    """Every key of ``small`` is in ``big`` with a value that holds the
    small one's: dicts key by key, lists item by item."""
    if isinstance(small, dict):
        return isinstance(big, dict) and all(
            k in big and _holds(v, big[k]) for k, v in small.items())
    if isinstance(small, list):
        return isinstance(big, list) and len(small) == len(big) and all(
            _holds(a, b) for a, b in zip(small, big))
    return small == big


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_pod_manifest_matches(name):
    """A pod built in memory renders JAX's manifest, and a placed one
    (the library mounted) JAX's plus the library as a valid hostPath
    volume and its mount: JAX's adapter writes neither, so its pod would
    run without the hook (a bare path is no volume name)."""
    jax_pod, port_pod = _pod_pair(**MANIFESTS[name])
    port = port_k8s.K8sCluster._pod_manifest(None, port_pod)
    jax = jax_k8s.K8sCluster._pod_manifest(None, jax_pod)
    if name == "pending":
        assert port == jax
    if name == "placed":
        assert port != jax and _holds(jax, port)
        assert port["spec"]["volumes"] == [LIBRARY_VOLUME]
        assert port["spec"]["containers"][0]["volumeMounts"] == [LIBRARY_MOUNT]
        assert "volumes" not in jax["spec"]
        assert "volumeMounts" not in jax["spec"]["containers"][0]
        assert port["spec"]["schedulerName"] == "kubeshare-scheduler"
        assert port["spec"]["nodeName"] == "gpu-a"
        assert {"name": "POD_NAME", "value": "ns/p"} in \
            port["spec"]["containers"][0]["env"]


class _Stamped(_Stamp):
    """A server timestamp, as the client gives it (a datetime)."""

    def isoformat(self):
        return "2026-01-01T00:00:00+00:00"


def source_pod(name="src", namespace="ns", labels=None):
    """A pod as the API server returns it: a Job's pod with an image,
    command, args, resources, ports, plain and downward-API env, a
    configMap volume and its mount, a sidecar, and the metadata the
    server sets."""
    def container(cname, image, env):
        return attrdict(
            name=cname, image=image, command=["python", "train.py"],
            args=["--steps", "5"], working_dir="/work",
            resources=attrdict(limits={"cpu": "2", "memory": "4Gi"},
                               requests={"cpu": "1"}),
            ports=[attrdict(container_port=8080, name="http",
                            protocol="TCP")],
            env=[attrdict(name=k, value=v, value_from=None)
                 for k, v in env.items()],
            volume_mounts=[attrdict(name="conf", mount_path="/etc/conf",
                                    read_only=True)])

    return attrdict(
        metadata=attrdict(
            name=name, namespace=namespace, uid="uid-src",
            resource_version="7", creation_timestamp=_Stamped(),
            managed_fields=[attrdict(manager="kubectl")],
            labels=dict(labels or {}), annotations={"team": "ml"},
            owner_references=[attrdict(api_version="batch/v1", kind="Job",
                                       name="job-1", uid="uid-job",
                                       controller=True)]),
        spec=attrdict(
            scheduler_name="kubeshare-scheduler", node_name=None,
            restart_policy="Never", service_account_name="trainer",
            containers=[
                container("train", "img:1", {"MODE": "train",
                                             "NVIDIA_VISIBLE_DEVICES": "all"}),
                container("sidecar", "img:side", {"ROLE": "log"})],
            volumes=[attrdict(name="conf",
                              config_map=attrdict(name="train-conf"))]),
        status=attrdict(phase="Pending", host_ip=None))


def test_shadow_bind_keeps_the_source_spec(fake_k8s):
    """The shadow bind through the adapter: the create body carries the
    source pod's image, command, args, resources, ports, other env,
    volumes, mounts, owner references and service account, none of the
    server's metadata, the injected env (replacing the source's
    NVIDIA_VISIBLE_DEVICES), the node, and the library as a hostPath
    volume under a valid name, mounted in both containers."""
    import copy
    import re

    cluster, store = fake_k8s
    store.pods[("ns", "src")] = source_pod(labels={
        constants.POD_GPU_REQUEST: "0.5", constants.POD_GPU_LIMIT: "1.0"})
    engine = _scheduler_over(cluster, store, bind_mode="shadow")
    bodies = []
    create = cluster.core.create_namespaced_pod

    def spy(namespace, body):
        bodies.append(copy.deepcopy(body))
        return create(namespace, body)

    cluster.core.create_namespaced_pod = spy
    result = engine.run_once()
    assert result is not None and result.result == "bound", result
    [body] = bodies
    meta, spec = body["metadata"], body["spec"]
    assert meta["ownerReferences"] == [{
        "apiVersion": "batch/v1", "kind": "Job", "name": "job-1",
        "uid": "uid-job", "controller": True}]
    assert not {"uid", "resourceVersion", "creationTimestamp",
                "managedFields"} & set(meta)
    assert meta["annotations"]["team"] == "ml"
    assert meta["annotations"][constants.POD_GPU_UUID].startswith("GPU-")
    assert spec["nodeName"] == "node-1"
    assert spec["restartPolicy"] == "Never"
    assert spec["serviceAccountName"] == "trainer"
    assert spec["volumes"] == [
        {"name": "conf", "configMap": {"name": "train-conf"}}, LIBRARY_VOLUME]
    for volume in spec["volumes"]:
        assert re.fullmatch(r"[a-z0-9]([-a-z0-9]{0,61}[a-z0-9])?",
                            volume["name"]), volume
    train, sidecar = spec["containers"]
    for c, image in ((train, "img:1"), (sidecar, "img:side")):
        assert c["image"] == image
        assert c["command"] == ["python", "train.py"]
        assert c["args"] == ["--steps", "5"] and c["workingDir"] == "/work"
        assert c["resources"] == {"limits": {"cpu": "2", "memory": "4Gi"},
                                  "requests": {"cpu": "1"}}
        assert c["ports"] == [{"containerPort": 8080, "name": "http",
                               "protocol": "TCP"}]
        assert c["volumeMounts"] == [
            {"name": "conf", "mountPath": "/etc/conf", "readOnly": True},
            LIBRARY_MOUNT]
        env = {e["name"]: e["value"] for e in c["env"]}
        assert len(env) == len(c["env"])  # no name twice
        assert env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY
        assert env[constants.ENV_VISIBLE_DEVICES] == \
            meta["annotations"][constants.POD_GPU_UUID]
        assert env[constants.ENV_POD_NAME] == "ns/src"
        assert int(env[constants.ENV_POD_MANAGER_PORT]) == \
            int(meta["annotations"][constants.POD_MANAGER_PORT])
    assert {"name": "MODE", "value": "train"} in train["env"]
    assert {"name": "ROLE", "value": "log"} in sidecar["env"]
    # the recreated pod is the one the store now holds, bound
    assert store.pods[("ns", "src")].spec.node_name == "node-1"


def test_jax_adapter_drops_the_source_spec():
    """JAX's adapter on the same input, placed as the plugin places it:
    its manifest has no image, command, resources, volumes or owner
    references (the API server refuses a container without an image),
    where the port's keeps them and keeps a downward-API env entry as
    written."""
    obj = source_pod()
    obj.spec.containers[0].env.append(attrdict(
        name="NODE", value=None,
        value_from=attrdict(field_ref=attrdict(field_path="spec.nodeName"))))
    rendered = {}
    for package in (jax_k8s, port_k8s):
        pod = package._to_pod(obj)
        pod.node_name = "node-1"
        for container in pod.containers:
            container.env["POD_NAME"] = "ns/src"
            container.volume_mounts.append(constants.LIBRARY_PATH)
        pod.volumes.append(constants.LIBRARY_PATH)
        rendered[package] = package.K8sCluster._pod_manifest(None, pod)
    jax, port = rendered[jax_k8s], rendered[port_k8s]
    assert set(jax["spec"]["containers"][0]) == {"name", "env"}
    assert "volumes" not in jax["spec"]
    assert "ownerReferences" not in jax["metadata"]
    assert _holds(jax["metadata"], port["metadata"])
    train = port["spec"]["containers"][0]
    assert train["image"] == "img:1" and train["command"] == ["python",
                                                              "train.py"]
    assert port["spec"]["volumes"][-1] == LIBRARY_VOLUME
    assert port["metadata"]["ownerReferences"][0]["name"] == "job-1"
    assert {"name": "NODE", "valueFrom": {"fieldRef": {
        "fieldPath": "spec.nodeName"}}} in train["env"]
    assert {"name": "NODE", "value": ""} in \
        jax["spec"]["containers"][0]["env"]


def test_manifest_of_uses_the_clients_attribute_map():
    """The client's models name their JSON keys in ``attribute_map``
    (``host_pid`` is ``hostPID``, not ``hostPid``); plain objects are
    camel-cased; timestamps become ISO text, unset fields vanish."""

    class V1Spec:
        attribute_map = {"host_pid": "hostPID", "node_name": "nodeName"}

        def __init__(self):
            self.host_pid = True
            self.node_name = None

    assert port_k8s._manifest_of(V1Spec()) == {"hostPID": True}
    assert port_k8s._manifest_of(attrdict(
        mount_path="/x", sub_path=None, stamp=_Stamped(),
        items=[attrdict(read_only=False)], labels={"a_b": "c"})) == {
        "mountPath": "/x", "stamp": "2026-01-01T00:00:00+00:00",
        "items": [{"readOnly": False}], "labels": {"a_b": "c"}}


# ---- the in-memory cluster ---------------------------------------------------

def _fake_cluster_run(api, fake_cls):
    """The same calls on one package's FakeCluster; returns its events,
    listings and leases."""
    cluster = fake_cls()
    events = []
    cluster.add_node(api.Node(name="n0"))
    cluster.add_pod_handler(lambda e, p: events.append(("pod", e, p.key, p.node_name,
                                                        p.phase.value)))
    cluster.add_node_handler(lambda e, n: events.append(("node", e, n.name,
                                                         n.is_healthy())))
    for i in range(3):
        cluster.create_pod(api.Pod(namespace="ns" if i else "other", name=f"p{i}",
                                   labels={"app": "x" if i % 2 else "y"},
                                   scheduler_name="kubeshare-scheduler"))
    try:
        cluster.create_pod(api.Pod(namespace="ns", name="p1"))
    except ValueError as e:
        events.append(("error", str(e)))
    cluster.bind_pod("ns", "p1", "n0")
    cluster.set_pod_phase("ns", "p2", api.PodPhase.SUCCEEDED)
    updated = cluster.get_pod("ns", "p1").copy()
    updated.annotations["k"] = "v"
    cluster.update_pod(updated)
    try:
        cluster.update_pod(api.Pod(namespace="ns", name="missing"))
    except ValueError as e:
        events.append(("error", str(e)))
    cluster.delete_pod("ns", "p2")
    cluster.delete_pod("ns", "p2")
    cluster.update_node(api.Node(name="n0", ready=False))
    cluster.add_node(api.Node(name="n1", unschedulable=True))
    cluster.delete_node("n0")
    cluster.delete_node("n0")
    listings = [
        sorted(p.key for p in cluster.list_pods()),
        sorted(p.key for p in cluster.list_pods(namespace="ns")),
        sorted(p.key for p in cluster.list_pods(label_selector={"app": "y"})),
        sorted(p.key for p in cluster.list_pods(scheduler_name="nope")),
        sorted(p.key for p in cluster.list_pods(phase=api.PodPhase.PENDING)),
        sorted(n.name for n in cluster.list_nodes()),
        cluster.get_pod("ns", "p1").annotations,
        cluster.get_pod("ns", "gone"),
    ]
    leases = [cluster.lease_tryhold("l", who, 10.0, now)
              for who, now in (("a", 0.0), ("b", 5.0), ("a", 9.0), ("b", 18.0),
                               ("b", 100.0), ("a", 101.0))]
    return events, listings, leases


def test_fake_cluster_matches():
    assert _fake_cluster_run(port_api, PortFakeCluster) == \
        _fake_cluster_run(jax_api, JaxFakeCluster)


def test_clock_and_uids():
    clock = port_api.FakeClock(5.0)
    clock.advance(2.5)
    assert clock.now() == 7.5
    assert abs(port_api.Clock().now() - time.time()) < 5
    a, b = port_api.next_uid("pod"), port_api.next_uid("pod")
    assert a.startswith("pod-") and a != b
    assert [m.value for m in port_api.PodPhase] == \
        [m.value for m in jax_api.PodPhase]
    pod = Pod(containers=[Container(env={"X": "1"}), Container(env={"Y": "2"})])
    twin = pod.copy()
    twin.containers[1].env["Y"] = "3"
    assert pod.get_env("Y") == "2" and twin.get_env("Y") == "3"
    assert pod.get_env("Z") is None


# ---- the Kubernetes adapter against the API fake ---------------------------

@pytest.fixture
def fake_k8s(monkeypatch):
    store = fake_kubernetes.install(monkeypatch)
    return port_k8s.K8sCluster(), store


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_adapter_needs_the_kubernetes_package():
    # without the fake installed, the gate raises as JAX's does
    with pytest.raises(RuntimeError, match="kubernetes package is required"):
        port_k8s.K8sCluster()


def test_crud_round_trip(fake_k8s):
    cluster, store = fake_k8s
    pod = Pod(namespace="ns", name="p1",
              labels={"sharedgpu/gpu_request": "0.5"},
              scheduler_name="kubeshare-scheduler",
              containers=[Container(env={"POD_NAME": "ns/p1"})])
    cluster.create_pod(pod)
    listed = cluster.list_pods(namespace="ns")
    assert [p.name for p in listed] == ["p1"]
    assert listed[0].labels["sharedgpu/gpu_request"] == "0.5"
    assert listed[0].containers[0].env["POD_NAME"] == "ns/p1"
    cluster.delete_pod("ns", "p1")
    assert cluster.get_pod("ns", "p1") is None
    cluster.delete_pod("ns", "p1")  # a 404 is swallowed


def test_bind_subresource(fake_k8s):
    cluster, store = fake_k8s
    store.put_pod("ns", "p1")
    cluster.bind_pod("ns", "p1", "node-7")
    assert store.bindings == [("ns", "p1", "node-7")]
    assert cluster.get_pod("ns", "p1").node_name == "node-7"


def test_update_pod_retries_conflict(fake_k8s):
    cluster, store = fake_k8s
    store.put_pod("ns", "p1", annotations={"old": "1"})
    store.patch_conflicts_remaining = 2
    pod = cluster.get_pod("ns", "p1")
    pod.annotations["sharedgpu/cell_id"] = "rack/0/3"
    cluster.update_pod(pod)
    assert store.patch_calls == 3
    obj = store.pods[("ns", "p1")]
    assert obj.metadata.annotations["sharedgpu/cell_id"] == "rack/0/3"
    assert obj.metadata.annotations["old"] == "1"


def test_update_pod_conflict_exhaustion_raises(fake_k8s):
    cluster, store = fake_k8s
    store.put_pod("ns", "p1")
    store.patch_conflicts_remaining = 99
    with pytest.raises(fake_kubernetes.ApiException) as exc:
        cluster.update_pod(cluster.get_pod("ns", "p1"))
    assert exc.value.status == 409 and store.patch_calls == 4


def test_update_pod_binds_when_node_assigned(fake_k8s):
    cluster, store = fake_k8s
    store.put_pod("ns", "p1")
    pod = cluster.get_pod("ns", "p1")
    pod.node_name = "node-3"
    cluster.update_pod(pod)
    assert store.bindings == [("ns", "p1", "node-3")]


def test_watch_reconnect_resumes_from_resource_version(fake_k8s):
    cluster, store = fake_k8s
    events, lock = [], threading.Lock()

    def handler(event_type, pod):
        with lock:
            events.append((event_type, pod.name))

    cluster.add_pod_handler(handler)
    obj1 = store.put_pod("ns", "w1")
    store.emit("ADDED", obj1)
    assert _wait_for(lambda: ("add", "w1") in events)
    store.emit_error(ConnectionResetError("stream dropped"))
    obj2 = store.put_pod("ns", "w2")
    store.emit("MODIFIED", obj2)
    assert _wait_for(lambda: ("update", "w2") in events)
    assert len(store.watch_stream_kwargs) >= 2
    assert store.watch_stream_kwargs[-1].get("resource_version") == \
        obj1.metadata.resource_version


def test_watch_410_gone_resyncs_from_list(fake_k8s):
    cluster, store = fake_k8s
    events, lock = [], threading.Lock()

    def handler(event_type, pod):
        with lock:
            events.append((event_type, pod.name))

    cluster.add_pod_handler(handler)
    obj1 = store.put_pod("ns", "old1")
    store.emit("ADDED", obj1)
    assert _wait_for(lambda: ("add", "old1") in events)
    store.put_pod("ns", "missed")
    del store.pods[("ns", "old1")]
    store.emit_error(fake_kubernetes.ApiException(410, "Gone"))
    assert _wait_for(lambda: ("update", "missed") in events)
    assert _wait_for(lambda: ("delete", "old1") in events)
    assert _wait_for(lambda: store.watch_stream_kwargs and
                     store.watch_stream_kwargs[-1].get("resource_version")
                     == str(store.resource_version))


def test_watch_stream_end_reconnects(fake_k8s):
    cluster, store = fake_k8s
    events = []
    cluster.add_pod_handler(lambda e, p: events.append((e, p.name)))
    store.end_stream()
    obj = store.put_pod("ns", "after-end")
    store.emit("ADDED", obj)
    assert _wait_for(lambda: ("add", "after-end") in events)


def test_lease_arbitrates_two_instances(fake_k8s):
    cluster_a, store = fake_k8s
    cluster_b = port_k8s.K8sCluster()
    assert cluster_a.lease_tryhold("sched", "a", 1.0, 0.0) == "a"
    assert cluster_b.lease_tryhold("sched", "b", 1.0, 0.0) == "a"
    assert cluster_a.lease_tryhold("sched", "a", 1.0, 0.0) == "a"
    time.sleep(1.1)
    assert cluster_b.lease_tryhold("sched", "b", 1.0, 0.0) == "b"
    assert cluster_a.lease_tryhold("sched", "a", 1.0, 0.0) == "b"
    assert store.leases[("kube-system", "sched")].spec.holder_identity == "b"


def test_elector_degrades_without_lease_support():
    elector = LeaderElector(ClusterAPI(), "solo")
    assert elector.is_leader() and elector.is_leader()


ONE_NODE = """
cellTypes:
  4-H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 4
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: 4-H100-NODE
  cellId: node-1
"""


def _scheduler_over(cluster, store, bind_mode="patch"):
    store.put_node("node-1", labels={constants.NODE_LABEL_FILTER: "true"})
    inventory = {"node-1": [ChipInfo(f"GPU-{i}", 80 << 30,
                                     "NVIDIA-H100-80GB-HBM3", i)
                            for i in range(4)]}
    plugin = KubeShareScheduler(
        topology=load_config(text=ONE_NODE), cluster=cluster,
        inventory=lambda node: inventory.get(node, []),
        args=SchedulerArgs(bind_mode=bind_mode))
    return SchedulerEngine(plugin, cluster)


def test_pods_bind_exactly_once_through_a_410_storm(fake_k8s):
    cluster, store = fake_k8s
    engine = _scheduler_over(cluster, store)
    labels = {constants.POD_GPU_LIMIT: "1.0", constants.POD_GPU_REQUEST: "0.5"}
    total = 6
    for i in range(total):
        obj = store.put_pod("ns", f"w{i}", labels=dict(labels))
        store.emit("ADDED", obj)
        if i % 2 == 0:
            store.emit_error(fake_kubernetes.ApiException(410, "Gone"))
        assert _wait_for(lambda: len(engine.pending_pods()) >= 1), i
        result = engine.run_once()
        assert result is not None and result.result == "bound", result
        store.emit_error(fake_kubernetes.ApiException(410, "Gone"))
    deadline = time.time() + 10.0
    while time.time() < deadline and len(store.bindings) < total:
        engine.run_once()
        time.sleep(0.02)
    assert sorted(n for _, n, _ in store.bindings) == [f"w{i}" for i in range(total)]
    # the patch carried the placement (env on a live pod is immutable in
    # Kubernetes: the adapter patches metadata, as JAX's does)
    annotations = store.pods[("ns", "w0")].metadata.annotations
    assert annotations[constants.POD_GPU_UUID].startswith("GPU-")
    assert int(annotations[constants.POD_MANAGER_PORT]) > \
        constants.POD_MANAGER_PORT_START


def test_transient_apiserver_error_does_not_crash_cycle(fake_k8s):
    cluster, store = fake_k8s
    engine = _scheduler_over(cluster, store)
    obj = store.put_pod("ns", "w0", labels={constants.POD_GPU_LIMIT: "1.0",
                                            constants.POD_GPU_REQUEST: "0.5"})
    store.emit("ADDED", obj)
    assert _wait_for(lambda: bool(engine.pending_pods()), 3.0)
    real_read = cluster.core.read_namespaced_pod
    cluster.core.read_namespaced_pod = lambda *a, **k: (_ for _ in ()).throw(
        fake_kubernetes.ApiException(500, "boom"))
    result = engine.run_once()
    assert result is not None and result.result == "error"
    cluster.core.read_namespaced_pod = real_read
    result = engine.run_once()
    assert result is not None and result.result == "bound"
