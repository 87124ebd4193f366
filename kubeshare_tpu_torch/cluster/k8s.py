"""Kubernetes cluster adapter.

The port's own copy of kubeshare_tpu/cluster/k8s.py (the port imports nothing
of the JAX package).

Maps the ClusterAPI surface onto the official ``kubernetes`` Python client
(informer-style watches with resourceVersion resume, 410-Gone resync, and
conflict-retried patches).  The package is not bundled in this development
image, so the adapter is import-gated: in-repo tests drive it against the
vendored API fake (`tests/fake_kubernetes.py`, `tests/test_k8s_adapter.py`),
and `deploy/e2e-kind.sh` drives the same code path against a real kind API
server on hosts with a container runtime.

Only the fields the framework reads/writes are translated (see
cluster.api.Pod/Node); everything else round-trips untouched because
updates are applied as strategic-merge patches rather than full replaces.

Unlike JAX's adapter, a pod read from the API server keeps its whole
manifest (``Pod.source``), and a pod created from it writes that
manifest back with the modelled fields on top.  The shadow bind deletes
a pod and creates its placed copy, and a copy of the modelled fields
alone has no image, command or volumes, which the API server refuses;
the library the scheduler mounts becomes a ``hostPath`` volume of its
own (``LIBRARY_VOLUME``), as the reference's deep copy adds it (ref
pod.go:402-476).
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional

from .. import constants
from .api import ClusterAPI, Container, EventHandler, Node, Pod, PodPhase


def _require_client():
    try:
        import kubernetes  # noqa: F401
        from kubernetes import client, config, watch
    except ImportError as e:  # pragma: no cover - gated dependency
        raise RuntimeError(
            "the kubernetes package is required for --cluster k8s"
        ) from e
    return client, config, watch


# the hostPath volume of constants.LIBRARY_PATH in a pod's manifest
LIBRARY_VOLUME = "kubeshare-library"
# metadata the API server sets on a pod it stores; a created pod sends none
_SERVER_METADATA = frozenset((
    "uid", "resourceVersion", "creationTimestamp", "selfLink",
    "managedFields", "generation", "deletionTimestamp",
    "deletionGracePeriodSeconds"))


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def _manifest_of(obj):
    """An API object as the dict the API server takes: camelCase keys,
    unset fields left out.  The client's models name their keys in
    ``attribute_map``; another object (a test double) by its attributes."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [_manifest_of(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _manifest_of(v) for k, v in obj.items()}
    if hasattr(obj, "isoformat"):
        return obj.isoformat()
    names = getattr(obj, "attribute_map", None)
    if names is None:
        names = {attr: _camel(attr) for attr in vars(obj)}
    out = {}
    for attr, key in names.items():
        value = getattr(obj, attr, None)
        if value is not None:
            out[key] = _manifest_of(value)
    return out


def _to_pod(obj) -> Pod:
    spec = obj.spec
    meta = obj.metadata
    containers = []
    for c in spec.containers or []:
        env = {e.name: (e.value or "") for e in (c.env or []) if e.name}
        mounts = [m.mount_path for m in (c.volume_mounts or [])]
        containers.append(Container(name=c.name, env=env, volume_mounts=mounts))
    phase = PodPhase.PENDING
    if obj.status and obj.status.phase in PodPhase._value2member_map_:
        phase = PodPhase(obj.status.phase)
    pod = Pod(
        namespace=meta.namespace or "default",
        name=meta.name,
        uid=meta.uid or "",
        labels=dict(meta.labels or {}),
        annotations=dict(meta.annotations or {}),
        scheduler_name=spec.scheduler_name or "default-scheduler",
        node_name=spec.node_name or "",
        phase=phase,
        containers=containers or [Container()],
        volumes=[v.name for v in (spec.volumes or [])],
        creation_timestamp=(
            meta.creation_timestamp.timestamp() if meta.creation_timestamp else 0.0
        ),
    )
    pod.source = {"metadata": _manifest_of(meta), "spec": _manifest_of(spec)}
    return pod


def _merged_env(source_env: List[dict], env: Dict[str, str]) -> List[dict]:
    """A container's env entries: the source's, each one the pod still
    holds at the value read from it kept as written (``valueFrom``
    included), the others set to the pod's value, and the pod's new
    names after them."""
    out, seen = [], set()
    for entry in source_env:
        name = entry.get("name")
        if name not in env:
            continue
        seen.add(name)
        if env[name] == (entry.get("value") or ""):
            out.append(entry)
        else:
            out.append({"name": name, "value": env[name]})
    out += [{"name": k, "value": v} for k, v in env.items() if k not in seen]
    return out


def _to_node(obj) -> Node:
    ready = False
    for condition in (obj.status.conditions or []) if obj.status else []:
        if condition.type == "Ready" and condition.status == "True":
            ready = True
    return Node(
        name=obj.metadata.name,
        labels=dict(obj.metadata.labels or {}),
        ready=ready,
        unschedulable=bool(obj.spec.unschedulable) if obj.spec else False,
    )


class K8sCluster(ClusterAPI):
    def __init__(self, kubeconfig: Optional[str] = None) -> None:
        client, config, watch = _require_client()
        self._client_mod = client
        self._watch_mod = watch
        try:
            config.load_incluster_config()
        except Exception:
            config.load_kube_config(config_file=kubeconfig)
        self.core = client.CoreV1Api()
        self._pod_handlers: List[EventHandler] = []
        self._node_handlers: List[EventHandler] = []
        self._watch_threads: List[threading.Thread] = []

    # ---- reads -------------------------------------------------------
    def list_pods(self, namespace=None, scheduler_name=None, phase=None,
                  label_selector: Optional[Dict[str, str]] = None) -> List[Pod]:
        selector = (
            ",".join(f"{k}={v}" for k, v in label_selector.items())
            if label_selector else None
        )
        field_selectors = []
        if phase is not None:
            field_selectors.append(f"status.phase={phase.value}")
        fields = ",".join(field_selectors) or None
        if namespace:
            items = self.core.list_namespaced_pod(
                namespace, label_selector=selector, field_selector=fields
            ).items
        else:
            items = self.core.list_pod_for_all_namespaces(
                label_selector=selector, field_selector=fields
            ).items
        pods = [_to_pod(i) for i in items]
        if scheduler_name is not None:
            pods = [p for p in pods if p.scheduler_name == scheduler_name]
        return pods

    def list_nodes(self) -> List[Node]:
        return [_to_node(i) for i in self.core.list_node().items]

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        try:
            return _to_pod(self.core.read_namespaced_pod(name, namespace))
        except self._client_mod.ApiException as e:
            if e.status == 404:
                return None
            raise

    # ---- writes ------------------------------------------------------
    def create_pod(self, pod: Pod) -> Pod:
        body = self._pod_manifest(pod)
        created = self.core.create_namespaced_pod(pod.namespace, body)
        return _to_pod(created)

    def update_pod(self, pod: Pod) -> Pod:
        """Patch labels/annotations/env deltas; node assignment goes through
        bind_pod (env on existing containers is immutable in k8s — the
        shadow bind mode exists for exactly that, ref scheduler.go:515-528).

        409 Conflict is retried with backoff: strategic-merge patches can
        still conflict with a concurrent delete/recreate or an admission
        webhook rewriting the object, and placement annotations must not
        be dropped on the floor for a transient race."""
        patch = {
            "metadata": {
                "labels": pod.labels,
                "annotations": pod.annotations,
            }
        }
        patched = self._patch_with_retry(pod.name, pod.namespace, patch)
        if pod.node_name and not (patched.spec.node_name or ""):
            self.bind_pod(pod.namespace, pod.name, pod.node_name)
        return pod

    def _patch_with_retry(self, name: str, namespace: str, patch: dict,
                          attempts: int = 4):
        import time

        for attempt in range(attempts):
            try:
                return self.core.patch_namespaced_pod(name, namespace, patch)
            except self._client_mod.ApiException as e:
                if e.status != 409 or attempt + 1 >= attempts:
                    raise
                time.sleep(0.05 * (2 ** attempt))

    def delete_pod(self, namespace: str, name: str) -> None:
        try:
            self.core.delete_namespaced_pod(name, namespace)
        except self._client_mod.ApiException as e:
            if e.status != 404:
                raise

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        client = self._client_mod
        body = client.V1Binding(
            metadata=client.V1ObjectMeta(name=name),
            target=client.V1ObjectReference(
                api_version="v1", kind="Node", name=node_name
            ),
        )
        # the python client chokes on the Binding response; tolerate it
        try:
            self.core.create_namespaced_pod_binding(
                name, namespace, body, _preload_content=False
            )
        except Exception:
            raise

    def _pod_manifest(self, pod: Pod) -> dict:
        """The body that creates ``pod``: its source manifest when it was
        read from the API server (image, command, resources, volumes,
        owner references and the rest), with the modelled fields laid on
        top: metadata, scheduler, node, each container's env (the pod's
        values replace same-named entries), and constants.LIBRARY_PATH as
        the hostPath volume LIBRARY_VOLUME, mounted in each container
        that mounts it.  A pod built in memory has only those fields."""
        source = copy.deepcopy(pod.source or {})
        meta = {k: v for k, v in (source.get("metadata") or {}).items()
                if k not in _SERVER_METADATA}
        meta.update(name=pod.name, namespace=pod.namespace,
                    labels=pod.labels, annotations=pod.annotations)
        spec = source.get("spec") or {}
        spec["schedulerName"] = pod.scheduler_name
        spec["nodeName"] = pod.node_name or None
        volumes = spec.get("volumes") or []
        library = None
        if constants.LIBRARY_PATH in pod.volumes:
            library = next((v["name"] for v in volumes
                            if (v.get("hostPath") or {}).get("path")
                            == constants.LIBRARY_PATH), None)
            if library is None:
                library = LIBRARY_VOLUME
                volumes.append({"name": library, "hostPath": {
                    "path": constants.LIBRARY_PATH,
                    "type": "DirectoryOrCreate"}})
            spec["volumes"] = volumes
        by_name = {c.get("name"): c for c in spec.get("containers") or []}
        containers = []
        for c in pod.containers:
            out = by_name.get(c.name) or {"name": c.name}
            out["env"] = _merged_env(out.get("env") or [], c.env)
            mounts = out.get("volumeMounts") or []
            if (library and constants.LIBRARY_PATH in c.volume_mounts
                    and all(m.get("mountPath") != constants.LIBRARY_PATH
                            for m in mounts)):
                out["volumeMounts"] = mounts + [
                    {"name": library, "mountPath": constants.LIBRARY_PATH}]
            containers.append(out)
        spec["containers"] = containers
        return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                "spec": spec}

    # ---- watches -----------------------------------------------------
    def add_pod_handler(self, handler: EventHandler) -> None:
        self._pod_handlers.append(handler)
        for pod in self.list_pods():
            handler("add", pod)
        if len(self._pod_handlers) == 1:
            self._start_watch("pods")

    def add_node_handler(self, handler: EventHandler) -> None:
        self._node_handlers.append(handler)
        for node in self.list_nodes():
            handler("add", node)
        if len(self._node_handlers) == 1:
            self._start_watch("nodes")

    def _start_watch(self, kind: str) -> None:
        """Informer-style watch loop: resume from the last seen
        resourceVersion on reconnect (no full replay per blip); on 410 Gone
        (history compacted) fall back to a fresh list, replayed as `update`
        resync events plus synthesized `delete` events for objects that
        vanished during the blind window (a plain relist would leak their
        reservations forever).  Handlers must be idempotent — the engine's
        add/update paths are (restart recovery re-reserves from
        annotations, SURVEY §3.5)."""

        def run() -> None:
            import time

            watch = self._watch_mod.Watch()
            list_fn = (
                self.core.list_pod_for_all_namespaces
                if kind == "pods" else self.core.list_node
            )
            convert = _to_pod if kind == "pods" else _to_node
            handlers = self._pod_handlers if kind == "pods" else self._node_handlers
            key_of = ((lambda o: (o.namespace, o.name)) if kind == "pods"
                      else (lambda o: o.name))
            resource_version: Optional[str] = None
            known: Dict = {}  # key -> last seen object, for resync deletes
            need_resync = False
            while True:
                # everything — including the resync list — stays inside the
                # try: an API error during resync must retry, not silently
                # kill the watch thread for the process lifetime
                try:
                    if need_resync:
                        # raw list (not list_pods()): its resourceVersion
                        # restarts the watch exactly where the list was
                        # taken — resuming with no version would snapshot
                        # at a later T1, silently dropping deletes in
                        # (list, T1) and re-leaking what the resync fixed
                        listed = list_fn()
                        list_meta = getattr(listed, "metadata", None)
                        resource_version = getattr(
                            list_meta, "resource_version", None
                        ) or None
                        current = {}
                        for raw in listed.items or []:
                            obj = convert(raw)
                            current[key_of(obj)] = obj
                        for key, obj in list(known.items()):
                            if key not in current:
                                del known[key]
                                for handler in list(handlers):
                                    handler("delete", obj)
                        for key, obj in current.items():
                            known[key] = obj
                            for handler in list(handlers):
                                handler("update", obj)
                        need_resync = False
                    kwargs = {"timeout_seconds": 300}
                    if resource_version:
                        kwargs["resource_version"] = resource_version
                    for event in watch.stream(list_fn, **kwargs):
                        event_type = {"ADDED": "add", "MODIFIED": "update",
                                      "DELETED": "delete"}.get(event["type"])
                        if event_type is None:
                            continue
                        raw = event["object"]
                        rv = getattr(getattr(raw, "metadata", None),
                                     "resource_version", None)
                        if rv:
                            resource_version = rv
                        obj = convert(raw)
                        if event_type == "delete":
                            known.pop(key_of(obj), None)
                        else:
                            known[key_of(obj)] = obj
                        for handler in list(handlers):
                            handler(event_type, obj)
                except self._client_mod.ApiException as e:
                    if e.status == 410:  # Gone: our version was compacted
                        resource_version = None
                        need_resync = True
                        continue
                    time.sleep(2)
                except Exception:
                    # reconnect after watch errors — but never silently: a
                    # handler or list call failing EVERY attempt would
                    # otherwise look like a healthy-but-quiet watch
                    from ..utils.logger import get_logger

                    get_logger("kubeshare-cluster").warning(
                        "%s watch error (reconnecting in 2s)", kind,
                        exc_info=True)
                    time.sleep(2)

        thread = threading.Thread(target=run, daemon=True, name=f"watch-{kind}")
        thread.start()
        self._watch_threads.append(thread)

    # ---- leader-election leases --------------------------------------
    def lease_tryhold(
        self, name: str, identity: str, duration_s: float, now: float
    ) -> str:
        """Lease-object leader election (coordination.k8s.io/v1) — the
        kube-scheduler pattern the reference rode for HA
        (deploy/scheduler.yaml:74-112): read-modify-write with optimistic
        concurrency, the apiserver's 409 on a stale resourceVersion
        arbitrating racers.  Wall clock is authoritative here (renewTime
        lives in the Lease object); ``now`` is for clock-injected
        backends.  Raises NotImplementedError when the client library has
        no CoordinationV1Api — the elector then degrades to
        single-instance mode."""
        import datetime as _dt
        import os

        client = self._client_mod
        if not (hasattr(client, "CoordinationV1Api")
                and hasattr(client, "V1Lease")
                and hasattr(client, "V1LeaseSpec")):
            raise NotImplementedError(
                "kubernetes client lacks the coordination.k8s.io/v1 "
                "Lease surface")
        api = client.CoordinationV1Api()
        namespace = os.environ.get("POD_NAMESPACE", "kube-system")

        def utcnow():
            return _dt.datetime.now(_dt.timezone.utc)

        holder = ""
        for _ in range(3):  # optimistic-concurrency retries
            try:
                lease = api.read_namespaced_lease(name, namespace)
            except client.ApiException as e:
                if e.status != 404:
                    raise
                # real OpenAPI model objects: the official client's
                # serializer rejects plain namespaces (it reads
                # openapi_types off the body), same as the bind path's
                # V1Binding
                body = client.V1Lease(
                    metadata=client.V1ObjectMeta(name=name),
                    spec=client.V1LeaseSpec(
                        holder_identity=identity,
                        lease_duration_seconds=int(duration_s),
                        acquire_time=utcnow(),
                        renew_time=utcnow(),
                    ),
                )
                try:
                    api.create_namespaced_lease(namespace, body)
                    return identity
                except client.ApiException as ce:
                    if ce.status == 409:
                        continue  # lost the create race: re-read
                    raise
            spec = lease.spec
            holder = getattr(spec, "holder_identity", None) or ""
            renew = getattr(spec, "renew_time", None)
            duration = (getattr(spec, "lease_duration_seconds", None)
                        or int(duration_s))
            expired = True
            if holder and renew is not None:
                expired = (utcnow() - renew).total_seconds() >= duration
            if holder and holder != identity and not expired:
                return holder
            if holder != identity:
                spec.acquire_time = utcnow()
            spec.holder_identity = identity
            spec.lease_duration_seconds = int(duration_s)
            spec.renew_time = utcnow()
            try:
                api.replace_namespaced_lease(name, namespace, lease)
                return identity
            except client.ApiException as e:
                if e.status == 409:
                    continue  # raced a peer's renew: re-read
                raise
        return holder

