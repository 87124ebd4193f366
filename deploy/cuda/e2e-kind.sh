#!/bin/sh
# End-to-end walk of the port's deployment against a real Kubernetes API
# server via kind (the counterpart of deploy/e2e-kind.sh): build the
# kubeshare-tpu-torch image, load it into a kind cluster, deploy the
# scheduler (shadow bind) with a fake-inventory collector of H100 cards,
# submit deploy/cuda/examples/mnist-fractional.yaml, and check that the
# placed copy carries the card's UUID, the hook's LD_PRELOAD, the
# /kubeshare/library hostPath volume and the manifest's own image.  kind's
# node has no card, so the pod is placed but does not run its trainer.
#
# Before any cluster (always): every manifest under deploy/cuda parses,
# and a probe pod is placed through the port's scheduler in shadow mode on
# the port's FakeCluster with an H100 inventory.  Without docker, kind or
# kubectl the script then prints a SKIP line and exits 0.
#
#   deploy/cuda/e2e-kind.sh          (or: make e2e-kind-torch)
set -eu

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
CLUSTER=${KUBESHARE_E2E_CLUSTER:-kubeshare-torch-e2e}
IMAGE=${IMAGE:-kubeshare-tpu-torch:latest}
MODEL=NVIDIA-H100-80GB-HBM3

say() { echo "e2e-kind: $*"; }

# ---- before kubectl (always runs) ----
say "validating the port's manifests + fake-cluster placement (no cluster needed)"
( cd "$REPO" && python3 - <<'EOF'
import glob
import sys

sys.path.insert(0, ".")
import yaml

paths = sorted(glob.glob("deploy/cuda/**/*.yaml", recursive=True))
for path in paths:
    with open(path) as fh:
        assert [d for d in yaml.safe_load_all(fh) if d], path
print(f"manifests parse: ok ({len(paths)} files)")

from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.cell import load_config
from kubeshare_tpu_torch.cell.allocator import ChipInfo
from kubeshare_tpu_torch.cluster.api import Container, Node, Pod
from kubeshare_tpu_torch.cluster.fake import FakeCluster
from kubeshare_tpu_torch.scheduler import (KubeShareScheduler, SchedulerArgs,
                                           SchedulerEngine)

model = "NVIDIA-H100-80GB-HBM3"
topo = load_config(path="deploy/cuda/config/kubeshare-config-h100-node.yaml")
cluster = FakeCluster()
cluster.add_node(Node("h100-node-0", {constants.NODE_LABEL_FILTER: "true"}))
chips = [ChipInfo(f"GPU-e2e-{i}", 80 << 30, model, i) for i in range(8)]
sched = KubeShareScheduler(topo, cluster, lambda node: chips,
                           args=SchedulerArgs(bind_mode="shadow"))
engine = SchedulerEngine(sched, cluster)
cluster.create_pod(Pod(
    name="e2e-probe",
    labels={constants.POD_GPU_REQUEST: "0.5",
            constants.POD_GPU_LIMIT: "1.0"},
    scheduler_name=constants.SCHEDULER_NAME,
    containers=[Container(name="train")],
))
list(engine.run_until_idle())
pod = cluster.get_pod("default", "e2e-probe")
uuid = pod.annotations.get(constants.POD_GPU_UUID)
env = pod.containers[0].env
assert uuid in {c.uuid for c in chips} and pod.node_name == "h100-node-0", (
    pod.annotations, pod.node_name)
assert env[constants.ENV_VISIBLE_DEVICES] == uuid, env
assert env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY, env
assert env[constants.ENV_POD_NAME] == "default/e2e-probe", env
assert constants.LIBRARY_PATH in pod.containers[0].volume_mounts, pod
assert constants.LIBRARY_PATH in pod.volumes, pod
print(f"fake-cluster placement: ok (shadow bind, chip {uuid}, "
      f"LD_PRELOAD {env[constants.ENV_SHIM_PRELOAD]}, "
      f"{constants.LIBRARY_PATH} mounted)")
EOF
)

for tool in docker kind kubectl; do
    if ! command -v "$tool" >/dev/null 2>&1; then
        say "SKIP: $tool not found — ran to the kubectl boundary only"
        exit 0
    fi
done

# ---- the real thing ----
say "building $IMAGE"
( cd "$REPO" && make images-torch IMAGE_TORCH="$IMAGE" )

if ! kind get clusters 2>/dev/null | grep -qx "$CLUSTER"; then
    say "creating kind cluster $CLUSTER"
    kind create cluster --name "$CLUSTER" --wait 120s
fi
trap 'say "cluster $CLUSTER left running (kind delete cluster --name $CLUSTER to remove)"' EXIT
kubectl config use-context "kind-$CLUSTER"

say "loading image into kind"
kind load docker-image --name "$CLUSTER" "$IMAGE"

NODE=$(kubectl get nodes -o name | head -1 | cut -d/ -f2)
say "labeling node $NODE + generating a matching H100 topology"
kubectl label node "$NODE" SharedGPU=true --overwrite

say "deploying the scheduler (shadow bind) + a fake-inventory collector"
kubectl apply -f "$REPO/deploy/cuda/scheduler.yaml"
TOPOLOGY=$(mktemp)
( cd "$REPO" && python3 -c "
import yaml
from kubeshare_tpu_torch.cell.topology import generate_tpu_topology
print(yaml.dump(generate_tpu_topology([('$NODE', '$MODEL', 8)],
                                      model_priority={'$MODEL': 100})))
" ) > "$TOPOLOGY"
kubectl -n kube-system create configmap kubeshare-topology \
    --from-file=kubeshare-config.yaml="$TOPOLOGY" \
    --dry-run=client -o yaml | kubectl apply -f -
rm -f "$TOPOLOGY"
# no Prometheus in kind: the scheduler scrapes the one fake collector,
# which runs on the node's host network
kubectl -n kube-system patch deployment kubeshare-scheduler --type=json -p "[
  {\"op\": \"replace\", \"path\": \"/spec/template/spec/containers/0/command\",
   \"value\": [\"python\", \"-m\", \"kubeshare_tpu_torch\", \"scheduler\",
             \"--cluster=k8s\", \"--bind-mode=shadow\",
             \"--kubeshare-config=/kubeshare/scheduler/kubeshare-config.yaml\",
             \"--collector-urls=http://127.0.0.1:9004/kubeshare-collector\",
             \"--level=4\", \"--log-dir=/kubeshare/log\"]},
  {\"op\": \"add\", \"path\": \"/spec/template/spec/containers/0/imagePullPolicy\",
   \"value\": \"Never\"},
  {\"op\": \"add\", \"path\": \"/spec/template/spec/hostNetwork\",
   \"value\": true}]"
kubectl -n kube-system apply -f - <<EOF2
apiVersion: apps/v1
kind: Deployment
metadata: {name: kubeshare-e2e-collector, namespace: kube-system}
spec:
  replicas: 1
  selector: {matchLabels: {app: kubeshare-e2e-collector}}
  template:
    metadata: {labels: {app: kubeshare-e2e-collector}}
    spec:
      hostNetwork: true
      tolerations: [{operator: Exists}]
      containers:
      - name: collector
        image: $IMAGE
        imagePullPolicy: Never
        command: ["python", "-m", "kubeshare_tpu_torch", "collector",
                  "--fake-chips=8", "--fake-model=$MODEL", "--node-name=$NODE"]
EOF2
kubectl -n kube-system rollout status deployment/kubeshare-e2e-collector --timeout=180s
kubectl -n kube-system rollout status deployment/kubeshare-scheduler --timeout=180s

say "submitting a fractional pod (deploy/cuda/examples/mnist-fractional.yaml)"
sed "s|^    image: .*|    image: $IMAGE\n    imagePullPolicy: Never|" \
    "$REPO/deploy/cuda/examples/mnist-fractional.yaml" | kubectl apply -f -
UUID=""
for _ in $(seq 1 60); do
    UUID=$(kubectl get pod mnist1 \
        -o jsonpath='{.metadata.annotations.sharedgpu/gpu_uuid}' 2>/dev/null || true)
    [ -n "$UUID" ] && break
    sleep 2
done
if [ -z "$UUID" ]; then
    say "FAIL: the scheduler never placed the test pod"
    kubectl -n kube-system logs deployment/kubeshare-scheduler --tail=50 || true
    exit 1
fi
SPEC=$(kubectl get pod mnist1 -o jsonpath='{.spec.nodeName} {.spec.containers[0].image} {.spec.containers[0].env[?(@.name=="LD_PRELOAD")].value} {.spec.volumes[?(@.name=="kubeshare-library")].hostPath.path}')
say "placed copy: $SPEC"
case "$SPEC" in
    "$NODE $IMAGE /kubeshare/library/libcudahook.so.1 /kubeshare/library")
        say "PASS: pod mnist1 placed on chip $UUID with the hook and its manifest's image" ;;
    *)
        say "FAIL: the placed copy lost its spec or the hook"
        exit 1 ;;
esac
