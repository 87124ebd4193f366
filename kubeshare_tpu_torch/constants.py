"""Label / annotation / env-var vocabulary and defaults of the port:
the names of kubeshare_tpu/constants.py that the port's control plane
(cell allocator, scheduler, ``configd``), its sharing runtime, its node
daemons (collector, launcher) and its multi-process bootstrap read, with
the same strings.  The port keeps its own copy (it imports nothing of
the JAX package).

The pod-facing API is the reference's (``sharedgpu/*`` labels, ref
pkg/scheduler/constants.go:3-28).  The env the port's scheduler injects
is the reference's device visibility (``NVIDIA_VISIBLE_DEVICES``, ref
pkg/scheduler/pod.go:437-457) plus the names the port's own runtime
reads (``csrc/cuda_hook.cc``, ``isolation/``, ``parallel/distributed.py``);
it injects none of libtpu's names.
"""

DOMAIN = "sharedgpu/"

# ---- pod labels (user-facing API, identical to the reference) ----
POD_GROUP_NAME = DOMAIN + "group_name"
POD_GROUP_HEADCOUNT = DOMAIN + "group_headcount"
POD_GROUP_THRESHOLD = DOMAIN + "group_threshold"
POD_PRIORITY = DOMAIN + "priority"
POD_GPU_LIMIT = DOMAIN + "gpu_limit"
POD_GPU_REQUEST = DOMAIN + "gpu_request"
POD_GPU_MEMORY = DOMAIN + "gpu_mem"
POD_GPU_MODEL = DOMAIN + "gpu_model"

# ---- annotations written by the scheduler at Reserve time ----
POD_GPU_UUID = DOMAIN + "gpu_uuid"
POD_CELL_ID = DOMAIN + "cell_id"
POD_MANAGER_PORT = DOMAIN + "gpu_manager_port"

# aggregator-only label (ref pkg/aggregator/pod.go:22)
POD_GROUP_MIN_AVAILABLE = DOMAIN + "min_available"

# ---- injected env ----
# device visibility as the reference injected it (ref SURVEY.md:131,
# pod.go:437-457): the NVIDIA container runtime maps the UUIDs onto the
# container's CUDA_VISIBLE_DEVICES
ENV_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
ENV_DRIVER_CAPABILITIES = "NVIDIA_DRIVER_CAPABILITIES"
DRIVER_CAPABILITIES = "compute,utility"
# the gang's process grid (read by parallel/distributed.py)
ENV_PROCESS_BOUNDS = "TPU_PROCESS_BOUNDS"
ENV_POD_MANAGER_PORT = "POD_MANAGER_PORT"
ENV_POD_NAME = "POD_NAME"
ENV_SHIM_PRELOAD = "LD_PRELOAD"
ENV_MEM_FRACTION = "TPUSHARE_MEM_FRACTION"  # memory cap as fraction of device memory
ENV_MEM_BYTES = "TPUSHARE_MEM_BYTES"  # memory cap in bytes
# where device discovery finds the node's sysfs (default /sys): the
# collector's DaemonSet mounts the host's /sys read-only and names it
ENV_SYSFS = "KUBESHARE_SYSFS"

# multi-slice bootstrap env for gangs whose cells span interconnect
# domains (parallel/distributed.py's multislice_spec_from_env reads them)
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"

# ---- filesystem layout on the node (hostPath bus, ref /kubeshare/...) ----
ROOT_DIR = "/kubeshare"
LIBRARY_PATH = ROOT_DIR + "/library"  # ref pod.go:25
# the CUDA driver interposer (csrc/cuda_hook.cc) the scheduler injects
# into a fractional pod (ref libgemhook.so.1)
SHIM_LIBRARY = LIBRARY_PATH + "/libcudahook.so.1"
SCHEDULER_DIR = ROOT_DIR + "/scheduler"
CONFIG_FILE = SCHEDULER_DIR + "/kubeshare-config.yaml"  # ref scheduler.go:42
CHIP_CONFIG_DIR = SCHEDULER_DIR + "/config/"  # ref pkg/config/config.go:20
POD_MANAGER_PORT_DIR = SCHEDULER_DIR + "/podmanagerport/"  # ref config.go:21
LOG_DIR = ROOT_DIR + "/log/"
SCHEDULER_IP_FILE = LIBRARY_PATH + "/schedulerIP.txt"  # ref cmd/kubeshare-query-ip

# ---- scheduler defaults (ref pkg/scheduler/scheduler.go:35-47, node.go:11-15) ----
SCHEDULER_NAME = "kubeshare-scheduler"
NODE_LABEL_FILTER = "SharedGPU"  # nodes opt in with SharedGPU=true
POD_MANAGER_PORT_START = 50050
POD_MANAGER_PORT_POOL = 512
PERMIT_WAITING_TIME_BASE_SECONDS = 2
POD_GROUP_GC_INTERVAL_SECONDS = 30
POD_GROUP_EXPIRATION_TIME_SECONDS = 600

# ---- token runtime defaults (ref launcher.py:77-80) ----
TOKEND_BASE_PORT = 49901
TOKEN_BASE_QUOTA_MS = 300.0
TOKEN_MIN_QUOTA_MS = 20.0
TOKEN_WINDOW_MS = 10000.0

# ---- metric names (Prometheus bus, ref pkg/scheduler/gpu.go:13-14) ----
METRIC_CAPACITY = "gpu_capacity"
METRIC_REQUIREMENT = "gpu_requirement"
COLLECTOR_PORT = 9004
AGGREGATOR_PORT = 9005
