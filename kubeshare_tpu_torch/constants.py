"""The names of kubeshare_tpu/constants.py that the port's sharing
runtime, its node daemons (collector, launcher) and its multi-process
bootstrap read, with the same strings: the scheduler, ``configd`` and
``tpushare-tokend`` serve JAX and PyTorch pods alike and inject these
env names into both.  The port keeps its own copy (it imports nothing
of the JAX package).
"""

# ---- injected env ----
ENV_PROCESS_BOUNDS = "TPU_PROCESS_BOUNDS"
ENV_POD_MANAGER_PORT = "POD_MANAGER_PORT"
ENV_POD_NAME = "POD_NAME"
ENV_SHIM_PRELOAD = "LD_PRELOAD"
ENV_MEM_FRACTION = "TPUSHARE_MEM_FRACTION"  # HBM cap as fraction of device memory

# multi-slice bootstrap env for gangs whose cells span interconnect
# domains (the scheduler injects libtpu's own names into every gang pod)
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"

# ---- filesystem layout on the node (hostPath bus) ----
ROOT_DIR = "/kubeshare"
LIBRARY_PATH = ROOT_DIR + "/library"
# the CUDA driver interposer (csrc/cuda_hook.cc) the scheduler would inject
# into a PyTorch pod, where it injects libtpushim.so.1 into a JAX pod
SHIM_LIBRARY = LIBRARY_PATH + "/libcudahook.so.1"
SCHEDULER_DIR = ROOT_DIR + "/scheduler"
CHIP_CONFIG_DIR = SCHEDULER_DIR + "/config/"
POD_MANAGER_PORT_DIR = SCHEDULER_DIR + "/podmanagerport/"
LOG_DIR = ROOT_DIR + "/log/"
SCHEDULER_IP_FILE = LIBRARY_PATH + "/schedulerIP.txt"

# ---- token runtime defaults ----
TOKEND_BASE_PORT = 49901
TOKEN_BASE_QUOTA_MS = 300.0
TOKEN_MIN_QUOTA_MS = 20.0
TOKEN_WINDOW_MS = 10000.0

# ---- metric names (Prometheus bus) ----
METRIC_CAPACITY = "gpu_capacity"
COLLECTOR_PORT = 9004
