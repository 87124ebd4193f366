"""The names of kubeshare_tpu/constants.py that the port's sharing
runtime reads, with the same strings: the scheduler and
``tpushare-tokend`` serve JAX and PyTorch pods alike and inject these
env names into both.  The port keeps its own copy (it imports nothing
of the JAX package).
"""

# ---- injected env ----
ENV_POD_MANAGER_PORT = "POD_MANAGER_PORT"
ENV_POD_NAME = "POD_NAME"
ENV_MEM_FRACTION = "TPUSHARE_MEM_FRACTION"  # HBM cap as fraction of device memory

# ---- filesystem layout on the node (hostPath bus) ----
ROOT_DIR = "/kubeshare"
LIBRARY_PATH = ROOT_DIR + "/library"
SCHEDULER_IP_FILE = LIBRARY_PATH + "/schedulerIP.txt"

# ---- token runtime defaults ----
TOKEN_BASE_QUOTA_MS = 300.0
TOKEN_MIN_QUOTA_MS = 20.0
TOKEN_WINDOW_MS = 10000.0
