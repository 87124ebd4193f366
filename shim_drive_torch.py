#!/usr/bin/env python3
"""Drive an unmodified PyTorch workload under the CUDA driver interposer.

The PyTorch port's counterpart of ``examples/shim_drive.py``: the
scheduler sets ``LD_PRELOAD=libcudahook.so.1`` with ``POD_MANAGER_PORT``
and ``POD_NAME`` on a fractional pod, and every kernel launch, graph
launch and device allocation in the container is gated and charged with
no cooperation from the workload.  This script starts a
``tpushare-tokend`` and a ``tpushare-pmgr`` for one pod and runs the
port's MNIST trainer in a child under the hook: 20 eager AdamW steps,
then ``--steps`` captured ones (one CUDA graph replay each).  The child
imports nothing of ``kubeshare_tpu_torch.isolation`` and holds no token
client: whatever the broker's ledger shows, the hook did.

    python3 shim_drive_torch.py              # on a machine with a card
    python3 shim_drive_torch.py --steps 200

Prints a JSON verdict: the broker's grants, charged ms and memory for the
pod, and the hook's counters (launches by kind and by kernel, grants,
charged ms and bytes).  Exits 1 when the pod was not gated.  Without a
CUDA device it raises: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
POD = "drive/pod-a"

WORKER = r"""
import sys, torch
sys.path.insert(0, %(repo)r)
# a plain trainer: no token client, no guard
from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
from kubeshare_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

device = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(0)
params = mnist_init(gen, device=device)
images = torch.randn(512, 28, 28, 1, generator=gen).to(device)
labels = torch.randint(0, 10, (512,), generator=gen).to(device)
for capture, steps in ((False, 20), (True, %(steps)d)):
    init_state, step = make_train_step(mnist_apply, loss_fn=cross_entropy_loss,
                                       capture=capture)
    state = init_state(params)
    for _ in range(steps):
        state, loss = step(state, images, labels)
    print("loss", "captured" if capture else "eager", float(loss))
print("WORKER_DONE", torch.cuda.get_device_name(0))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50,
                        help="captured steps after the 20 eager ones")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("shim_drive_torch.py drives a CUDA card and "
                           "finds none")
    sys.path.insert(0, REPO)
    import corun_bench
    from kubeshare_tpu_torch.isolation import TokenClient, hook

    tokend = corun_bench.ensure_binary("tpushare-tokend")
    pmgr = corun_bench.ensure_binary("tpushare-pmgr")
    workdir = tempfile.mkdtemp(prefix="shim-drive-torch-")
    with open(os.path.join(workdir, "card-0"), "w") as f:
        f.write(f"1\n{POD} 1.0 0.5 0\n")
    tokend_port, pmgr_port = corun_bench.free_port(), corun_bench.free_port()
    procs = [subprocess.Popen(
        [tokend, "-p", workdir, "-f", "card-0", "-P", str(tokend_port)],
        stderr=subprocess.DEVNULL)]
    try:
        corun_bench._wait_listening(tokend_port)
        procs.append(subprocess.Popen(
            [pmgr], stderr=subprocess.DEVNULL,
            env=dict(os.environ, SCHEDULER_IP="127.0.0.1",
                     SCHEDULER_PORT=str(tokend_port),
                     POD_MANAGER_IP="127.0.0.1",
                     POD_MANAGER_PORT=str(pmgr_port), POD_NAME=POD)))
        corun_bench._wait_listening(pmgr_port)
        stats_path = os.path.join(workdir, "hook.json")
        env = dict(os.environ, **hook.hook_env(pmgr_port, POD,
                                               stats_path=stats_path))
        worker = subprocess.run(
            [sys.executable, "-c",
             WORKER % {"repo": REPO, "steps": args.steps}],
            env=env, cwd=REPO, capture_output=True, text=True,
            timeout=args.timeout)
        sys.stderr.write(worker.stderr[-2000:])
        if worker.returncode != 0 or "WORKER_DONE" not in worker.stdout:
            print(json.dumps({"gated": False,
                              "error": f"worker rc={worker.returncode}",
                              "stdout": worker.stdout[-500:]}))
            return 1
        client = TokenClient("127.0.0.1", tokend_port, "observer")
        pod = json.loads(client.stat())["pods"].get(POD, {})
        client.close()
        counters = hook.read_stats(stats_path)
        verdict = {
            "gated": pod.get("grants", 0) > 0,
            "card": worker.stdout.split("WORKER_DONE", 1)[1].strip(),
            "broker": pod,
            "hook": counters,
        }
        print(json.dumps(verdict))
        return 0 if verdict["gated"] else 1
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())
