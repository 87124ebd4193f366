"""libcudahook.so.1, the port's CUDA driver interposer, on the CPU: the
hook is host code, so it runs here for real, LD_PRELOADed into a test
driver (csrc/hook_test/hook_driver.cc) over a fake libcuda.so.1
(csrc/hook_test/fake_libcuda.cc: a serial device clock, stream capture
that fails on any capture-unsafe call, memory), behind a real
tpushare-pmgr and tpushare-tokend.

Each case that has a counterpart among the JAX shim's TestInterposer
cases (tests/test_native_runtime.py) names it.  The JAX cases without
one are about PJRT objects CUDA does not have: client-create options and
XLA's allocator env, executable outputs allocated behind the caller's
back, device-to-device copies and aliased views, caller-owned completion
events.  The last case runs one scenario through both shims and holds
the two tokend ledgers equal.

The hook, the fake driver and the test driver are built with g++ once a
session (hash-keyed, under kubeshare_tpu_torch/_build/)."""

import json
import os
import subprocess
import time

import pytest

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.isolation import TokenClient, hook
from kubeshare_tpu_torch.runtime import find_binary

from native_helpers import free_port, wait_listening

TEST_CSRC = hook.CSRC / "hook_test"
CAP = 1_000_000  # ns/pod-a's memory cap in the tokend config below
QUOTA_MS = 50  # tokend -q: an eager lease lasts this long
# test_short_graphs_ride_a_lease's broker quota: six launches and their
# gaps stay inside one lease with six busy processes beside the test
# (their span reached 96 ms there at 5 ms gaps, past QUOTA_MS)
LEASE_QUOTA_MS = 100
# What that test's charge may exceed the fake driver's busy time by: the
# hook stamps a launch before the driver queues it and its markers run
# behind the work (2 ms), and tokend charges a grant at least the lesser
# of its hold and 5% of its quota (the first launch's own grant)
LEASE_CHARGE_MARGIN_MS = 2.0 + 0.05 * LEASE_QUOTA_MS


@pytest.fixture(scope="session")
def built():
    """The hook, the fake libcuda.so.1 and the test driver."""
    if find_binary("tpushare-tokend") is None or \
            find_binary("tpushare-pmgr") is None:
        pytest.skip("native binaries not built (make -C native)")
    header = (hook.CSRC / "cuda_driver_api.h",)
    fake = hook.build(
        "libcuda.so.1", (TEST_CSRC / "fake_libcuda.cc",),
        (*hook.SHARED, "-Wl,-soname,libcuda.so.1", "-Wl,-Bsymbolic"),
        headers=header, label="fakecuda")
    driver = hook.build(
        "hook_driver", (TEST_CSRC / "hook_driver.cc",),
        (f"-L{fake.parent}", "-l:libcuda.so.1",
         f"-Wl,-rpath,{fake.parent}", "-ldl"),
        headers=(*header, fake), label="hook_driver")
    return {"hook": str(hook.hook_path()), "driver": str(driver)}


def _start_tokend(tmp_path, exclusive=False, quota_ms=QUOTA_MS):
    config_dir = tmp_path / "config"
    config_dir.mkdir(exist_ok=True)
    (config_dir / "chip-0").write_text(
        f"2\nns/pod-a 1.0 0.5 {CAP}\nns/pod-b 1.0 0.3 500000\n")
    port = free_port()
    cmd = [find_binary("tpushare-tokend"), "-p", str(config_dir), "-f",
           "chip-0", "-P", str(port), "-q", str(quota_ms), "-m", "5",
           "-w", "1000"]
    if exclusive:
        cmd.append("-x")
    proc = subprocess.Popen(cmd, stderr=subprocess.DEVNULL)
    wait_listening(port)
    return proc, port


@pytest.fixture
def tokend(tmp_path):
    proc, port = _start_tokend(tmp_path)
    yield port
    proc.kill()
    proc.wait()


@pytest.fixture
def tokend_exclusive(tmp_path):
    proc, port = _start_tokend(tmp_path, exclusive=True)
    yield port
    proc.kill()
    proc.wait()


def stat(port, pod="ns/pod-a"):
    client = TokenClient("127.0.0.1", port, "observer")
    try:
        return json.loads(client.stat())
    finally:
        client.close()


class Run:
    """One driver run: its output, the hook's and the fake's counters,
    and the broker's ledger for the pod afterwards."""

    def __init__(self, proc, stdout, stderr, pod_stat, whole_stat):
        self.rc = proc.returncode
        self.out = stdout
        self.err = stderr
        self.pod = pod_stat
        self.stat = whole_stat
        self.hook = None
        self.fake = {}
        for line in stdout.splitlines():
            if line.startswith("hook "):
                self.hook = json.loads(line[5:])
            elif line.startswith("fake "):
                self.fake = dict(item.split("=", 1)
                                 for item in line[5:].split())

    def has(self, line):
        return line in self.out.splitlines()


class Pod:
    """A tpushare-pmgr for one pod, as the node daemon runs it."""

    def __init__(self, tokend_port, pod="ns/pod-a"):
        self.port = free_port()
        self.proc = subprocess.Popen(
            [find_binary("tpushare-pmgr")],
            env=dict(os.environ, SCHEDULER_IP="127.0.0.1",
                     SCHEDULER_PORT=str(tokend_port),
                     POD_MANAGER_IP="127.0.0.1",
                     POD_MANAGER_PORT=str(self.port), POD_NAME=pod),
            stderr=subprocess.DEVNULL)
        wait_listening(self.port)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def driver_env(built, pmgr_port=None, pod="ns/pod-a", **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in (constants.ENV_POD_MANAGER_PORT, "CUDAHOOK_STATS")}
    if pmgr_port is None:
        env[constants.ENV_SHIM_PRELOAD] = built["hook"]
    else:
        env.update(hook.hook_env(pmgr_port, pod, library=built["hook"]))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run(built, tokend_port, *args, pod="ns/pod-a", gated=True, timeout=60,
        **env):
    """The driver under the hook behind a pmgr for ``pod`` (no broker
    when ``gated`` is False); returns a :class:`Run`."""
    broker = Pod(tokend_port, pod) if gated else None
    try:
        proc = subprocess.run(
            [built["driver"], *map(str, args)],
            env=driver_env(built, broker.port if broker else None, pod, **env),
            capture_output=True, text=True, timeout=timeout)
    finally:
        if broker is not None:
            broker.stop()
    whole = stat(tokend_port) if tokend_port else {"pods": {}}
    return Run(proc, proc.stdout, proc.stderr,
               whole["pods"].get(pod, {}), whole)


# ---- gating ----------------------------------------------------------------

def test_graph_launches_are_gated_one_grant_each(built, tokend):
    """Mirrors test_preload_gates_execute: each launch of a 20 ms graph
    (a whole step) acquires its own token, as each Execute does."""
    r = run(built, tokend, "--graphs", 7, "--graph-us", 20_000,
            "--alloc", 4096)
    assert r.rc == 0, r.err
    assert r.has("graphs 7 launched") and r.has("alloc_ok") and r.has("freed")
    assert r.pod["grants"] == 7
    assert r.hook["graph_launches"] == 7 and r.hook["acquires"] == 7
    # the one launch inside the graph's capture passed ungated
    assert r.hook["captured_launches"] == 1
    assert r.pod["mem_used"] == 0


def test_short_graphs_ride_a_lease(built, tmp_path):
    """A 1 ms graph: its first launch takes a grant and measures it; the
    next five, under the 10 ms a grant's round trip is worth, take one
    lease between them.  Each is charged its own device time (~6 ms in
    all), the 3 ms host gaps between them not.

    The bound is the fake driver's own busy time (which grows with the
    host's load, as the charge does) plus LEASE_CHARGE_MARGIN_MS.  The
    control: a hook that charged the gaps would charge about the span
    from the first launch to the last completion, which the fake also
    reports, and the bound must refuse it."""
    proc, port = _start_tokend(tmp_path, quota_ms=LEASE_QUOTA_MS)
    try:
        r = run(built, port, "--graphs", 6, "--graph-gap-ms", 3,
                "--sleep-ms", 300)
    finally:
        proc.kill()
        proc.wait()
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 2 and r.hook["leases"] == 1
    assert r.hook["graph_launches_in_lease"] == 5
    busy_ms = int(r.fake["busy_us"]) / 1000
    bound_ms = busy_ms + LEASE_CHARGE_MARGIN_MS
    assert 5 <= r.pod["charged_total_ms"] <= bound_ms, (r.pod, r.fake)
    assert int(r.fake["span_us"]) / 1000 > bound_ms, r.fake


def test_a_host_paced_captured_pod_is_charged_its_graphs_not_its_gaps(
        built, tmp_path):
    """A host-paced captured pod: a 0.3 ms graph, measured by one launch,
    then launched every 1.5 ms without waiting for it, so the host's gaps
    are shorter than the hook's quiet time (kQuietMs, 2 ms) and no wait
    closes a segment.  The device is idle four fifths of the time; the
    charge must follow
    its busy time (the fake driver's busy_us, plus
    LEASE_CHARGE_MARGIN_MS), not the span from the first launch to the
    last completion (span_us), which the bound must refuse: each short
    graph's launch is charged from the later of its launch and the
    previous completion to its own, as the JAX shim charges each
    Execute."""
    proc, port = _start_tokend(tmp_path, quota_ms=LEASE_QUOTA_MS)
    try:
        r = run(built, port, "--graphs", 30, "--graph-us", 300,
                "--graph-host-us", 1500, "--sleep-ms", 300)
    finally:
        proc.kill()
        proc.wait()
    assert r.rc == 0, r.err
    # one launch measured the graph first: the paced 30 ride the lease
    assert r.hook["graph_launches_in_lease"] == 30, r.hook
    busy_ms = int(r.fake["busy_us"]) / 1000
    bound_ms = busy_ms + LEASE_CHARGE_MARGIN_MS
    assert 8 <= r.pod["charged_total_ms"] <= bound_ms, (r.pod, r.fake)
    assert int(r.fake["span_us"]) / 1000 > bound_ms, r.fake


def _line_json(r, label):
    prefix = label + " "
    for line in r.out.splitlines():
        if line.startswith(prefix):
            return json.loads(line[len(prefix):])
    raise AssertionError(f"no {label!r} line in {r.out!r}")


@pytest.mark.parametrize("path", ["cudart", "direct"])
def test_a_reused_graph_address_is_measured_anew(built, tokend, path):
    """A 0.5 ms graph learns its class (it rides a lease), is destroyed,
    and the fake driver hands its address to a 20 ms graph.  The long
    graph's first launch takes a grant of its own, which measures it: the
    destroy erased the short graph's class (the JAX shim's cache erase on
    destroy, native/shim/interposer.cc)."""
    r = run(built, tokend, "--path", path, "--reuse-graph",
            "--graph-us", 500, "--reuse-us", 20_000)
    assert r.rc == 0, r.err
    assert r.has("graph_reused=1")
    before, after = _line_json(r, "reuse before"), _line_json(r, "reuse after")
    assert before["graph_destroys"] == 1 and before["graph_classes"] == 0
    assert before["graph_launches_in_lease"] >= 1  # the short graph's class
    assert after["acquires"] - before["acquires"] == 1
    assert after["leases"] == before["leases"]
    assert after["graph_launches_in_lease"] == before["graph_launches_in_lease"]
    assert after["graph_classes"] == 1 and after["pending"] == 0
    assert r.fake["cuGraphExecDestroy"] == "1"


def test_a_destroy_racing_its_release_leaves_no_class(built, tokend):
    """A 50 ms graph destroyed right after its launch, before its marker
    fired: the release that completes afterwards still charges the work
    (at least the device's 50 ms, which a loaded host stretches), but must
    not record the dead graph's class again, so no entry is left behind."""
    r = run(built, tokend, "--destroy-in-flight", "--graph-us", 50_000)
    assert r.rc == 0, r.err
    after = _line_json(r, "in_flight after")
    assert after["graph_destroys"] == 1 and after["releases"] == 1
    assert after["pending"] == 0 and after["graph_classes"] == 0
    assert r.pod["grants"] == 1
    assert r.pod["charged_total_ms"] >= 40, r.pod


def test_eager_bursts_hold_one_grant_a_lease(built, tokend):
    """Eager launches pass under one lease while its quota lasts: 60
    launches within 50 ms take one grant."""
    r = run(built, tokend, "--bursts", 3, "--burst", 20)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 1
    assert r.hook["eager_launches"] == 60 and r.hook["leases"] == 1
    assert r.fake["cuLaunchKernel"] == "60"


def test_an_expired_lease_is_renewed(built, tokend):
    """Bursts 120 ms apart outlive the 50 ms quota: each takes a lease."""
    r = run(built, tokend, "--bursts", 3, "--burst", 5, "--gap-ms", 120)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 3 and r.hook["leases"] == 3
    assert r.stat["holders"] == 0


def test_completion_time_charging(built, tokend):
    """Mirrors test_completion_time_charging: the fake device runs each
    graph 50 ms while its launch returns at once; the charge follows the
    device (~150 ms), not the dispatch (well under 10 ms)."""
    r = run(built, tokend, "--graphs", 3, "--graph-us", 50_000)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 3
    assert 140 <= r.pod["charged_total_ms"] <= 200, r.pod


def test_a_lease_is_charged_to_its_work_not_to_its_return(built, tokend):
    """Five 20 ms kernels under one lease, then a pause that returns the
    lease for idleness 200 ms after the launches: the charge ends at the
    work's completion (~100 ms), not at the return (~200 ms)."""
    r = run(built, tokend, "--bursts", 1, "--burst", 5,
            "--kernel-us", 20_000, "--no-sync", "--pause-ms", 400)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 1
    assert 90 <= r.pod["charged_total_ms"] <= 130, r.pod


def test_a_lease_is_charged_its_work_not_the_gaps_inside_it(built, tokend):
    """Two 2 ms bursts 20 ms apart under one lease (its quota is 50 ms):
    the host's gap is no device time, so the lease is charged its two
    segments, ~4 ms, not the ~22 ms from its start to its end.  Each
    segment closes once the helper has seen 2 ms of quiet, which a
    loaded host delays: up to 15 ms is admitted, under the span."""
    r = run(built, tokend, "--bursts", 2, "--burst", 2, "--kernel-us", 1000,
            "--gap-ms", 20, "--sleep-ms", 300)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 1 and r.hook["segments"] == 2
    assert 3.5 <= r.pod["charged_total_ms"] <= 15, r.pod


def test_the_exit_settles_a_held_lease(built, tokend):
    """A process that exits with its lease held and its work in flight
    settles it: the broker is charged the work's 10 ms, not the full
    50 ms quota it charges an abandoned grant, and holds nothing."""
    r = run(built, tokend, "--bursts", 1, "--burst", 5,
            "--kernel-us", 2000, "--no-sync")
    assert r.rc == 0, r.err
    assert r.stat["holders"] == 0
    assert 8 <= r.pod["charged_total_ms"] < 0.8 * QUOTA_MS, r.pod


def test_an_idle_lease_is_returned(built, tokend_exclusive):
    """Mirrors the guard's test_idle_guard_returns_its_token: a pod that
    stops launching hands its lease back, and under the broker's
    exclusive mode another pod is granted while it idles."""
    broker = Pod(tokend_exclusive)
    proc = subprocess.Popen(
        [built["driver"], "--bursts", "1", "--pause-ms", "3000"],
        env=driver_env(built, broker.port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "burst 0 done"
        assert proc.stdout.readline().strip() == "idle"
        time.sleep(0.5)
        assert proc.poll() is None  # still running, no longer holding
        assert stat(tokend_exclusive)["holders"] == 0
        other = TokenClient("127.0.0.1", tokend_exclusive, "ns/pod-b")
        started = time.monotonic()
        assert other.acquire() > 0
        assert time.monotonic() - started < 1.0
        other.release(1.0)
        other.close()
    finally:
        proc.kill()
        proc.communicate(timeout=30)
        broker.stop()


def test_exclusive_mode_neither_deadlocks_nor_stalls(built, tokend_exclusive):
    """Eager bursts over two streams interleaved with graph launches,
    leases expiring between them, under the exclusive broker: each
    acquire waits for the helper's release of the grant before it, and
    the helper waits on completion markers alone, so the run ends."""
    started = time.monotonic()
    r = run(built, tokend_exclusive, "--exclusive-mix", "--streams", 2,
            "--gap-ms", 70, "--graph-us", 20_000, "--kernel-us", 1000,
            timeout=30)
    assert r.rc == 0, r.err
    assert r.has("mix done")
    assert time.monotonic() - started < 15
    assert r.pod["grants"] == 8  # four leases, four graph launches
    assert r.hook["graph_launches_in_lease"] == 0
    assert r.stat["holders"] == 0


def test_destroying_a_stream_settles_the_lease_that_used_it(built, tokend):
    r = run(built, tokend, "--bursts", 1, "--streams", 2, "--destroy-stream",
            HOOK_DRIVER_SETTLE=1)
    assert r.rc == 0, r.err
    assert r.has("streams destroyed")
    assert r.hook["lease_held"] is False and r.hook["pending"] == 0
    assert r.hook["releases"] == 1


# ---- memory ----------------------------------------------------------------

def test_hard_denial(built, tokend):
    """Mirrors test_hard_hbm_denial: an over-cap allocation returns
    CUDA_ERROR_OUT_OF_MEMORY (2) and never reaches the driver."""
    r = run(built, tokend, "--alloc", 2 * CAP)
    assert r.rc == 0, r.err
    assert r.has("alloc_denied rc=2")
    assert "device memory cap exceeded" in r.err
    assert "cuMemAlloc_v2" not in r.fake and r.fake["used"] == "0"
    assert r.hook["denials"] == 1 and r.pod["mem_used"] == 0


def test_soft_mode_logs_and_allows(built, tokend):
    """Mirrors test_soft_mode_logs_and_allows."""
    r = run(built, tokend, "--alloc", 1_500_000, TPUSHARE_MEM_ENFORCE="soft")
    assert r.rc == 0, r.err
    assert r.has("alloc_ok") and r.has("freed")
    assert "soft mode" in r.err
    assert r.hook["soft_overs"] == 1 and r.hook["denials"] == 0
    # the denied charge was never recorded, so never credited
    assert r.pod["mem_used"] == 0 and r.hook["credited_bytes"] == 0


@pytest.mark.parametrize("keep", [True, False])
def test_a_charge_persists_until_the_free(built, tokend, keep):
    """Mirrors test_within_cap_charge_persists_until_destroy; the free
    credits exactly the charge."""
    r = run(built, tokend, "--alloc", 500_000, *(["--keep"] if keep else []))
    assert r.rc == 0, r.err
    assert r.pod["mem_used"] == (500_000 if keep else 0)
    assert r.hook["credited_bytes"] == (0 if keep else 500_000)


def test_a_failed_allocation_rolls_its_charge_back(built, tokend):
    """The driver refuses the allocation: the charge is rolled back (the
    JAX shim's rule for a failed upload), and the pod is not over cap."""
    r = run(built, tokend, "--alloc", 400_000, FAKE_FAIL_ALLOC=1)
    assert r.rc == 0, r.err
    assert r.has("alloc_denied rc=2")
    assert r.hook["rolled_back_bytes"] == 400_000 and r.hook["denials"] == 0
    assert r.pod["mem_used"] == 0


def test_an_over_cap_second_allocation_is_denied(built, tokend):
    r = run(built, tokend, "--alloc", 400_000, "--keep", "--alloc-over",
            800_000)
    assert r.rc == 0, r.err
    assert r.has("alloc_ok") and r.has("alloc_over_denied rc=2")
    assert r.pod["mem_used"] == 400_000


def test_async_allocations_over_the_cap_are_denied(built, tokend):
    """Mirrors test_async_transfer_over_cap_denied."""
    r = run(built, tokend, "--async", 2 * CAP)
    assert r.rc == 0, r.err
    assert r.has("async rc=2") and r.pod["mem_used"] == 0


def test_async_allocations_are_credited_on_free(built, tokend):
    """Mirrors test_async_transfer_credited_on_destroy: an allocation at
    the cap after two freed ones at the cap succeeds only if both were
    credited."""
    r = run(built, tokend, "--alloc", CAP, "--async", CAP,
            "--pool-async", CAP)
    assert r.rc == 0, r.err
    assert r.has("alloc_ok") and r.has("async rc=0")
    assert r.has("async_free rc=0") and r.has("pool_async rc=0")
    assert r.hook["charged_bytes"] == 3 * CAP
    assert r.hook["credited_bytes"] == 3 * CAP
    assert r.pod["mem_used"] == 0


@pytest.mark.parametrize("keep", [True, False])
def test_vmm_allocations_are_charged_and_released(built, tokend, keep):
    """Mirrors test_dma_map_metered: cuMemCreate (PyTorch's expandable
    segments) is charged like an allocation and credited by
    cuMemRelease; over the cap it is denied."""
    r = run(built, tokend, "--vmm", 600_000, *(["--keep"] if keep else []))
    assert r.rc == 0, r.err
    assert r.has("vmm rc=0")
    assert r.pod["mem_used"] == (600_000 if keep else 0)
    over = run(built, tokend, "--vmm", 2 * CAP)
    assert over.has("vmm rc=2")


def test_pitched_and_managed_allocations(built, tokend):
    """A pitched allocation is charged its padded rows (the pitch is
    known after the call); a managed one its size; both credited."""
    r = run(built, tokend, "--pitch", 1000, 100, "--managed", 300_000)
    assert r.rc == 0, r.err
    assert r.has("pitch_ok pitch=1024") and r.has("managed rc=0")
    assert r.hook["charged_bytes"] == 1024 * 100 + 300_000
    assert r.hook["credited_bytes"] == r.hook["charged_bytes"]
    assert r.pod["mem_used"] == 0


def test_mem_get_info_reports_the_cap(built, tokend):
    """cuMemGetInfo_v2: the pod's cap (TPUSHARE_MEM_FRACTION of the card)
    as total, the cap less what is charged as free."""
    r = run(built, tokend, "--alloc", 300_000, "--keep", "--mem-info",
            TPUSHARE_MEM_FRACTION=0.5)  # the fake card: 2,000,000 bytes
    assert r.rc == 0, r.err
    assert r.has("mem_info rc=0 free=700000 total=1000000")


# ---- modes -----------------------------------------------------------------

def test_ungated_without_the_env(built):
    """Mirrors test_preload_ungated_without_env."""
    r = run(built, None, "--graphs", 3, "--bursts", 1, "--alloc", 4096,
            gated=False)
    assert r.rc == 0, r.err
    assert r.has("graphs 3 launched") and r.has("alloc_ok")
    assert "no POD_MANAGER_PORT, running ungated" in r.err
    assert r.hook["gated"] is False and r.hook["acquires"] == 0
    assert r.hook["graph_launches"] == 3 and r.hook["eager_launches"] == 11


def test_no_broker_at_start_runs_ungated(built):
    proc = subprocess.run(
        [built["driver"], "--graphs", "2", "--alloc", "4096"],
        env=driver_env(built, free_port()), capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "no broker at POD_MANAGER_PORT" in proc.stderr
    assert "graphs 2 launched" in proc.stdout


def test_a_broker_that_goes_away_fails_open(built, tmp_path):
    """The broker dies mid-run: later launches and allocations pass
    ungated instead of failing the pod's work."""
    tokend_proc, tokend_port = _start_tokend(tmp_path)
    broker = Pod(tokend_port)
    proc = subprocess.Popen(
        [built["driver"], "--bursts", "3", "--gap-ms", "300", "--graphs", "2",
         "--alloc", "4096"],
        env=driver_env(built, broker.port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "burst 0 done"
        broker.stop()
        tokend_proc.kill()
        tokend_proc.wait()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        broker.stop()
    assert proc.returncode == 0, err
    assert "burst 2 done" in out and "graphs 2 launched" in out
    assert "alloc_ok" in out
    hook_stats = json.loads(out.split("hook ", 1)[1].splitlines()[0])
    assert hook_stats["broker_errors"] > 0


# ---- resolution ------------------------------------------------------------

@pytest.mark.parametrize("path,seen", [("cudart", "proc_address"),
                                       ("dlsym", "dlsym"),
                                       ("direct", "direct")])
def test_every_resolution_path_is_hooked(built, tokend, path, seen):
    """The CUDA runtime's way (dlopen, dlsym of cuGetProcAddress_v2,
    everything through it), dlsym of each name, and the linked symbols:
    launches and allocations are gated and charged on each."""
    r = run(built, tokend, "--path", path, "--bursts", 1, "--graphs", 2,
            "--graph-us", 20_000, "--alloc", 300_000, "--keep")
    assert r.rc == 0, r.err
    assert r.hook["eager_launches"] == 11  # 10 and the graph's capture
    assert r.hook["graph_launches"] == 2 and r.hook["captured_launches"] == 1
    assert r.pod["grants"] >= 1 and r.pod["charged_total_ms"] >= 35
    assert r.pod["mem_used"] == 300_000
    assert r.hook["resolution"]["hook_driver"][seen] > 0


def test_per_thread_stream_variants(built, tokend):
    """With the per-thread flag the runtime receives the _ptsz forms;
    they are wrapped like the plain ones."""
    r = run(built, tokend, "--ptsz", "--bursts", 1, "--graphs", 2,
            "--graph-us", 5000, "--gap-ms", 0)
    assert r.rc == 0, r.err
    assert r.fake["cuLaunchKernel_ptsz"] == "11"
    assert r.fake["cuGraphLaunch_ptsz"] == "2"
    assert r.hook["eager_launches"] == 11 and r.hook["graph_launches"] == 2
    assert r.pod["grants"] >= 1


def test_version_mapping_and_symbols_passed_through(built, tokend):
    """cuGetProcAddress maps "cuMemAlloc" by version: the 32-bit v1 below
    3020 passes through untouched (and is never charged), cuMemAlloc_v2
    at 12080 is wrapped; an unhooked symbol comes back as the driver's
    own, an unknown one and a version too low with the driver's status;
    the four-argument cuGetProcAddress is wrapped too."""
    r = run(built, tokend, "--lookups")
    assert r.rc == 0, r.err
    for line in ("lookup cuMemAlloc@3010 passed=1 alloc_rc=0",
                 "lookup cuMemAlloc@12080 hooked=1",
                 "lookup cuLaunchKernel ptsz hooked=1",
                 "lookup ptsz launch rc=0",
                 "lookup cuDriverGetVersion rc=0 status=0 passed=1",
                 "lookup cuNoSuchEntryPoint rc=500 status=1 null=1",
                 "lookup cuMemAllocAsync@11000 rc=500 status=2",
                 "lookup cuGetProcAddress(4) hooked=1",
                 "lookup cuGraphLaunch via cuGetProcAddress(4) hooked=1",
                 "lookup cuGetProcAddress@12080 hooked=1"):
        assert r.has(line), (line, r.out)
    assert r.fake["cuMemAlloc"] == "1" and r.pod["mem_used"] == 0
    assert r.hook["charged_bytes"] == 0


def test_pointers_that_are_no_exported_symbol_are_mapped_by_name(built,
                                                                 tokend):
    """A driver whose cuGetProcAddress returns internal pointers: the
    hook maps the name, version and flags onto its wrapper instead."""
    r = run(built, tokend, "--graphs", 2, "--alloc", 400_000, "--keep",
            FAKE_PROC_INTERNAL=1)
    assert r.rc == 0, r.err
    assert r.pod["grants"] == 2 and r.pod["mem_used"] == 400_000
    assert r.hook["resolution"]["hook_driver"]["proc_address_by_name"] > 0


# ---- capture ---------------------------------------------------------------

def test_a_capture_sees_no_unsafe_call(built, tokend):
    """A lease is held when a global-mode capture begins, expires and
    idles during it (idle 200 ms, capture 600 ms), and eager launches run
    on another stream meanwhile: the hook enqueues nothing and queries
    nothing until the capture ends, so the fake driver, which fails any
    capture-unsafe call, keeps the capture valid."""
    r = run(built, tokend, "--capture", "--capture-ms", 600,
            HOOK_DRIVER_SETTLE=1)
    assert r.rc == 0, r.err
    assert r.has("capture_ok")
    assert r.fake["unsafe"] == "0"
    assert r.hook["captured_launches"] == 6
    assert r.stat["holders"] == 0 and r.hook["pending"] == 0


def test_the_fake_driver_fails_an_unsafe_call_in_a_capture(built, tokend):
    """The control: one cuStreamSynchronize inside the capture, and the
    fake invalidates it as the real driver does."""
    r = run(built, tokend, "--capture", "--unsafe-in-capture")
    assert r.rc == 0, r.err
    assert r.has("capture_failed rc=901")
    assert int(r.fake["unsafe"]) >= 1


# ---- counters --------------------------------------------------------------

def test_the_counters_file(built, tokend, tmp_path):
    """$CUDAHOOK_STATS at exit: launches by kernel name (a CUkernel
    handle named by cuKernelGetName), graph launches, grants, bytes."""
    path = tmp_path / "hook.json"
    r = run(built, tokend, "--kernel", 70000, "--bursts", 1, "--graphs", 3,
            "--alloc", 4096, CUDAHOOK_STATS=path)
    assert r.rc == 0, r.err
    stats = hook.read_stats(path)
    assert stats["kernels"] == {"library_kernel_70000": 11}
    assert stats["graph_launches"] == 3
    assert stats["charged_bytes"] == 4096 == stats["credited_bytes"]
    assert stats["acquires"] == r.pod["grants"]
    assert stats["pending"] == 0 and stats["lease_held"] is False
    assert stats["charged_ms"] == pytest.approx(r.pod["charged_total_ms"],
                                                abs=0.01)


def test_hook_env_and_constants():
    env = hook.hook_env(4242, "ns/pod-a", mem_fraction=0.25,
                        stats_path="/tmp/s.json", library="/x/libcudahook.so.1")
    assert env == {"LD_PRELOAD": "/x/libcudahook.so.1",
                   "POD_MANAGER_PORT": "4242", "POD_NAME": "ns/pod-a",
                   "POD_MANAGER_IP": "127.0.0.1",
                   "TPUSHARE_MEM_FRACTION": "0.2500",
                   "CUDAHOOK_STATS": "/tmp/s.json"}
    assert constants.ENV_SHIM_PRELOAD == jax_constants.ENV_SHIM_PRELOAD
    assert constants.SHIM_LIBRARY == (jax_constants.LIBRARY_PATH
                                      + "/libcudahook.so.1")


def test_live_stats_need_the_hook_loaded():
    with pytest.raises(RuntimeError, match="not loaded"):
        hook.live_stats()


# ---- parity with the JAX shim ----------------------------------------------

JAX_BUILD = os.path.join(os.path.dirname(__file__), "..", "native", "build")
PARITY_K, PARITY_D_MS, PARITY_B = 3, 40, 400_000
# the fake clocks sleep per program: each side's charge is K x D plus its
# own scheduling noise, so the two agree within this
PARITY_CHARGE_TOL_MS = 0.25 * PARITY_K * PARITY_D_MS


def _jax_run(tokend_port, keep):
    """The JAX shim over its fake PJRT plugin: K executions of D ms, an
    upload of B bytes, a copy of 2B (over the cap when B is kept)."""
    paths = [os.path.abspath(os.path.join(JAX_BUILD, name)) for name in
             ("libtpushim.so.1", "fake_pjrt_plugin.so", "interposer_driver")]
    if not all(os.path.exists(p) for p in paths):
        pytest.skip("interposer fixtures not built "
                    "(make -C native test-fixtures)")
    shim, plugin, driver = paths
    broker = Pod(tokend_port)
    try:
        args = [driver, plugin, str(PARITY_K), "--upload-bytes",
                str(PARITY_B), "--sleep-ms", "400"]
        if keep:
            args += ["--keep-buffer", "--copy"]
        proc = subprocess.run(
            args, env=dict(os.environ, LD_PRELOAD=shim,
                           POD_MANAGER_IP="127.0.0.1",
                           POD_MANAGER_PORT=str(broker.port),
                           POD_NAME="ns/pod-a", FAKE_DEVICE_MS=str(PARITY_D_MS),
                           FAKE_OUTPUT_BYTES=str(2 * PARITY_B)),
            capture_output=True, text=True, timeout=60)
    finally:
        broker.stop()
    assert proc.returncode == 0, proc.stderr
    denials = proc.stdout.count("_denied")
    return stat(tokend_port)["pods"]["ns/pod-a"], denials


def _port_run(built, tokend_port, keep):
    args = ["--graphs", PARITY_K, "--graph-us", PARITY_D_MS * 1000,
            "--alloc", PARITY_B]
    if keep:
        args += ["--keep", "--alloc-over", 2 * PARITY_B]
    r = run(built, tokend_port, *args, "--sleep-ms", 400)
    assert r.rc == 0, r.err
    return r.pod, r.out.count("_denied")


@pytest.mark.parametrize("keep", [True, False])
def test_the_tokend_ledger_equals_the_jax_shims(built, tmp_path, keep):
    """One scenario through both shims, each on a fresh tokend: K=3
    executions (graph launches) of D=40 ms, B bytes allocated within the
    cap, then (kept) 2B more over it, or (not kept) the free.  Grants,
    mem_used and the denials are equal; the charged ms agree within
    PARITY_CHARGE_TOL_MS."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    procs = []
    try:
        proc, jax_port = _start_tokend(jax_dir)
        procs.append(proc)
        jax_pod, jax_denials = _jax_run(jax_port, keep)
        proc, port_port = _start_tokend(port_dir)
        procs.append(proc)
        port_pod, port_denials = _port_run(built, port_port, keep)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    assert port_pod["grants"] == jax_pod["grants"] == PARITY_K
    assert port_pod["mem_used"] == jax_pod["mem_used"] == \
        (PARITY_B if keep else 0)
    assert port_denials == jax_denials == (1 if keep else 0)
    assert abs(port_pod["charged_total_ms"] - jax_pod["charged_total_ms"]) \
        <= PARITY_CHARGE_TOL_MS, (port_pod, jax_pod)
