"""The port's sharing runtime: ExecutionGuard and the token clients against
a real tpushare-tokend over TCP (as tests/test_native_runtime.py's
TestGuard drives the JAX guard), apply_hbm_cap's parsing, and the copied
constants and metrics encoder against the JAX package's."""

import threading
import time

import pytest
import torch

from kubeshare_tpu import constants as jax_constants
from kubeshare_tpu.utils import promtext as jax_promtext
from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.isolation import (
    ExecutionGuard,
    GangTokenClient,
    TokenClient,
    apply_hbm_cap,
    connect_from_env,
    token_gated,
)
from kubeshare_tpu_torch.isolation import guard as guard_module
from kubeshare_tpu_torch.runtime import find_binary
from kubeshare_tpu_torch.utils import promtext

from native_helpers import free_port, wait_listening

torch.set_num_threads(1)


def _start_tokend(tmp_path, exclusive=False):
    binary = find_binary("tpushare-tokend")
    if binary is None:
        pytest.skip("tpushare-tokend not built (make -C native)")
    config_dir = tmp_path / "config"
    config_dir.mkdir(exist_ok=True)
    (config_dir / "chip-0").write_text(
        "2\nns/pod-a 1.0 0.5 1000000\nns/pod-b 1.0 0.3 500000\n")
    port = free_port()
    cmd = [binary, "-p", str(config_dir), "-f", "chip-0", "-P", str(port),
           "-q", "50", "-m", "5", "-w", "1000"]
    if exclusive:
        cmd.append("-x")
    import subprocess

    proc = subprocess.Popen(cmd, stderr=subprocess.DEVNULL)
    wait_listening(port)
    return proc, port


@pytest.fixture
def tokend(tmp_path):
    """Concurrent-mode tokend, two pods at 0.5 / 0.3, quota 50 ms."""
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


def test_guard_gates_and_measures(tokend):
    client = TokenClient("127.0.0.1", tokend, "ns/pod-a")
    guard = ExecutionGuard(client=client, from_env=False)
    calls = []

    @guard
    def step(x):
        calls.append(x)
        time.sleep(0.005)
        return x * 2

    assert guard.gated
    assert step(21) == 42 and calls == [21]
    assert guard.tokens_acquired == 1
    assert guard.total_gated_ms >= 5.0
    guard.finish()
    assert '"ns/pod-a"' in client.stat()
    client.close()


def test_guard_waits_for_a_tensor_result(tokend):
    # the result's device is synchronized (a no-op for CPU tensors): the
    # gated step returns its tensors unchanged
    client = TokenClient("127.0.0.1", tokend, "ns/pod-a")
    guard = ExecutionGuard(client=client, from_env=False)
    x = torch.arange(4.0)

    @guard
    def step(t):
        return {"loss": t.sum()}, [t * 2]

    out, (doubled,) = step(x)
    assert float(out["loss"]) == 6.0
    torch.testing.assert_close(doubled, x * 2)
    assert guard.tokens_acquired == 1
    guard.finish()
    client.close()


def test_guard_passthrough_without_broker(monkeypatch):
    monkeypatch.delenv(constants.ENV_POD_MANAGER_PORT, raising=False)
    guard = ExecutionGuard(client=None, from_env=False)
    assert not guard.gated

    def step(x):
        return x + 1

    assert guard(step) is step
    assert guard.acquire() == 0.0
    guard.charge(5.0)
    assert guard.total_gated_ms == 0.0
    # env-configured and unmanaged: the decorator leaves the step alone
    assert token_gated(step) is step


def test_guard_runs_ungated_when_the_broker_is_unreachable(monkeypatch):
    monkeypatch.setenv(constants.ENV_POD_MANAGER_PORT, str(free_port()))
    monkeypatch.setenv("POD_MANAGER_IP", "127.0.0.1")
    guard = ExecutionGuard()
    assert not guard.gated


def test_guard_reuses_a_token_while_its_budget_holds(tokend):
    client = TokenClient("127.0.0.1", tokend, "ns/pod-a")
    guard = ExecutionGuard(client=client, from_env=False)
    quota = guard.acquire()
    assert quota > 0
    guard.charge(1.0)
    # steps of 1 ms against a quota of tens of ms: one grant funds them all
    for _ in range(5):
        guard.acquire()
        guard.charge(1.0)
    assert guard.tokens_acquired == 1
    # a step that drains the budget below half an estimate releases the
    # token at the step boundary, and the next step asks again
    guard.acquire()
    guard.charge(quota)
    assert not guard._held
    guard.acquire()
    assert guard.tokens_acquired == 2
    guard.charge(1.0)
    guard.finish()
    client.close()


def test_idle_guard_returns_its_token(tokend_exclusive):
    a = TokenClient("127.0.0.1", tokend_exclusive, "ns/pod-a")
    guard = ExecutionGuard(client=a, from_env=False, idle_release_ms=100)
    guard.acquire()
    guard.charge(1.0)  # budget remains: the token stays held
    b = TokenClient("127.0.0.1", tokend_exclusive, "ns/pod-b")
    granted = []

    def try_b():
        b.acquire()
        granted.append(1)
        b.release(1.0)

    t = threading.Thread(target=try_b)
    t.start()
    time.sleep(0.05)
    assert not granted  # still held
    t.join(timeout=5)  # the idle monitor releases within ~100 ms
    assert not t.is_alive() and granted
    a.close()
    b.close()


def test_no_idle_release_while_a_step_is_in_flight(tokend_exclusive):
    a = TokenClient("127.0.0.1", tokend_exclusive, "ns/pod-a")
    guard = ExecutionGuard(client=a, from_env=False, idle_release_ms=80)
    guard.acquire()  # a step begins (a first step's capture, say)
    time.sleep(0.4)
    b = TokenClient("127.0.0.1", tokend_exclusive, "ns/pod-b")
    granted = []
    t = threading.Thread(target=lambda: (b.acquire(), granted.append(1),
                                         b.release(1.0)))
    t.start()
    time.sleep(0.1)
    assert not granted  # held through the step in flight
    guard.charge(1.0)
    t.join(timeout=5)
    assert not t.is_alive() and granted
    a.close()
    b.close()


def test_connect_from_env(tokend, monkeypatch):
    monkeypatch.setenv(constants.ENV_POD_MANAGER_PORT, str(tokend))
    monkeypatch.setenv(constants.ENV_POD_NAME, "ns/pod-b")
    monkeypatch.setenv("POD_MANAGER_IP", "127.0.0.1")
    client = connect_from_env()
    assert isinstance(client, TokenClient) and client.pod_name == "ns/pod-b"
    assert client.acquire() > 0
    client.release(1.0)
    client.close()
    # a gang pod: one broker per chip, comma-separated
    monkeypatch.setenv(constants.ENV_POD_MANAGER_PORT, f"{tokend},{tokend}")
    gang = connect_from_env()
    assert isinstance(gang, GangTokenClient) and len(gang.clients) == 2
    gang.close()
    monkeypatch.delenv(constants.ENV_POD_MANAGER_PORT)
    assert connect_from_env() is None


def test_client_memory_ledger_and_metrics(tokend):
    client = TokenClient("127.0.0.1", tokend, "ns/pod-b")
    ok, used, cap = client.request_memory(1000)
    assert ok and used == 1000 and cap == 500000
    ok, _, _ = client.request_memory(10**9)
    assert not ok
    client.request_memory(-1000)
    families = client.collect_metrics()
    assert families[0].name == "kubeshare_tokend_retries_total"
    assert "kubeshare_tokend_retries_total" in families[0].encode()
    client.close()


@pytest.mark.parametrize("raw,want", [
    ("0.5000", 0.5), ("1.0", 1.0), ("0.25", 0.25), (None, None), ("", None),
    ("half", None), ("0", None), ("-0.5", None), ("2.0", None),
])
def test_apply_hbm_cap_parses_like_the_jax_guard(raw, want, monkeypatch):
    env = {} if raw is None else {"TPUSHARE_MEM_FRACTION": raw}
    before = dict(env)
    installed = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda *args: installed.append(args))
    assert apply_hbm_cap(env, device="cpu") == want
    # the port installs the allocator fraction, not XLA's client flags
    assert env == before and not installed


def test_apply_hbm_cap_sets_the_allocator_fraction_on_cuda(monkeypatch):
    installed = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda fraction, device: installed.append(
                            (fraction, device)))
    env = {"TPUSHARE_MEM_FRACTION": "0.5"}
    assert apply_hbm_cap(env, device="cuda:0") == 0.5
    assert installed == [(0.5, torch.device("cuda", 0))]
    monkeypatch.setenv("TPUSHARE_MEM_FRACTION", "0.3")
    assert apply_hbm_cap(device="cuda:1") == 0.3
    assert installed[-1] == (0.3, torch.device("cuda", 1))


def test_synchronize_waits_on_each_cuda_device_of_a_result(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    cpu = torch.zeros(1)
    guard_module._synchronize((cpu, [cpu], {"a": cpu}))
    assert waited == []
    fake = torch.empty(1, device="meta")  # neither CPU nor CUDA: ignored
    guard_module._synchronize({"x": fake})
    assert waited == []
    guard_module._synchronize(({"a": _on_card(cpu, 1)}, [_on_card(cpu, 0)]))
    assert sorted(d.index for d in waited) == [0, 1]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that the walk's choice
    of devices shows without a card."""

    @property
    def device(self):
        return torch.device("cuda", self._index)


def _on_card(tensor, index=0):
    fake = tensor.as_subclass(_OnCard)
    fake._index = index
    return fake


def _train_state(params):
    from kubeshare_tpu_torch.parallel.train import TrainState

    leaves = [params["w"]]
    return TrainState(params=params, step=0,
                      opt_state=torch.optim.SGD(leaves, lr=0.1))


def test_synchronize_walks_a_train_state(monkeypatch):
    # a step that returns only its state (a dataclass) is waited for on
    # its parameters' device
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    weight = _on_card(torch.zeros(2)).requires_grad_()
    state = _train_state({"w": weight})
    assert any(t is weight for t in guard_module._tensors(state))
    guard_module._synchronize(state)
    assert waited == [torch.device("cuda", 0)]


@pytest.mark.parametrize("result", [None, 3.0, object()])
def test_synchronize_without_a_tensor_waits_for_the_current_device(
        result, monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    guard_module._synchronize(result)
    assert waited == []  # CUDA not in use: nothing to wait for
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    guard_module._synchronize(result)
    assert waited == [torch.device("cuda", 2)]


def test_guard_charges_a_step_that_returns_its_state(tokend, monkeypatch):
    # the gated time covers the wait for the state's device: the guard
    # charges the device burst, not only the host's enqueue
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device: time.sleep(0.02))
    client = TokenClient("127.0.0.1", tokend, "ns/pod-a")
    guard = ExecutionGuard(client=client, from_env=False)
    state = _train_state({"w": _on_card(torch.zeros(2)).requires_grad_()})

    @guard
    def step(state):
        return state

    assert step(state) is state
    assert guard.tokens_acquired == 1
    assert guard.total_gated_ms >= 20.0
    guard.finish()
    client.close()


def test_constants_keep_the_jax_strings():
    for name in ("ENV_MEM_FRACTION", "ENV_POD_MANAGER_PORT", "ENV_POD_NAME",
                 "LIBRARY_PATH", "SCHEDULER_IP_FILE", "TOKEN_BASE_QUOTA_MS",
                 "TOKEN_MIN_QUOTA_MS", "TOKEN_WINDOW_MS"):
        assert getattr(constants, name) == getattr(jax_constants, name), name


def test_promtext_encodes_as_the_jax_copy():
    samples = [("up", {"pod": 'a"b'}, 1.0), ("ratio", {}, 0.25),
               ("inf", {"k": "v"}, float("inf"))]
    port = promtext.MetricFamily("m", "help", "gauge", [
        promtext.Sample(*s) for s in samples]).encode()
    ref = jax_promtext.MetricFamily("m", "help", "gauge", [
        jax_promtext.Sample(*s) for s in samples]).encode()
    assert port == ref
