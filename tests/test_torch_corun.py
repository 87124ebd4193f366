"""corun_bench.py, the port's twin of bench.py's train and serve suites,
on the CPU: one worker's loop in-process against a real tpushare-tokend
(a trainer and a decode pod), one phase with a worker process, the serve
suite's three phases with worker processes, a worker that cannot reach
the card failing its phase, and the metric's arithmetic on fixed
inputs."""

import argparse
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import corun_bench  # noqa: E402

torch.set_num_threads(1)

RESULT_FIELDS = {"steps", "rate_steps_per_s", "gated_ms",
                 "tokens", "step_ms", "breakdown_ms", "io_wait_ms"}


@pytest.fixture
def tokend_binary():
    from kubeshare_tpu_torch.runtime import find_binary

    binary = find_binary("tpushare-tokend")
    if binary is None:
        pytest.skip("tpushare-tokend not built (make -C native)")
    return binary


@pytest.fixture
def tokend(tmp_path, tokend_binary):
    import subprocess

    from native_helpers import free_port, wait_listening

    (tmp_path / "card-0").write_text("1\nbench/pod-a 1.0 0.5 0\n")
    port = free_port()
    proc = subprocess.Popen(
        [tokend_binary, "-p", str(tmp_path), "-f", "card-0", "-P", str(port),
         "-q", "300", "-m", "20", "-w", "10000"], stderr=subprocess.DEVNULL)
    wait_listening(port)
    yield port
    proc.kill()
    proc.wait()


def test_worker_loop_in_process(tmp_path, tokend, capsys, monkeypatch):
    monkeypatch.setattr(corun_bench, "BATCH", 8)  # 512 is slow on the CPU
    barrier = tmp_path / "barrier"
    barrier.touch()  # released at once
    # at duty 0.5 the window gates ~0.4 s: the warm-up's 300 ms grant runs
    # out inside it, so the window counts a grant of its own
    args = argparse.Namespace(
        device="cpu", tokend_port=tokend, pod_name="bench/pod-a",
        seconds=0.8, io_wait_ms=0.0, calibrate_io=True, warmup_s=0.2,
        barrier=str(barrier))
    corun_bench.worker_main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:4] == ["PHASE importing", "PHASE imported",
                         "PHASE device-ready cpu cpu", "PHASE compiled"]
    assert lines[4] == "READY"
    result = json.loads(lines[-1])
    assert set(result) == RESULT_FIELDS
    assert result["tokens"] > 0 and result["steps"] > 0
    assert result["rate_steps_per_s"] > 0
    assert set(result["breakdown_ms"]) == {"io_ms", "wait_ms", "compute_ms"}
    # the calibrated wait is the measured ungated step, and each step's
    # input wait lasts it, not less
    assert result["step_ms"] > 0
    assert result["io_wait_ms"] == result["step_ms"]
    assert (result["breakdown_ms"]["io_ms"]
            >= result["steps"] * result["io_wait_ms"])
    assert 0 < result["gated_ms"] <= result["breakdown_ms"]["compute_ms"] + 1


DECODE_FIELDS = {"steps", "rate_steps_per_s", "new_tokens_per_request",
                 "gated_ms", "tokens", "step_ms", "io_wait_ms", "lat_p50_ms",
                 "lat_p95_ms", "lat_mean_ms"}


def test_decode_worker_in_process(tmp_path, tokend, capsys):
    barrier = tmp_path / "barrier"
    barrier.touch()
    args = argparse.Namespace(
        device="cpu", tokend_port=tokend, pod_name="bench/pod-a",
        seconds=0.5, io_wait_ms=0.0, calibrate_io=True, warmup_s=0.0,
        barrier=str(barrier))
    corun_bench.worker_decode_main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:5] == ["PHASE importing", "PHASE imported",
                         "PHASE device-ready cpu cpu", "PHASE compiled",
                         "READY"]
    result = json.loads(lines[-1])
    assert set(result) == DECODE_FIELDS
    batch, _, new = corun_bench.SERVE_SMOKE_SHAPE
    assert result["new_tokens_per_request"] == batch * new
    # the pod returns its token after every request, so each request is
    # granted one
    assert result["steps"] > 0 and result["tokens"] == result["steps"]
    assert result["io_wait_ms"] == result["step_ms"] > 0
    assert 0 < result["lat_p50_ms"] <= result["lat_p95_ms"]
    assert result["lat_p50_ms"] >= 0.5 * result["step_ms"]


def test_serve_corun_phase_runs_both_pods(tokend_binary):
    # the serve suite's co-run: two decode pod processes under one tokend
    phase = corun_bench.Phase(["bench/pod-a", "bench/pod-b"], tokend_binary,
                              seconds=0.5, io_wait_ms=1.0, device="cpu",
                              suite="serve")
    results = phase.run()
    assert phase.device_kind == "cpu" and len(results) == 2
    for result in results:
        assert set(result) == DECODE_FIELDS
        assert result["tokens"] > 0 and result["steps"] > 0


def test_serve_suite_reports_tokens_per_s(monkeypatch):
    # the suite's phases and arithmetic on canned pod results, 16 tokens a
    # request: solo pods at 2 and 3 requests/s (service 10 and 20 ms),
    # co-run pods at 1.5 and 2
    def pod(rate, service_ms=None):
        return {"rate_steps_per_s": rate, "new_tokens_per_request": 16,
                "steps": 4, "tokens": 4, "step_ms": service_ms,
                "lat_p50_ms": 1.0, "lat_p95_ms": 2.0}

    canned = [[pod(2.0, 10.0)], [pod(3.0, 20.0)], [pod(1.5), pod(2.0)]]
    runs = []

    def run(phase):
        runs.append((phase.suite, [p["name"] for p in phase.pods],
                     phase.calibrate_io, phase.io_wait_ms))
        phase.device_kind, phase.phase_timings = "cpu", []
        return canned[len(runs) - 1]

    monkeypatch.setattr(corun_bench.Phase, "run", run)
    result = corun_bench.run_serve_suite("tokend", seconds=1.0, device="cpu")
    assert runs == [("serve", ["bench/pod-a"], True, 0.0),
                    ("serve", ["bench/pod-b"], True, 0.0),
                    ("serve", ["bench/pod-a", "bench/pod-b"], False, 15.0)]
    detail = result["detail"]
    assert detail["solo_tokens_per_s"] == [32.0, 48.0]
    assert detail["corun_tokens_per_s"] == [24.0, 32.0]
    assert result["value"] == pytest.approx(56.0 / 80.0)
    assert detail["tokens"] == {"solo_a": 4, "solo_b": 4, "corun": [4, 4]}


def test_phase_runs_a_worker_process(tokend_binary):
    phase = corun_bench.Phase(
        ["bench/pod-a"], tokend_binary, seconds=0.3,
        io_wait_ms=1.0, device="cpu", extra_rows=["bench/pod-b 1.0 0.5 0"])
    (result,) = phase.run()
    assert set(result) == RESULT_FIELDS
    assert result["tokens"] > 0 and result["step_ms"] is None
    assert phase.device_kind == "cpu"
    assert list(phase.phase_timings[0]) == corun_bench.PHASE_ORDER


def test_worker_without_a_card_fails_its_phase(tokend_binary, monkeypatch):
    # the default device is the card: a worker that finds none exits at
    # device-ready, and the phase fails (no CPU fallback)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    phase = corun_bench.Phase(["bench/pod-a"], tokend_binary, seconds=0.3,
                              io_wait_ms=1.0)
    with pytest.raises(corun_bench.WorkerFailure,
                       match="before 'device-ready'") as failure:
        phase.run()
    assert "no CUDA device" in failure.value.diagnostics["stderr"]


def _pod(rate, **fields):
    return {"rate_steps_per_s": rate, **fields}


def test_corun_ratio():
    assert corun_bench.corun_ratio(_pod(100.0), _pod(50.0),
                                   [_pod(60.0), _pod(75.0)]) == 0.9
    assert corun_bench.corun_ratio(_pod(0.0), _pod(0.0), [_pod(1.0)]) == 0.0


@pytest.mark.parametrize("gated_ms,victim_rate,clamped,held", [
    (5200.0, 45.0, True, True),   # duty 0.52 within 0.05; 90% retained
    (5600.0, 45.0, False, True),  # duty 0.56 over the limit
    (4000.0, 44.0, True, False),  # 88% of solo
])
def test_adversarial_summary(gated_ms, victim_rate, clamped, held):
    summary = corun_bench.adversarial_summary(
        [_pod(victim_rate, gated_ms=1.0, steps=1),
         _pod(80.0, gated_ms=gated_ms, steps=420)],
        victim_solo_rate=50.0, measure_s=10.0)
    assert summary["greedy_achieved_duty"] == pytest.approx(gated_ms / 1e4)
    assert summary["victim_retention"] == pytest.approx(victim_rate / 50.0)
    assert summary["greedy_steps"] == 420
    assert summary["limit_clamped"] is clamped
    assert summary["floor_held"] is held
