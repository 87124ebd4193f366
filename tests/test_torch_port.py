"""Port hygiene: kubeshare_tpu_torch imports neither jax nor the JAX
package, refuses to drop quietly to the CPU, and keeps CPU tensors off
the kernel; chip_smoke.py fails without a card and without the repo."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import kubeshare_tpu_torch
from kubeshare_tpu_torch import entry as port_entry
from kubeshare_tpu_torch.ops import attention

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "kubeshare_tpu_torch"


def _python(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    # no card visible to the child, whatever the host has
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    # conftest imports jax into this process, so check in a fresh one
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import kubeshare_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            kubeshare_tpu_torch.__path__, "kubeshare_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 8, names
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "kubeshare_tpu"
                     or m.startswith("kubeshare_tpu."))
        assert not bad, bad
        print("imported", len(names))
    """)
    proc = _python(REPO, "-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_port_sources_call_no_library_attention():
    # the port's own kernels only: no fused library attention, no compile
    banned = ("scaled_dot_product_attention", "torch.compile",
              "flash_attn", "cudnn")
    for path in PACKAGE.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            for word in banned:
                assert word not in text, f"{path.name} mentions {word}"


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kubeshare_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    assert kubeshare_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(attention.flash_forward, "launches", 0)

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(attention, "_flash_forward_cuda", no_build)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 16, 64), generator=gen) for _ in range(3))
    out = attention.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(
        out, attention.flash_forward_reference(q, k, v, True)[0],
        rtol=0, atol=0)
    assert attention.flash_forward.launches == 0


def test_flagship_config_mirrors_the_graft_entry():
    cfg = port_entry.flagship_config()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.max_seq_len) == (2048, 512, 8, 4, 1408, 1024)
    assert cfg.dtype == torch.bfloat16 and cfg.attention == "auto"
    assert cfg.head_dim in attention.KERNEL_HEAD_DIMS


def test_chip_smoke_fails_without_a_card(tmp_path):
    # with no CUDA device the script must exit non-zero and print no
    # result, both in the repo and alone in a directory
    proc = _python(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _python(tmp_path, "chip_smoke.py")
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_kernel_build_is_keyed_by_source(tmp_path, monkeypatch):
    from kubeshare_tpu_torch.ops import _build

    first = _build.library_path("flash_fwd")
    assert first.parent == PACKAGE / "_build"
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "flash_fwd.cu").write_text("// another source\n")
    assert _build.library_path("flash_fwd") != first
