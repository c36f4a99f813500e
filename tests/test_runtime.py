"""Process-level setup: the platform decision, the compile cache, the
loader's worker processes, and chip_smoke.py's refusal to run without a
GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from sessionsimilaritysearch import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- platform ---------------------------------------------------------------
@pytest.mark.parametrize(
    "platform,asked,ok",
    [
        ("gpu", "cuda,cpu", True),
        ("gpu", None, True),
        ("cpu", "cpu", True),  # the CPU, asked for explicitly
        ("cpu", "cuda,cpu", False),  # silent fallback from a failed GPU
        ("cpu", None, False),
        ("rocm", None, False),
    ],
)
def test_decide_platform(platform, asked, ok):
    if ok:
        assert runtime.decide_platform(platform, asked) == platform
    else:
        with pytest.raises(RuntimeError, match="expected a GPU"):
            runtime.decide_platform(platform, asked)


def test_require_platform_accepts_forced_cpu():
    assert runtime.require_platform() == "cpu"  # conftest forces the CPU


def test_force_platform_rejects_unknown():
    with pytest.raises(ValueError, match="unknown platform"):
        runtime.force_platform("rocm")


def test_cli_rejects_unknown_platform(capsys):
    from sessionsimilaritysearch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "rocm", "etl"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_cli_runs_on_forced_cpu(tmp_path, capsys, monkeypatch):
    from sessionsimilaritysearch import cli

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: "")
    cli.main(["--platform", "cpu", "etl", "--tiny", "--num-sessions", "6",
              "--out", str(tmp_path / "etl")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sessions"] == 6


# --- compile cache ----------------------------------------------------------
@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert runtime.enable_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch,
                                                   restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.enable_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert runtime.enable_compile_cache() == first  # stable across calls
    assert jax.config.jax_compilation_cache_dir == first


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- worker processes -------------------------------------------------------
def test_loader_workers_pin_jax_to_cpu(monkeypatch, tiny_cfg, tokenizer):
    from sessionsimilaritysearch.data import loader

    monkeypatch.setenv("JAX_PLATFORMS", "cuda,cpu")
    monkeypatch.setattr(loader, "_POOL_STATE", {})
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    calls = []
    loader._pool_init([], tokenizer, tiny_cfg.dims, True)
    assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert ("jax_platforms", "cpu") in calls


# --- chip_smoke.py ----------------------------------------------------------
def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "expected a GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture
def gpu_available():
    """Whether a GPU backend starts in a fresh process (this one is pinned
    to the CPU)."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
        capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_available):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


# --- published peaks --------------------------------------------------------
class _Dev:
    def __init__(self, platform, device_kind):
        self.platform, self.device_kind = platform, device_kind


def test_peak_bf16_flops_known_card():
    assert runtime.peak_bf16_flops(
        _Dev("gpu", "NVIDIA H100 80GB HBM3")) == 989e12
    assert runtime.peak_bf16_flops(jax.devices()[0]) is None  # the CPU


def test_peak_bf16_flops_rejects_unknown_card():
    with pytest.raises(KeyError, match="no published bf16 peak"):
        runtime.peak_bf16_flops(_Dev("gpu", "Some Other GPU"))
