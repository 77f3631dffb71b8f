"""Process set-up (gr_lora_tpu.runtime) and the entry points' refusal to
measure anything but a GPU."""

import json
import sys
from pathlib import Path

import jax
import pytest

from gr_lora_tpu import runtime


@pytest.fixture
def cache_dir_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_repo_dir(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parents[1]
    want = str(repo / ".jax_cache")
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # A fixed path: the same on every call, in every process.
    assert runtime.enable_compile_cache() == want


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_require_gpu_refuses_the_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu("x")


def test_require_gpu_returns_the_gpu(monkeypatch):
    dev = _FakeDevice("gpu", "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    assert runtime.require_gpu("x") is dev


@pytest.mark.parametrize("script", ["bench", "chip_smoke"])
def test_entry_points_refuse_the_cpu(script, monkeypatch, capsys):
    """bench.py and chip_smoke.py exit non-zero on a CPU-only machine and
    print no result line."""
    mod = __import__(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py"])
    with pytest.raises(SystemExit) as e:
        mod.main()
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_chip_smoke_last_line_shape(monkeypatch, capsys):
    """With every phase stubbed, the last stdout line is the contract's
    JSON object, device as JAX reports it."""
    import chip_smoke

    dev = _FakeDevice("gpu", "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    calls = []
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda count: calls.append("device") or dev)
    for name in ("phase_lattice", "phase_north_star", "phase_cli"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    assert chip_smoke.main([]) == 0
    assert calls == ["device", "phase_lattice", "phase_north_star",
                     "phase_cli"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
