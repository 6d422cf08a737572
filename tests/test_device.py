"""Device selection, the compile cache, and one card per pool worker."""

import os
import shutil
import subprocess
import sys

import pytest

from centrolign_tpu import device
from centrolign_tpu.parallel.scheduler import worker_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_use_device_switch(monkeypatch):
    monkeypatch.delenv("CENTROLIGN_TPU_USE_DEVICE", raising=False)
    assert device.use_device()
    monkeypatch.setenv("CENTROLIGN_TPU_USE_DEVICE", "0")
    assert not device.use_device()


def test_device_kind_names_the_device():
    info = device.device_kind()
    assert info == {"platform": "cpu", "kind": info["kind"],
                    "count": info["count"]}
    assert info["kind"] and info["count"] >= 1
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu()


@pytest.mark.parametrize("script,args", [("bench.py", []),
                                         ("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--four-cards"])])
def test_scripts_refuse_without_gpu(script, args):
    """No CPU fallback: the measurement scripts fail and print no result
    when JAX finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"value"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository exits non-zero."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        device.configure_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_visible_cards_from_env(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert device.visible_cards() == ["2", "5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert device.visible_cards() == []


@pytest.mark.parametrize("n_workers,cards,expect", [
    (4, ["0", "1", "2", "3"],
     [{"CUDA_VISIBLE_DEVICES": c} for c in "0123"]),
    (2, ["0", "1", "2", "3"],
     [{"CUDA_VISIBLE_DEVICES": "0"}, {"CUDA_VISIBLE_DEVICES": "1"}]),
    (3, ["7"], [{"CUDA_VISIBLE_DEVICES": "7",
                 "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.300"}] * 3),
    (3, ["0", "1"], [{"CUDA_VISIBLE_DEVICES": "0",
                      "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.450"},
                     {"CUDA_VISIBLE_DEVICES": "1"},
                     {"CUDA_VISIBLE_DEVICES": "0",
                      "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.450"}]),
    (2, [], [{}, {}]),
])
def test_worker_env(n_workers, cards, expect):
    """One card per worker, round robin; workers that share a card split
    its memory; no card, no setting."""
    assert [worker_env(i, n_workers, cards)
            for i in range(n_workers)] == expect


def test_worker_counters_merge():
    """A pool worker's aligner counters add into the main process's, so a
    --hosts run's summary counts the device cells its workers filled."""
    from centrolign_tpu import metrics
    metrics.reset()
    metrics.record("pod", 100, 0.5)
    metrics.merge({"pod": [2, 300, 0.25], "po": [1, 7, 0.0]})
    summ = metrics.summary()
    assert summ["pod"] == {"count": 3, "cells": 400, "seconds": 0.75}
    assert summ["po"]["cells"] == 7 and summ["device_cells"] == 400
    metrics.reset()
