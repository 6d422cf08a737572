"""Device selection and the persistent compile cache.

The device path runs on JAX's default backend; a device error propagates.
``CENTROLIGN_TPU_USE_DEVICE=0`` is the explicit native-only switch: every
gap then runs on the native engines and JAX is never imported for them.
"""

from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_device() -> bool:
    """False only when the user asked for the native path."""
    return os.environ.get("CENTROLIGN_TPU_USE_DEVICE", "1") != "0"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def configure_compile_cache() -> None:
    """Point JAX's persistent compile cache at compile_cache_dir(). The
    directory is passed through jax.config because the environment
    variable alone was not honoured. Called by every kernel module before
    it compiles; the native path never imports JAX."""
    import jax
    d = compile_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


def device_kind() -> dict:
    """What JAX runs on: platform, device_kind and device count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_kind(), or SystemExit when JAX's default backend is no GPU."""
    info = device_kind()
    if info["platform"] != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {info['platform']} "
                         f"({info['kind']})")
    return info


def card_power_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each: a card set below its maximum power runs slower under load, so
    every number taken on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def visible_cards() -> list:
    """Ids of the GPUs this process may hand to workers, found without
    initialising JAX: CUDA_VISIBLE_DEVICES when set, else nvidia-smi's
    list; empty on a host without NVIDIA cards."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c for c in env.split(",") if c.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return []
    return [c.strip() for c in out.stdout.splitlines() if c.strip()]
