import os

# The tests run on the CPU backend (Pallas kernels in interpret mode), so
# they behave the same with or without a card. On a GPU host,
# CENTROLIGN_TPU_TEST_DEVICE=1 keeps JAX's default backend instead, which
# is how the tests marked `gpu` run:
#     CENTROLIGN_TPU_TEST_DEVICE=1 python -m pytest -m gpu tests/
if os.environ.get("CENTROLIGN_TPU_TEST_DEVICE") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

    # If JAX was imported before this file ran, it has already read the
    # environment; push the choice through jax.config so it sticks (the
    # environment still covers the CLI and worker subprocesses).
    import sys

    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_platforms", "cpu")

import subprocess

import numpy as np
import pytest


def _ensure_refbuild() -> None:
    """Build the reference binary + library into /tmp/refbuild so the
    byte-parity half of the suite runs on a fresh machine instead of
    silently skipping. Set CENTROLIGN_TPU_NO_REFBUILD=1 to opt out."""
    if os.path.exists("/tmp/refbuild/centrolign"):
        return
    if (not os.path.isdir("/root/reference")
            or os.environ.get("CENTROLIGN_TPU_NO_REFBUILD")):
        return
    os.makedirs("/tmp/refbuild", exist_ok=True)
    try:
        subprocess.run(
            ["cmake", "/root/reference", "-DCMAKE_BUILD_TYPE=Release",
             "-DSCRIPTS=ON", "-G", "Ninja"],
            cwd="/tmp/refbuild", check=True, capture_output=True,
            timeout=300)
        subprocess.run(["ninja"], cwd="/tmp/refbuild", check=True,
                       capture_output=True, timeout=1200)
    except (subprocess.SubprocessError, OSError) as e:
        print(f"reference bootstrap failed ({e}); parity tests will skip")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end runs; quick tier = pytest -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs JAX on a GPU (compiled kernels); skips elsewhere")
    _ensure_refbuild()


@pytest.fixture(autouse=True, scope="session")
def _interpret_kernels():
    """On the CPU backend the Triton-route kernels run in interpret mode,
    so the stitcher's device gaps take the path the card runs."""
    if os.environ.get("CENTROLIGN_TPU_TEST_DEVICE") != "1":
        from centrolign_tpu.ops import gotoh_pallas
        gotoh_pallas.INTERPRET = True


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a `gpu` test unless JAX runs on a GPU. Decided here, per test,
    never at import time, so every test worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip("needs JAX on a GPU (run with "
                        "CENTROLIGN_TPU_TEST_DEVICE=1 on a GPU host)")


@pytest.fixture
def rng():
    return np.random.default_rng(2471)


def random_sequence(rng, length: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))


def random_low_entropy_sequence(rng, length: int, period: int = 10,
                                mutation_rate: float = 0.05) -> str:
    unit = random_sequence(rng, period)
    seq = (unit * (length // period + 1))[:length]
    out = list(seq)
    for i in range(length):
        if rng.random() < mutation_rate:
            out[i] = "ACGT"[rng.integers(0, 4)]
    return "".join(out)


def mutate_sequence(rng, seq: str, sub_rate=0.05, indel_rate=0.02) -> str:
    out = []
    for ch in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue  # deletion
        if r < indel_rate:
            out.append("ACGT"[rng.integers(0, 4)])  # insertion
        if rng.random() < sub_rate:
            out.append("ACGT"[rng.integers(0, 4)])
        else:
            out.append(ch)
    if not out:
        out = ["A"]
    return "".join(out)


@pytest.fixture
def seq_factory(rng):
    return lambda n: random_sequence(rng, n)
