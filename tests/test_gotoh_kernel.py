"""The batched device Gotoh entry (ops/gotoh_pallas.py) against the lax
oracle (ops/gotoh.py): bit-exact scores and alignments, no tolerance.

The Triton-route kernels run here in interpret mode (their one barrier has
no interpreter and is a no-op for a program run start to end). The test
marked `gpu`
compiles the kernels for the card and runs the same check as
chip_smoke.py's kernel phase.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from centrolign_tpu.ops import gotoh_pallas as gp
from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.gotoh import gotoh_align

FULL = AlignmentParams()


def _job(rng, L1, L2, npw=3, swp=False):
    s1 = rng.integers(0, 4, L1).astype(np.int32)
    s2 = rng.integers(0, 4, L2).astype(np.int32)
    n = min(L1, L2)
    s2[:n] = s1[:n]
    if L2:
        s2[::9] = (s2[::9] + 1) % 4
        k = L2 // 3
        s2[k:k + L2 // 10] = rng.integers(0, 4, len(s2[k:k + L2 // 10]))
    return (s1, s2, swp, FULL.truncated(npw))


def _kernel(job, block=None):
    """One job through kernel_fill + kernel_traceback in interpret mode."""
    bucket = gp._job_bucket(job)
    W, D, lane_is_i, swp, npw = bucket
    par, a, b = gp._pack_jobs(bucket, [job], 1)
    par = jnp.asarray(par)
    bp, sc = gp.kernel_fill(par, jnp.asarray(a), jnp.asarray(b), D,
                            lane_is_i, npw, swp, block or gp._block(W),
                            interpret=True)
    out = np.asarray(gp.kernel_traceback(par, bp, sc, lane_is_i,
                                         interpret=True), dtype=np.int64)
    n = int(out[0, 0, 0])
    return out[0, n:0:-1], int(out[0, 0, 1])


def _assert_oracle(job, got):
    s1, s2, swp, p = job
    aln_o, score_o = gotoh_align(s1, s2, p, swap_pref=swp)
    aln, score = got
    assert score == score_o
    assert aln.dtype == aln_o.dtype and np.array_equal(aln, aln_o)


@pytest.mark.parametrize("swp", [False, True])
@pytest.mark.parametrize("npw", [1, 2, 3])
@pytest.mark.parametrize("lane_is_i", [True, False])
@pytest.mark.parametrize("W", [128, 256])
def test_kernel_matches_oracle(W, lane_is_i, npw, swp):
    rng = np.random.default_rng(W + 10 * npw + 2 * swp + lane_is_i)
    short, long_ = W - 1 - int(rng.integers(0, W // 4)), W + W // 3
    L1, L2 = (short, long_) if lane_is_i else (long_, short)
    job = _job(rng, L1, L2, npw, swp)
    assert gp._job_bucket(job)[:3] == (W, gp._pow2_bucket(L1 + L2 + 1, 256),
                                       lane_is_i)
    _assert_oracle(job, _kernel(job))


@pytest.mark.parametrize("swp", [False, True])
@pytest.mark.parametrize("lane_is_i", [True, False])
def test_kernel_matches_oracle_w1024(lane_is_i, swp):
    """Two lane chunks per diagonal at the default chunk width."""
    rng = np.random.default_rng(1024 + swp)
    L1, L2 = (600, 640) if lane_is_i else (640, 600)
    job = _job(rng, L1, L2, 3, swp)
    assert gp._job_bucket(job)[0] == 1024
    _assert_oracle(job, _kernel(job))


@pytest.mark.parametrize("L1,L2", [(300, 200), (200, 300), (250, 255)])
def test_kernel_small_chunks(L1, L2):
    """Chunks of 128 lanes at W = 256: the in-matrix window starts and ends
    mid-chunk and slides across chunk boundaries."""
    job = _job(np.random.default_rng(L1 * L2), L1, L2)
    _assert_oracle(job, _kernel(job, block=128))


@pytest.mark.parametrize("L1,L2", [(0, 0), (0, 5), (5, 0), (1, 1), (1, 9),
                                   (9, 1)])
def test_kernel_empty_and_unit(L1, L2):
    job = _job(np.random.default_rng(L1 + 7 * L2), L1, L2)
    _assert_oracle(job, _kernel(job))


def test_job_bucket_keys():
    p = FULL.truncated(2)
    key = gp._job_bucket((np.zeros(100), np.zeros(300), True, p))
    assert key == (128, 512, True, True, 2)
    assert gp._job_bucket((np.zeros(300), np.zeros(100), False, FULL)) == \
        (128, 512, False, False, 3)
    assert gp._job_bucket((np.zeros(127), np.zeros(128), False, FULL))[0] \
        == 128
    assert gp._job_bucket((np.zeros(128), np.zeros(128), False, FULL))[0] \
        == 256
    assert gp.fits_one_launch(5000, 5000)
    assert not gp.fits_one_launch(3, 400_000_000)


def test_pack_jobs_layout():
    """Jobs fill the first slots, empty V1 = V2 = 0 slots pad to B; the
    lane side starts at lane 1 and the other side sits reversed at W."""
    rng = np.random.default_rng(3)
    jobs = [_job(rng, 40, 90), _job(rng, 70, 100, npw=3)]
    bucket = gp._job_bucket(jobs[0])
    W, D = bucket[0], bucket[1]
    par, a, b = gp._pack_jobs(bucket, jobs, 4)
    assert par.shape == (4, 16) and a.shape == (4, W)
    assert b.shape == (4, gp._pow2_bucket(2 * W + D, 128))
    assert (par[2:] == 0).all() and (a[2:] == -1).all()
    s1, s2, _swp, p = jobs[1]
    assert list(par[1, :10]) == [70, 100, p.match, p.mismatch,
                                 *p.gap_open, *p.gap_extend]
    assert np.array_equal(a[1, 1:71], s1) and a[1, 0] == -1
    assert np.array_equal(b[1, W:W + 100], s2[::-1])
    assert (b[1, :W] == -2).all() and (b[1, W + 100:] == -2).all()


def test_dispatch_order_and_padding():
    """Several jobs of one bucket (padded to a power of two of slots)
    through the public dispatch / fetch entry: results come back in job
    order."""
    rng = np.random.default_rng(11)
    jobs = [_job(rng, int(rng.integers(20, 120)), int(rng.integers(20, 120)))
            for _ in range(12)]
    jobs = [j for j in jobs if gp._job_bucket(j) == gp._job_bucket(jobs[0])]
    assert len(jobs) >= 3
    got = gp.gotoh_fetch(gp.gotoh_dispatch(gp._job_bucket(jobs[0]), jobs))
    assert len(got) == len(jobs)
    for job, res in zip(jobs, got):
        _assert_oracle(job, res)


def test_dispatch_splits_launches(monkeypatch):
    """A group whose backpointers exceed MAX_LAUNCH_BP_BYTES is split into
    several launches; the results keep the job order."""
    rng = np.random.default_rng(5)
    jobs = [_job(rng, 50 + k, 60) for k in range(5)]
    bucket = gp._job_bucket(jobs[0])
    monkeypatch.setattr(gp, "MAX_LAUNCH_BP_BYTES",
                        2 * 2 * bucket[0] * bucket[1])
    handle = gp.gotoh_dispatch(bucket, jobs)
    assert len(handle) == 3
    for job, res in zip(jobs, gp.gotoh_fetch(handle)):
        _assert_oracle(job, res)


def test_kernel_choice(monkeypatch):
    """The kernels run on the GPU, or interpreted in tests; on any other
    backend they do not run at all (the stitcher keeps chain gaps
    native)."""
    monkeypatch.setattr(gp, "INTERPRET", False)
    monkeypatch.setattr(gp.jax, "default_backend", lambda: "gpu")
    assert gp.runs_here()
    monkeypatch.setattr(gp.jax, "default_backend", lambda: "cpu")
    assert not gp.runs_here()
    monkeypatch.setattr(gp, "INTERPRET", True)
    assert gp.runs_here()


@pytest.mark.gpu
def test_kernel_compiled_on_gpu():
    """The compiled kernels at lane buckets 128 to 1024 against the oracle
    (chip_smoke.py runs the same check up to 8192)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    chip_smoke.phase_kernel(max_w=1024)
