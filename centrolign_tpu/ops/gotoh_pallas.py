"""Batched Gotoh fill + traceback for chain x chain gaps on the GPU.

One batched entry, ``gotoh_dispatch(bucket, jobs)`` / ``gotoh_fetch(handle)``,
returns per-job (alignment, score) bit-identical to the lax oracle
(ops.gotoh.gotoh_align). Jobs of one compile bucket (``_job_bucket``) share
one launch of each kernel.

On the GPU the fill is a Pallas kernel on the Triton route, one program per
job. A loop over anti-diagonals runs inside the program; each diagonal is
swept in lane chunks of ``_block(W)`` over only the lanes that lie inside
the matrix. The previous diagonals' M / I[pw] / D[pw] rows live in a small
per-job ring in global memory (L2-resident), written at lane + 1 so that
lane -1 reads the boundary value; a block barrier separates diagonals.
Backpointers are written as uint16 (the encoding of ops.gotoh) and the
score of the opt cell is extracted in-kernel. The traceback is a second
kernel, one program per job, walking at most V1 + V2 dependent loads.

Lanes a diagonal never computes keep stale ring values; they are never
read unmasked, because a cell inside the matrix only reads neighbours that
are inside the matrix too. Backpointers outside the matrix are left
unwritten; the traceback never visits them.

The kernels run compiled on a GPU and interpreted in the tests; on any
other backend the stitcher keeps chain gaps on the native engines
(``runs_here``). On the H100 the kernels took 92 ms for the pair's 24 M-cell
device gap bag against 420 ms for the oracle's ``_gotoh_scan`` vmapped over
each bucket with the traceback on the host (docs/kernel-roofline.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..device import configure_compile_cache

configure_compile_cache()
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .align_params import MININF

_NEG = np.int32(MININF)

# One launch's backpointer buffer stays under 2 GB (32-bit offsets in the
# kernels, and a bounded device footprint); larger groups split.
MAX_LAUNCH_BP_BYTES = 2 << 30

# Set by the tests: run the Triton kernels in interpret mode on the CPU.
INTERPRET = False


def _pow2_bucket(n: int, quantum: int) -> int:
    """Round up to quantum * 2^k, so each scale compiles once."""
    out = quantum
    while out < n:
        out *= 2
    return out


def _shape(V1: int, V2: int):
    """(W, num_diags, lane_is_i) of a V1 x V2 fill: lanes index the short
    side + 1, both sizes rounded to powers of two."""
    lane_is_i = V1 <= V2
    W = _pow2_bucket((V1 if lane_is_i else V2) + 1, 128)
    return W, _pow2_bucket(V1 + V2 + 1, 256), lane_is_i


def _job_bucket(job):
    """Compile-bucket key (W, num_diags, lane_is_i, swap_pref, npw) of one
    (s1, s2, swap_pref, params) job."""
    s1, s2, swp, p = job
    return (*_shape(len(s1), len(s2)), bool(swp), p.num_pw)


def fits_one_launch(V1: int, V2: int) -> bool:
    """Whether a V1 x V2 fill's backpointers fit one launch."""
    W, num_diags, _ = _shape(V1, V2)
    return 2 * W * num_diags <= MAX_LAUNCH_BP_BYTES


def _block(W: int) -> int:
    """Lane chunk a program sweeps per step of a diagonal."""
    return min(W, 512)


def _pack_jobs(bucket, jobs, B: int):
    """Host arrays for B slots (jobs first, then empty V1 = V2 = 0 slots):
    par (B, 16) int32 [V1, V2, match, mismatch, go*, ge*, 0-pad];
    a (B, W) lane-side labels at lanes 1..len (-1 elsewhere);
    b (B, LB) the other side reversed at [W, W + len) (-2 elsewhere), the
    layout of ops.gotoh._build_skew_inputs, so that lane k of diagonal d
    reads b[W + other_len - d + k]."""
    from .gotoh import _build_skew_inputs
    W, num_diags, lane_is_i, _swp, npw = bucket
    LB = _pow2_bucket(2 * W + num_diags, 128)
    par = np.zeros((B, 16), np.int32)
    a = np.full((B, W), -1, np.int32)
    b = np.full((B, LB), -2, np.int32)
    for k, (s1, s2, _s, p) in enumerate(jobs):
        a[k], b[k] = _build_skew_inputs(
            np.asarray(s1, dtype=np.int32), np.asarray(s2, dtype=np.int32),
            lane_is_i, W, LB - 2 * W)
        par[k, :4 + 2 * npw] = [len(s1), len(s2), p.match, p.mismatch,
                                *p.gap_open, *p.gap_extend]
    return par, a, b


# ---------------------------------------------------------------------------
# The Triton-route kernels


def _fill_kernel(par_ref, a_ref, b_ref, bp_ref, sc_ref, m_ref, i_ref, d_ref,
                 *, npw: int, lane_is_i: bool, swap_pref: bool, block: int,
                 barrier):
    """One program = one job. Refs are whole arrays: par (B, 16), a (B, W),
    b (B, LB), bp (B, D, W) uint16, sc (B,), rings m (B, 3, 2W),
    i / d (B, 2 * npw, 2W) (slot s, component pw at row s * npw + pw)."""
    g = pl.program_id(0)
    W = a_ref.shape[1]
    ring = m_ref.shape[2]
    shift = block.bit_length() - 1
    V1 = par_ref[g, 0]
    V2 = par_ref[g, 1]
    match = par_ref[g, 2]
    mismatch = par_ref[g, 3]
    go = [par_ref[g, 4 + pw] for pw in range(npw)]
    ge = [par_ref[g, 4 + npw + pw] for pw in range(npw)]
    short, other = (V1, V2) if lane_is_i else (V2, V1)
    lane0 = lax.broadcasted_iota(jnp.int32, (block,), 0)
    neg = jnp.full((block,), _NEG, jnp.int32)

    def init(c, _):
        cols = pl.ds(c * block, block)
        for s in range(3):
            m_ref[g, s, cols] = neg
        for r in range(2 * npw):
            i_ref[g, r, cols] = neg
            d_ref[g, r, cols] = neg

    lax.fori_loop(0, ring // block, init, None)
    barrier()

    def diag(d, _):
        s0 = lax.rem(d, 3)        # M ring slot of diagonal d
        s1 = lax.rem(d + 2, 3)    # d - 1
        s2 = lax.rem(d + 1, 3)    # d - 2
        t0 = d & 1                # I / D ring slot of diagonal d
        t1 = 1 - t0               # d - 1
        lo = jnp.maximum(d - other, 0)
        hi = jnp.minimum(d, short)

        def chunk(c, _):
            k0 = c * block
            lane = k0 + lane0
            if lane_is_i:
                i_vec, j_vec = lane, d - lane
            else:
                i_vec, j_vec = d - lane, lane
            avec = a_ref[g, pl.ds(k0, block)]
            bvec = b_ref[g, pl.ds(W + other - d + k0, block)]
            score_vec = jnp.where(avec == bvec, match, -mismatch)

            here = pl.ds(k0 + 1, block)   # ring index of lane k
            left = pl.ds(k0, block)       # ring index of lane k - 1
            m1_here = m_ref[g, s1, here]
            m1_left = m_ref[g, s1, left]
            M_diag = m_ref[g, s2, left]
            if lane_is_i:
                M_up, M_left = m1_left, m1_here
            else:
                M_up, M_left = m1_here, m1_left

            in_matrix = ((i_vec >= 0) & (i_vec <= V1)
                         & (j_vec >= 0) & (j_vec <= V2))
            i_pos = i_vec >= 1
            j_pos = j_vec >= 1
            corner = (i_vec == 0) & (j_vec == 0)

            Mnew = jnp.where(in_matrix & i_pos & j_pos,
                             M_diag + score_vec, _NEG)
            bp = jnp.zeros((block,), jnp.int32)
            comps = []
            for pw in range(npw):
                row1 = t1 * npw + pw
                if lane_is_i:
                    I_prev = i_ref[g, row1, left]
                    D_prev = d_ref[g, row1, here]
                else:
                    I_prev = i_ref[g, row1, here]
                    D_prev = d_ref[g, row1, left]
                i_open_val = M_up - (go[pw] + ge[pw])
                Inew = jnp.maximum(i_open_val, I_prev - ge[pw])
                Inew = jnp.where(in_matrix & i_pos, Inew, _NEG)
                d_open_val = M_left - (go[pw] + ge[pw])
                Dnew = jnp.maximum(d_open_val, D_prev - ge[pw])
                Dnew = jnp.where(in_matrix & j_pos, Dnew, _NEG)
                row0 = t0 * npw + pw
                i_ref[g, row0, here] = Inew
                d_ref[g, row0, here] = Dnew
                Mnew = jnp.maximum(Mnew, jnp.maximum(Inew, Dnew))
                bp = bp | (((Inew == i_open_val) & (Inew > _NEG))
                           .astype(jnp.int32) << (3 + pw))
                bp = bp | (((Dnew == d_open_val) & (Dnew > _NEG))
                           .astype(jnp.int32) << (6 + pw))
                if swap_pref:
                    comps += [(Dnew, 2 + 2 * pw), (Inew, 1 + 2 * pw)]
                else:
                    comps += [(Inew, 1 + 2 * pw), (Dnew, 2 + 2 * pw)]

            Mnew = jnp.where(corner, jnp.int32(0), Mnew)
            Mnew = jnp.where(in_matrix, Mnew, _NEG)
            code = jnp.zeros((block,), jnp.int32)
            for comp_val, comp_code in reversed(comps):
                code = jnp.where(comp_val == Mnew, comp_code, code)
            code = jnp.where(corner, 0, code)
            m_ref[g, s0, here] = Mnew
            bp_ref[g, d, pl.ds(k0, block)] = (bp | code).astype(jnp.uint16)

        lax.fori_loop(lo >> shift, (hi >> shift) + 1, chunk, None)
        barrier()

    lax.fori_loop(0, V1 + V2 + 1, diag, None)

    # the opt cell (V1, V2) sits on diagonal V1 + V2 at lane `short`
    k0 = ((short + 1) >> shift) << shift
    row = m_ref[g, lax.rem(V1 + V2, 3), pl.ds(k0, block)]
    sc_ref[g] = jnp.max(jnp.where(k0 + lane0 == short + 1, row, _NEG))


def _traceback_kernel(par_ref, bp_ref, sc_ref, out_ref, *, lane_is_i: bool):
    """One program = one job: walk the packed backpointers from (V1, V2) to
    (0, 0). out (B, D, 2) int32: row 0 = (count, score), rows 1..count the
    aligned pairs in traceback (reverse) order, GAP = -1."""
    g = pl.program_id(0)
    V1 = par_ref[g, 0]
    V2 = par_ref[g, 1]

    def cond(state):
        i, j, _comp, _n = state
        return (i != 0) | (j != 0)

    def body(state):
        i, j, comp, n = state
        lane = i if lane_is_i else j
        b = bp_ref[g, i + j, lane].astype(jnp.int32)
        code = b & 0b111
        new_comp = jnp.where((code & 1) == 1, (code + 1) >> 1, -(code >> 1))
        comp_eff = jnp.where(comp == 0, new_comp, comp)
        is_diag = (comp == 0) & (code == 0)
        take_i = comp_eff > 0            # gap in graph2: (i-1, GAP)
        out_ref[g, n + 1, 0] = jnp.where(is_diag | take_i, i - 1, -1)
        out_ref[g, n + 1, 1] = jnp.where(is_diag | ~take_i, j - 1, -1)
        i_closes = (b >> (3 + jnp.maximum(comp_eff - 1, 0))) & 1
        d_closes = (b >> (6 + jnp.maximum(-comp_eff - 1, 0))) & 1
        closes = jnp.where(take_i, i_closes, d_closes)
        comp_next = jnp.where(is_diag | (closes == 1), 0, comp_eff)
        i_next = jnp.where(is_diag | take_i, i - 1, i)
        j_next = jnp.where(is_diag | ~take_i, j - 1, j)
        return i_next, j_next, comp_next, n + 1

    _, _, _, n = lax.while_loop(cond, body, (V1, V2, jnp.int32(0),
                                             jnp.int32(0)))
    out_ref[g, 0, 0] = n
    out_ref[g, 0, 1] = sc_ref[g]


def _no_barrier():
    """The interpreter runs a program start to end, so it needs none."""


_PARAMS = plt.CompilerParams(num_warps=4, num_stages=1)


@functools.partial(jax.jit, static_argnames=(
    "num_diags", "lane_is_i", "npw", "swap_pref", "block", "interpret"))
def kernel_fill(par, a, b, num_diags: int, lane_is_i: bool, npw: int,
                swap_pref: bool, block: int, interpret: bool = False):
    """Fill a packed bucket, `block` lanes per chunk. Returns
    (bp (B, D, W) uint16, score (B,) int32)."""
    B, W = a.shape
    fill = functools.partial(
        _fill_kernel, npw=npw, lane_is_i=lane_is_i, swap_pref=swap_pref,
        block=block, barrier=_no_barrier if interpret else plt.debug_barrier)
    bp, sc, _m, _i, _d = pl.pallas_call(
        fill,
        out_shape=[
            jax.ShapeDtypeStruct((B, num_diags, W), jnp.uint16),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B, 3, 2 * W), jnp.int32),
            jax.ShapeDtypeStruct((B, 2 * npw, 2 * W), jnp.int32),
            jax.ShapeDtypeStruct((B, 2 * npw, 2 * W), jnp.int32),
        ],
        grid=(B,), backend="triton", compiler_params=_PARAMS,
        interpret=interpret, name="gotoh_fill")(par, a, b)
    return bp, sc


@functools.partial(jax.jit, static_argnames=("lane_is_i", "interpret"))
def kernel_traceback(par, bp, sc, lane_is_i: bool, interpret: bool = False):
    """Traceback of a kernel_fill result: (B, D, 2) int32 in the
    _traceback_kernel layout."""
    B, D, _W = bp.shape
    return pl.pallas_call(
        functools.partial(_traceback_kernel, lane_is_i=lane_is_i),
        out_shape=jax.ShapeDtypeStruct((B, D, 2), jnp.int32),
        grid=(B,), backend="triton", compiler_params=_PARAMS,
        interpret=interpret, name="gotoh_traceback")(par, bp, sc)


# ---------------------------------------------------------------------------
# Dispatch


def runs_here() -> bool:
    """Whether the kernels run on this process's backend: compiled on a
    GPU, or interpreted in the tests."""
    return INTERPRET or jax.default_backend() == "gpu"


def _launch(bucket, jobs):
    (W, num_diags, lane_is_i, swp, npw) = bucket
    par, a, b = _pack_jobs(bucket, jobs, _pow2_bucket(len(jobs), 1))
    par = jnp.asarray(par)
    bp, sc = kernel_fill(par, jnp.asarray(a), jnp.asarray(b), num_diags,
                         lane_is_i, npw, swp, _block(W), interpret=INTERPRET)
    return kernel_traceback(par, bp, sc, lane_is_i, interpret=INTERPRET), \
        len(jobs)


def gotoh_dispatch(bucket, jobs):
    """Launch fill + traceback for the jobs of one bucket WITHOUT waiting:
    JAX dispatch is asynchronous, so this returns device-array handles at
    once and the device works while the host goes on aligning other gaps.
    Groups whose backpointers would exceed MAX_LAUNCH_BP_BYTES split into
    several launches. `gotoh_fetch` blocks and unpacks."""
    per_launch = max(1, MAX_LAUNCH_BP_BYTES // (2 * bucket[0] * bucket[1]))
    return [_launch(bucket, jobs[k:k + per_launch])
            for k in range(0, len(jobs), per_launch)]


def gotoh_fetch(handle):
    """Block on a `gotoh_dispatch` handle; returns the per-job list of
    (alignment (L, 2) int64, score int), in job order."""
    results = []
    for arr, n_jobs in handle:
        out = np.asarray(jax.device_get(arr), dtype=np.int64)
        for k in range(n_jobs):
            n, sc = int(out[k, 0, 0]), int(out[k, 0, 1])
            results.append((out[k, n:0:-1].copy(), sc))
    return results
