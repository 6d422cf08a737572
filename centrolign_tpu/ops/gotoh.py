"""Anti-diagonal wavefront Gotoh fill (sequence × sequence) in plain lax:
the oracle of the device kernels (ops/gotoh_pallas.py).

The hot inner loop of stitching (reference po_poa on chain subgraphs,
alignment.hpp:897-938) recast as a data-parallel scan: the DP matrix is
*skewed* so each anti-diagonal d = i + j is a contiguous vector over
lanes, and the whole fill is a scan over diagonals with only element-shifts
between steps — no gathers, no data-dependent control flow. Cells are int32 {M, I[pw], D[pw]} exactly as
the reference (IntDP, alignment.hpp:736); values at every reachable cell are
bit-identical to the reference DP, so the packed backpointers reproduce the
reference's traceback tie-breaking:

- gap-close preference at M: I[0], D[0], I[1], D[1], ... then diagonal
- gap-open checked before gap-extend within a component

Backpointer encoding (uint16):
- bits 0..2: M source: 0=diagonal, 1=I[0], 2=D[0], 3=I[1], 4=D[1], 5=I[2], 6=D[2]
- bit 3+pw:  I[pw] opened from M (else extended)
- bit 6+pw:  D[pw] opened from M (else extended)

Padded coordinates: padded (i, j) = sequence positions (i-1, j-1); row 0 and
column 0 are the reference's boundary row/column (reference index V). The
corner M[0,0] = 0; lead gaps never re-open inside the boundary (provably
value-equal to the uniform recurrence for non-negative penalties, which is
what the kernel uses).

Two lane orientations are generated so the scratch width is always the
*short* side + 1 (<= ~6.4k lanes for the reference's 40M-cell po_poa cap):
lanes over i (axis=1) or lanes over j (axis=2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..device import configure_compile_cache

configure_compile_cache()
import numpy as np

from .align_params import AlignmentParams, MININF

_NEG = jnp.int32(MININF)


def _shift_right(v, fill=_NEG):
    """out[k] = v[k-1], out[0] = fill (1-D int32)."""
    return jnp.concatenate([jnp.full((1,), fill, v.dtype), v[:-1]])


def _diag_math(Mrow1, Mrow2, Irow1, Drow1, score_vec, lane_is_i, i_vec, j_vec,
               V1, V2, go, ge, swap_pref=False):
    """One anti-diagonal update. All rows are (npw?, W) int32 in skewed
    coordinates; lane_is_i selects which of I/D shifts between diagonals.

    Returns (Mnew, Inew, Dnew, bp) for this diagonal.
    """
    npw = go.shape[0]
    go_ge = (go + ge)[:, None]
    ge_ = ge[:, None]

    if lane_is_i:
        # lanes index i: (i-1, j) is lane-1 of previous diagonal; (i, j-1) is
        # the same lane of the previous diagonal; (i-1, j-1) lane-1 of d-2
        M_up = _shift_right(Mrow1)          # (i-1, j)
        I_up = jax.vmap(_shift_right)(Irow1)
        M_left = Mrow1                      # (i, j-1)
        D_left = Drow1
        M_diag = _shift_right(Mrow2)        # (i-1, j-1)
    else:
        # lanes index j
        M_up = Mrow1
        I_up = Irow1
        M_left = _shift_right(Mrow1)
        D_left = jax.vmap(_shift_right)(Drow1)
        M_diag = _shift_right(Mrow2)

    in_matrix = (i_vec >= 0) & (i_vec <= V1) & (j_vec >= 0) & (j_vec <= V2)
    i_pos = i_vec >= 1
    j_pos = j_vec >= 1
    corner = (i_vec == 0) & (j_vec == 0)

    # I[pw]: gap in graph2, consuming graph1 — needs i >= 1
    Inew = jnp.maximum(M_up[None, :] - go_ge, I_up - ge_)
    Inew = jnp.where((in_matrix & i_pos)[None, :], Inew, _NEG)
    # D[pw]: gap in graph1, consuming graph2 — needs j >= 1
    Dnew = jnp.maximum(M_left[None, :] - go_ge, D_left - ge_)
    Dnew = jnp.where((in_matrix & j_pos)[None, :], Dnew, _NEG)
    # diagonal
    Mdiag = jnp.where(in_matrix & i_pos & j_pos, M_diag + score_vec, _NEG)

    Mnew = jnp.maximum(Mdiag, jnp.maximum(Inew.max(axis=0), Dnew.max(axis=0)))
    Mnew = jnp.where(corner, jnp.int32(0), Mnew)
    Mnew = jnp.where(in_matrix, Mnew, _NEG)

    # --- backpointers
    # M source code: first matching in preference order I0,D0,I1,D1,...
    code = jnp.zeros(Mnew.shape, jnp.int32)
    order = []
    for pw in range(npw):
        order.append((Inew[pw], 1 + 2 * pw))
        order.append((Dnew[pw], 2 + 2 * pw))
    if swap_pref:
        # operand-swapped problems check D (their I) first
        order = []
        for pw in range(npw):
            order.append((Dnew[pw], 2 + 2 * pw))
            order.append((Inew[pw], 1 + 2 * pw))
    for comp_val, comp_code in reversed(order):
        code = jnp.where(comp_val == Mnew, comp_code, code)
    code = jnp.where(corner, 0, code)

    bp = code
    for pw in range(npw):
        i_open = (Inew[pw] == M_up - go_ge[pw]) & (Inew[pw] > _NEG)
        bp = bp | (i_open.astype(jnp.int32) << (3 + pw))
        d_open = (Dnew[pw] == M_left - go_ge[pw]) & (Dnew[pw] > _NEG)
        bp = bp | (d_open.astype(jnp.int32) << (6 + pw))

    return Mnew, Inew, Dnew, bp


def _build_skew_inputs(seq1, seq2, lane_is_i: bool, W: int, b_cap: int):
    """Host-side padded lane vectors for the score gather. b_cap bounds the
    reversed-side length so array shapes depend only on the bucket."""
    V1, V2 = len(seq1), len(seq2)
    if lane_is_i:
        # lane k holds i = k; score needs seq1[i-1] and seq2[j-1] = seq2[d-i-1]
        a = np.full(W, -1, dtype=np.int32)
        a[1:V1 + 1] = seq1
        b_src, b_len = seq2, V2
    else:
        a = np.full(W, -1, dtype=np.int32)
        a[1:V2 + 1] = seq2
        b_src, b_len = seq1, V1
    # reversed, padded both sides so every slice offset is valid
    b = np.full(2 * W + b_cap, -2, dtype=np.int32)
    b[W:W + b_len] = b_src[::-1]
    return a, b


def _bucket(n: int, quantum: int = 256) -> int:
    """Round up to the bucket quantum to bound jit recompilation."""
    return max(quantum, -(-n // quantum) * quantum)


@functools.partial(jax.jit, static_argnames=("num_diags", "lane_is_i", "npw", "swap_pref"))
def _gotoh_scan(seq_a, seq_b_revpad, V1, V2, match, mismatch, go, ge,
                num_diags: int, lane_is_i: bool, npw: int, swap_pref: bool):
    """lax.scan implementation over anti-diagonals (runs on any backend).
    Returns (bp matrix (num_diags, W) uint16, score of the opt cell (V1, V2)
    int32). V1/V2 are traced so one compile serves a whole shape bucket;
    diagonals beyond V1+V2 produce masked junk that the traceback never
    visits."""
    W = seq_a.shape[0]
    other_len = V2 if lane_is_i else V1
    last_lane = V1 if lane_is_i else V2

    lane = jnp.arange(W, dtype=jnp.int32)

    def step(carry, d):
        Mrow1, Mrow2, Irow1, Drow1, score = carry
        if lane_is_i:
            i_vec, j_vec = lane, d - lane
        else:
            i_vec, j_vec = d - lane, lane
        # score: seq_a[lane] vs other seq at (d - lane - 1), via reversed pad
        off = W + other_len - d
        bvec = jax.lax.dynamic_slice(seq_b_revpad, (off,), (W,))
        score_vec = jnp.where(seq_a == bvec, jnp.int32(match), -jnp.int32(mismatch))
        Mnew, Inew, Dnew, bp = _diag_math(
            Mrow1, Mrow2, Irow1, Drow1, score_vec, lane_is_i, i_vec, j_vec,
            V1, V2, go, ge, swap_pref)
        score = jnp.where(d == V1 + V2, Mnew[last_lane], score)
        return (Mnew, Mrow1, Inew, Dnew, score), bp.astype(jnp.uint16)

    M0 = jnp.full((W,), _NEG, jnp.int32)
    I0 = jnp.full((npw, W), _NEG, jnp.int32)
    carry0 = (M0, M0, I0, I0, _NEG)
    (*_, score), bp_all = jax.lax.scan(
        step, carry0, jnp.arange(num_diags, dtype=jnp.int32))
    return bp_all, score


def gotoh_align(seq1: np.ndarray, seq2: np.ndarray, params: AlignmentParams,
                swap_pref: bool = False):
    """Global piecewise-affine alignment of two encoded sequences.

    Returns (alignment (L,2) int64 with GAP=-1, score int). The result is
    identical (including tie-breaking) to the reference's po_poa on the two
    chain graphs with their natural sources/sinks.
    """
    seq1 = np.asarray(seq1, dtype=np.int32)
    seq2 = np.asarray(seq2, dtype=np.int32)
    V1, V2 = len(seq1), len(seq2)
    npw = params.num_pw

    lane_is_i = V1 <= V2
    W = (V1 if lane_is_i else V2) + 1
    # pad W and the diagonal count to bound the number of compiled shapes
    Wpad = _bucket(W, 128)
    num_diags = _bucket(V1 + V2 + 1, 256)

    a, b = _build_skew_inputs(seq1, seq2, lane_is_i, Wpad, num_diags)
    go = jnp.asarray(params.gap_open, dtype=jnp.int32)
    ge = jnp.asarray(params.gap_extend, dtype=jnp.int32)

    bp_all, score = _gotoh_scan(
        jnp.asarray(a), jnp.asarray(b), jnp.int32(V1), jnp.int32(V2),
        params.match, params.mismatch, go, ge,
        num_diags, lane_is_i, npw, swap_pref)
    bp_np, score = jax.device_get((bp_all, score))
    score = int(score)

    aln = _traceback_bp(bp_np, V1, V2, lane_is_i, npw)
    return aln, score


def _traceback_bp(bp: np.ndarray, V1: int, V2: int, lane_is_i: bool, npw: int):
    """Walk packed backpointers from (V1, V2) to (0, 0) (host)."""
    from ..alignment import GAP

    i, j = V1, V2
    comp = 0
    pairs = []
    while i != 0 or j != 0:
        d = i + j
        lane = i if lane_is_i else j
        b = int(bp[d, lane])
        if comp == 0:
            code = b & 0b111
            if code == 0:
                pairs.append((i - 1, j - 1))
                i -= 1
                j -= 1
                continue
            comp = (code + 1) // 2 if code % 2 == 1 else -(code // 2)
        if comp > 0:
            pw = comp - 1
            pairs.append((i - 1, GAP))
            if (b >> (3 + pw)) & 1:
                comp = 0
            i -= 1
        else:
            pw = -comp - 1
            pairs.append((GAP, j - 1))
            if (b >> (6 + pw)) & 1:
                comp = 0
            j -= 1
    pairs.reverse()
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)
