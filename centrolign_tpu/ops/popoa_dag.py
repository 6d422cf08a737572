"""DAG x DAG PO-POA on device: anti-diagonal wavefront over topological
positions.

The insight that makes a *graph* DP wavefront-schedulable on a
data-parallel device: in any
topological order every edge goes forward, so cell (r1, r2) — with r1, r2
*positions* in the two topological orders — depends only on cells at
strictly smaller anti-diagonal r1+r2. The irregular DAG adjacency becomes,
per node, a short list of predecessor *offsets* (delta = own position minus
predecessor position). With in-degree <= K and offsets <= S (true of the
bubble graphs the aligner actually sees: measured in-degree <= 2, span <= 4
on centromere MSAs), each diagonal is computed from ring buffers of the last
S diagonals with at most K x S masked lane-rotations — pure VPU work, no
gather.

Semantics are an exact behavioral twin of ops.popoa_ref.popoa (itself the
byte-parity twin of reference alignment.hpp:753-1150):

 - int32 DP cells {M, I[pw], D[pw]}, exact reference arithmetic including
   the unguarded MININF-minus-gap underflow chains (divergence is possible
   only in junk values <= MININF/2, which exact-equality tracebacks of real
   alignments never touch);
 - the boundary row/column (lead deletions/insertions, reference
   alignment.hpp:813-895) is precomputed on the host (it is a 1-D DAG scan)
   and fed to the kernel as vectors;
 - traceback tie rules are *encoded during the fill* into one packed int32
   per cell: gap-close preference I0,D0,I1,D1,...; diagonal predecessor =
   last prev1 in adjacency order with a matching prev2, then that prev1's
   first matching prev2 (recovered exactly via a two-stage column-max PM
   ring that records the last-wins argmax per column); within a gap
   component, first predecessor in adjacency order, gap-open before
   gap-extend; the source-pair corner is chosen only when strictly better
   (the reference's corner-initialized cells terminate the traceback only
   when no predecessor pair matches).
 - the on-device traceback walks the packed backpointers and hands off to
   the host when it enters the boundary row/column (the lead gap), which
   the host finishes from its boundary arrays.

Eligibility (else the caller falls back to the native C++ path): max
in-degree <= 4, max topological edge span <= 8 in both graphs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..device import configure_compile_cache

configure_compile_cache()
import numpy as np

from .align_params import AlignmentParams, MININF
from ..alignment import GAP

_I32 = np.int32
_I64 = np.int64
_NEG = np.int32(MININF)
_NEG_HALF = np.int32(MININF // 2)

# Envelope: graphs beyond these fall back to the native engine. Per-job
# compile buckets already quantize K/S to powers of two, so widening the
# caps only admits the (rare) denser gap graphs — their per-diagonal cost
# grows as K x S masked rotations, still far below a host fallback once the
# bucket is compiled (VERDICT r2 #4 measured 2.77M fallback cells on the
# 10-seq set at K<=4/S<=8).
K_MAX = 8    # real predecessor slots; slot index K == boundary
S_MAX = 32   # max topological edge span


def _pow2_bucket(n: int, quantum: int) -> int:
    out = quantum
    while out < n:
        out *= 2
    return out


# ---------------------------------------------------------------------------
# host-side graph tables


class DagTables:
    """Topological-position-space tables for one graph."""

    def __init__(self, graph, sources):
        from ..native import reference_topological_order
        V = graph.node_size
        self.V = V
        order = reference_topological_order(graph)
        self.order = order
        pos = np.empty(V, dtype=_I64)
        pos[order] = np.arange(V)
        self.pos = pos
        pptr, pind = graph.prev_csr()
        indeg = pptr[1:] - pptr[:-1]
        self.K = int(indeg.max()) if V else 0
        K = max(self.K, 1)
        # delta[k, r] = r - pos[k-th predecessor (CSC adjacency order)] or 0
        delta = np.zeros((K, V), dtype=_I32)
        nodes = np.arange(V)
        for k in range(self.K):
            has = indeg > k
            prevs = pind[pptr[:-1][has] + k]
            delta[k, pos[nodes[has]]] = (pos[nodes[has]] - pos[prevs])
        self.delta = delta
        self.S = int(delta.max()) if V else 0
        self.is_src = np.zeros(max(V, 1), dtype=_I32)
        self.is_src[pos[np.asarray(sources, dtype=_I64)]] = 1
        self.labels = graph.labels[order].astype(_I32)

    @property
    def eligible(self) -> bool:
        return self.K <= K_MAX and self.S <= S_MAX and self.V >= 1


def _boundaries(t1: DagTables, t2: DagTables, params: AlignmentParams):
    """Boundary column (graph1 side, lead insertions) and boundary row
    (graph2 side, lead deletions) in position space, exact popoa_ref
    arithmetic, plus the boundary-column diagonal tables."""
    npw = params.num_pw
    go = np.asarray(params.gap_open, dtype=_I32)
    ge = np.asarray(params.gap_extend, dtype=_I32)

    def one_side(t: DagTables):
        # seeds -go-ge at sources, pull-extend (-ge) along predecessors
        # (popoa_ref corner init + the extend-only boundary loops)
        arr = np.full((npw, t.V), _NEG, dtype=_I32)
        arr[:, t.is_src[:t.V].astype(bool)] = (-go - ge)[:, None]
        for r in range(t.V):
            for k in range(t.K):
                d = t.delta[k, r]
                if d:
                    np.maximum(arr[:, r], arr[:, r - d] - ge, out=arr[:, r])
        return arr

    bcol_I = one_side(t1)                    # I[pw, u, V2]
    bcol_M = bcol_I.max(axis=0)
    brow_D = one_side(t2)                    # D[pw, V1, v]
    brow_M = brow_D.max(axis=0)

    # diagonal pulls from the boundary COLUMN (prev2 = V2): value
    # max over real prev1 of M[prev1, V2] = bcol_M, plus the last-wins
    # argmax k1 (the reference scans prev1 in adjacency order)
    bdiag = np.full(t1.V, _NEG, dtype=_I32)
    bdiag_k1 = np.zeros(t1.V, dtype=_I32)
    for k in range(t1.K):
        d = t1.delta[k]
        has = d > 0
        cand = np.full(t1.V, _NEG, dtype=_I32)
        cand[has] = bcol_M[np.arange(t1.V)[has] - d[has]]
        upd = has & (cand >= bdiag)
        bdiag[upd] = cand[upd]
        bdiag_k1[upd] = k
    return bcol_I, bcol_M, brow_D, brow_M, bdiag, bdiag_k1


def _rev_pad(arr, W: int, cap: int, fill) -> np.ndarray:
    """Reversed + double-padded layout so that, for diagonal d, the slice
    starting at W + len(arr) - 1 - d yields arr[d - lane] at each lane."""
    out = np.full(2 * W + cap, fill, dtype=_I32)
    out[W:W + len(arr)] = np.asarray(arr, dtype=_I32)[::-1]
    return out


# ---------------------------------------------------------------------------
# fill (jax scan over anti-diagonals)


@functools.partial(
    jax.jit,
    static_argnames=("W", "D", "K1", "K2", "S1", "S2", "npw", "R"))
def _fill_scan(lab1, issrc1, delta1, bcolM, bdiag, bdiagk1,
               lab2r, issrc2r, delta2r, browMr,
               V1, V2, match, mismatch, go, ge,
               W: int, D: int, K1: int, K2: int, S1: int, S2: int,
               npw: int, R: int):
    """Returns (bp (D, W) int32, M (D, W) int32) in skewed layout:
    row d, lane l = cell (r1=l, r2=d-l)."""
    lane = jnp.arange(W, dtype=jnp.int32)
    NEG = jnp.int32(MININF)
    NEGH = jnp.int32(MININF // 2)

    def sel_span(delta_vec, per_span):
        """per_span[s-1] at lanes where delta_vec == s, else NEG."""
        out = jnp.full((W,), NEG)
        for s in range(1, len(per_span) + 1):
            out = jnp.where(delta_vec == s, per_span[s - 1], out)
        return out

    def step(carry, d):
        Mring, PMring, PMk1ring, Iring, Dring = carry
        r1 = lane
        r2 = d - lane
        in_mat = (r1 < V1) & (r2 >= 0) & (r2 < V2)

        off2 = W + V2 - 1 - d

        def slice2(a):
            return jax.lax.dynamic_slice(a, (off2,), (W,))

        lab2 = slice2(lab2r)
        issrc2 = slice2(issrc2r)
        browM = slice2(browMr)
        d2 = [slice2(delta2r[k]) for k in range(K2)]

        score = jnp.where(lab1 == lab2, match, -mismatch)

        # rolled prev-row views: rolled(ring, s)[l] = ring value at
        # (r1 - s, r2), i.e. diagonal d-s, lane l-s
        def rolled(ring, s):
            v = jnp.roll(ring[(d - s) & (R - 1)], s)
            return jnp.where(lane >= s, v, NEG)

        rolledM = [rolled(Mring, s) for s in range(1, S1 + 1)]

        # ---- PM: column max over prev1 (+ boundary row), last-wins argmax
        PM = jnp.full((W,), NEG)
        PMk1 = jnp.zeros((W,), jnp.int32)
        for k in range(K1):
            valk = sel_span(delta1[k], rolledM)
            upd = (delta1[k] > 0) & (valk >= PM)
            PM = jnp.where(upd, valk, PM)
            PMk1 = jnp.where(upd, k, PMk1)
        bm = jnp.where(issrc1 == 1, browM, NEG)
        upd = (issrc1 == 1) & (bm >= PM)
        PM = jnp.where(upd, bm, PM)
        PMk1 = jnp.where(upd, K1, PMk1)

        # ---- diagonal: Q over prev2 columns of PM (+ the boundary column
        # for source2 lanes); the source-pair corner joins only strictly
        colval = []
        colk1 = []
        for k in range(K2):
            pmv = sel_span(d2[k], [PMring[(d - s) & (R - 1)]
                                   for s in range(1, S2 + 1)])
            pmk = sel_span(d2[k], [PMk1ring[(d - s) & (R - 1)]
                                   for s in range(1, S2 + 1)])
            colval.append(jnp.where(d2[k] > 0, pmv, NEG))
            colk1.append(pmk)
        # boundary column option (prev2 = V2), real prev1 pulls only
        colval.append(jnp.where(issrc2 == 1, bdiag, NEG))
        colk1.append(bdiagk1)
        Qmax = jnp.full((W,), NEG)
        for v in colval:
            Qmax = jnp.maximum(Qmax, v)
        k1star = jnp.zeros((W,), jnp.int32)
        for k in range(K2 + 1):
            k1star = jnp.maximum(
                k1star, jnp.where(colval[k] == Qmax, colk1[k], 0))
        # first k2 in scan order (real ascending, boundary last) matching
        # (colval == Qmax) & (colk1 == k1star): reverse iterate + replace
        k2star = jnp.zeros((W,), jnp.int32)
        for k in [K2] + list(range(K2 - 1, -1, -1)):
            hit = (colval[k] == Qmax) & (colk1[k] == k1star)
            k2star = jnp.where(hit, k, k2star)
        # corner: value 0 at source-pair cells, wins only on strict >
        corner_ok = (issrc1 == 1) & (issrc2 == 1)
        corner_wins = corner_ok & (0 > Qmax)
        Qeff = jnp.where(corner_wins, 0, Qmax)
        k1star = jnp.where(corner_wins, K1, k1star)
        k2star = jnp.where(corner_wins, K2, k2star)
        Mdiag = jnp.where(Qeff > NEGH, Qeff + score, NEG)

        # ---- I components (gaps in graph2; along graph1 predecessors)
        Inew_all = []
        Ichoice_all = []
        for pw in range(npw):
            gpen = go[pw] + ge[pw]
            rolledI = [rolled(Iring[pw], s) for s in range(1, S1 + 1)]
            opens = []
            exts = []
            for k in range(K1):
                mv = sel_span(delta1[k], rolledM)
                iv = sel_span(delta1[k], rolledI)
                opens.append(jnp.where(delta1[k] > 0, mv - gpen, NEG))
                exts.append(jnp.where(delta1[k] > 0, iv - ge[pw], NEG))
            bopen = jnp.where(issrc1 == 1, browM - gpen, NEG)
            Inew = bopen
            for k in range(K1):
                Inew = jnp.maximum(Inew, jnp.maximum(opens[k], exts[k]))
            # choice digit = k + 5*open: boundary (open only) seeds, then k
            # descending with ext-then-open => first adjacency k wins, open
            # preferred at that k (the reference's per-prev scan order)
            choice = jnp.where(bopen == Inew, jnp.int32(K1 + 5), 0)
            for k in range(K1 - 1, -1, -1):
                choice = jnp.where(exts[k] == Inew, k, choice)
                choice = jnp.where(opens[k] == Inew, k + 5, choice)
            Inew_all.append(Inew)
            Ichoice_all.append(choice)

        # ---- D components (gaps in graph1; along graph2 predecessors,
        # same lane, older diagonals)
        Dnew_all = []
        Dchoice_all = []
        mlag = [Mring[(d - s) & (R - 1)] for s in range(1, S2 + 1)]
        for pw in range(npw):
            gpen = go[pw] + ge[pw]
            dlag = [Dring[pw][(d - s) & (R - 1)] for s in range(1, S2 + 1)]
            opens = []
            exts = []
            for k in range(K2):
                mv = sel_span(d2[k], mlag)
                dv = sel_span(d2[k], dlag)
                opens.append(jnp.where(d2[k] > 0, mv - gpen, NEG))
                exts.append(jnp.where(d2[k] > 0, dv - ge[pw], NEG))
            # boundary-column open is guarded (popoa_ref: only when real)
            bopen = jnp.where((issrc2 == 1) & (bcolM > NEGH),
                              bcolM - gpen, NEG)
            Dnew = bopen
            for k in range(K2):
                Dnew = jnp.maximum(Dnew, jnp.maximum(opens[k], exts[k]))
            choice = jnp.where(bopen == Dnew, jnp.int32(K2 + 5), 0)
            for k in range(K2 - 1, -1, -1):
                choice = jnp.where(exts[k] == Dnew, k, choice)
                choice = jnp.where(opens[k] == Dnew, k + 5, choice)
            Dnew_all.append(Dnew)
            Dchoice_all.append(choice)

        # ---- fold + comp code (first match in I0,D0,I1,D1,... order)
        Mnew = Mdiag
        for pw in range(npw):
            Mnew = jnp.maximum(Mnew, jnp.maximum(Inew_all[pw], Dnew_all[pw]))
        code = jnp.zeros((W,), jnp.int32)
        for pw in range(npw - 1, -1, -1):
            code = jnp.where(Dnew_all[pw] == Mnew, 2 * pw + 2, code)
            code = jnp.where(Inew_all[pw] == Mnew, 2 * pw + 1, code)

        Mnew = jnp.where(in_mat, Mnew, NEG)
        Inew_all = [jnp.where(in_mat, v, NEG) for v in Inew_all]
        Dnew_all = [jnp.where(in_mat, v, NEG) for v in Dnew_all]

        # ---- pack: code + 7*(k1star + 5*k2star) in 8 bits; I/D choice
        # digits (k + 5*open in 0..9) in 10 bits each
        diagcode = code + 7 * (k1star + 5 * k2star)
        ipack = jnp.zeros((W,), jnp.int32)
        dpack = jnp.zeros((W,), jnp.int32)
        mul = 1
        for pw in range(npw):
            ipack = ipack + Ichoice_all[pw] * mul
            dpack = dpack + Dchoice_all[pw] * mul
            mul *= 10
        bp = jnp.where(in_mat,
                       diagcode + (ipack << 8) + (dpack << 18),
                       0)

        slot = d & (R - 1)
        Mring = Mring.at[slot].set(Mnew)
        PMring = PMring.at[slot].set(jnp.where(in_mat, PM, NEG))
        PMk1ring = PMk1ring.at[slot].set(PMk1)
        for pw in range(npw):
            Iring = Iring.at[pw, slot].set(Inew_all[pw])
            Dring = Dring.at[pw, slot].set(Dnew_all[pw])
        return (Mring, PMring, PMk1ring, Iring, Dring), (bp, Mnew)

    carry0 = (jnp.full((R, W), NEG),
              jnp.full((R, W), NEG),
              jnp.zeros((R, W), jnp.int32),
              jnp.full((npw, R, W), NEG),
              jnp.full((npw, R, W), NEG))
    _, (bp, M) = jax.lax.scan(step, carry0,
                              jnp.arange(D, dtype=jnp.int32))
    return bp, M


# ---------------------------------------------------------------------------
# device traceback

_EXIT_NONE = 0
_EXIT_ROW = 1    # walk continues on the boundary row (r1 == V1)
_EXIT_COL = 2    # walk continues on the boundary column (r2 == V2)
_EXIT_CORNER = 3  # terminated at the source-pair corner


@functools.partial(jax.jit, static_argnames=("K1", "K2", "npw", "cap"))
def _traceback_scan(bp, delta1p, delta2p, start1, start2,
                    K1: int, K2: int, npw: int, cap: int):
    """Walk packed backpointers from (start1, start2) in M state. Returns
    (cap + 2, 2) int32: row 0 = (count, exit_kind); row 1 = (exit_r1,
    exit_r2); pairs (position space, GAP = -1) fill rows from the END."""
    GAPM = jnp.int32(-1)

    def digit(pack, pw):
        for _ in range(pw):
            pack = pack // 10
        return pack % 10

    def cond(st):
        return st[5] == _EXIT_NONE

    def body(st):
        r1, r2, comp, idx, out, _exit = st
        d = r1 + r2
        v = jax.lax.dynamic_slice(bp, (d, r1), (1, 1))[0, 0]
        diagcode = v & 255
        ipack = (v >> 8) & 1023
        dpack = (v >> 18) & 1023
        code = diagcode % 7
        rest = diagcode // 7
        k1 = rest % 5
        k2 = rest // 5
        comp_eff = jnp.where(comp == 0, code, comp)

        dlt1 = jax.lax.dynamic_slice(delta1p, (0, r1), (K1, 1))[:, 0]
        dlt2 = jax.lax.dynamic_slice(delta2p, (0, r2), (K2, 1))[:, 0]

        def take1(k):
            return dlt1[jnp.minimum(k, K1 - 1)]

        def take2(k):
            return dlt2[jnp.minimum(k, K2 - 1)]

        is_diag = comp_eff == 0
        is_I = (comp_eff % 2 == 1) & ~is_diag
        pw_I = (comp_eff - 1) // 2
        pw_D = comp_eff // 2 - 1

        idig = jnp.int32(0)
        ddig = jnp.int32(0)
        for pw in range(npw):
            idig = jnp.where(pw_I == pw, digit(ipack, pw), idig)
            ddig = jnp.where(pw_D == pw, digit(dpack, pw), ddig)
        ik = idig % 5
        iopen = idig // 5
        dk = ddig % 5
        dopen = ddig // 5

        pair = jnp.where(
            is_diag, jnp.stack([r1, r2]),
            jnp.where(is_I, jnp.stack([r1, GAPM]), jnp.stack([GAPM, r2])))
        out = jax.lax.dynamic_update_slice(
            out, pair[None].astype(jnp.int32), (idx, 0))

        diag_b1 = k1 >= K1
        diag_b2 = k2 >= K2
        corner = is_diag & diag_b1 & diag_b2
        to_row = (is_diag & diag_b1 & ~diag_b2) | (is_I & (ik >= K1))
        to_col = (is_diag & diag_b2 & ~diag_b1) | \
            (~is_diag & ~is_I & (dk >= K2))

        n_r1 = jnp.where(
            is_diag, jnp.where(diag_b1, r1, r1 - take1(k1)),
            jnp.where(is_I, jnp.where(ik >= K1, r1, r1 - take1(ik)), r1))
        n_r2 = jnp.where(
            is_diag, jnp.where(diag_b2, r2, r2 - take2(k2)),
            jnp.where(is_I, r2,
                      jnp.where(dk >= K2, r2, r2 - take2(dk))))
        n_comp = jnp.where(
            is_diag, 0,
            jnp.where(is_I,
                      jnp.where(iopen == 1, 0, comp_eff),
                      jnp.where(dopen == 1, 0, comp_eff)))
        n_exit = jnp.where(
            corner, _EXIT_CORNER,
            jnp.where(to_row, _EXIT_ROW,
                      jnp.where(to_col, _EXIT_COL, _EXIT_NONE)))
        return (n_r1, n_r2, n_comp, idx - 1, out, n_exit.astype(jnp.int32))

    out0 = jnp.zeros((cap + 2, 2), jnp.int32)
    st = (start1, start2, jnp.int32(0), jnp.int32(cap + 1), out0,
          jnp.int32(_EXIT_NONE))
    r1, r2, comp, idx, out, exit_kind = jax.lax.while_loop(cond, body, st)
    out = jax.lax.dynamic_update_slice(
        out, jnp.stack([cap + 1 - idx, exit_kind])[None], (0, 0))
    out = jax.lax.dynamic_update_slice(
        out, jnp.stack([r1, r2])[None], (1, 0))
    return out


# ---------------------------------------------------------------------------
# host boundary completion


def _finish_boundary_row(t2: DagTables, params, brow_D, brow_M, j):
    """D-walk along the boundary row from (V1, j) in M state, exactly like
    popoa_ref.popoa_traceback. Returns pairs (GAP, j) in backward order."""
    npw = params.num_pw
    go, ge = params.gap_open, params.gap_extend
    pairs = []
    comp = 0
    while True:
        if comp == 0:
            # M[V1, j] is the D fold; I[pw, V1, j] is MININF and the
            # reference's I checks can never match a real value first
            found = False
            for pw in range(npw):
                if brow_M[j] == brow_D[pw, j]:
                    comp = -pw - 1
                    found = True
                    break
            if not found:
                break
        pw = -comp - 1
        v = int(brow_D[pw, j])
        pairs.append((GAP, int(j)))
        nxt = None
        for k in range(t2.K):
            dlt = int(t2.delta[k, j])
            if dlt == 0:
                continue
            if v == int(brow_M[j - dlt]) - go[pw] - ge[pw]:
                nxt = j - dlt
                comp = 0
                break
            if v == int(brow_D[pw, j - dlt]) - ge[pw]:
                nxt = j - dlt
                break
        # the boundary prev2 (the corner) never matches: M/D there are junk
        if nxt is None:
            break
        j = nxt
    return pairs


def _finish_boundary_col(t1: DagTables, params, bcol_I, bcol_M, i):
    """I-walk along the boundary column from (i, V2) in M state."""
    npw = params.num_pw
    go, ge = params.gap_open, params.gap_extend
    pairs = []
    comp = 0
    while True:
        if comp == 0:
            found = False
            for pw in range(npw):
                if bcol_M[i] == bcol_I[pw, i]:
                    comp = pw + 1
                    found = True
                    break
            if not found:
                break
        pw = comp - 1
        v = int(bcol_I[pw, i])
        pairs.append((int(i), GAP))
        nxt = None
        for k in range(t1.K):
            dlt = int(t1.delta[k, i])
            if dlt == 0:
                continue
            # the reference checks open-from-M first even though the
            # boundary column never opens in the fill — value equality can
            # still hold and decides the path (alignment.hpp traceback)
            if v == int(bcol_M[i - dlt]) - go[pw] - ge[pw]:
                nxt = i - dlt
                comp = 0
                break
            if v == int(bcol_I[pw, i - dlt]) - ge[pw]:
                nxt = i - dlt
                break
        if nxt is None:
            break
        i = nxt
    return pairs


# ---------------------------------------------------------------------------
# batched entry: group gap jobs by compile bucket and run each bucket as
# vmapped fill + traceback (one launch per bucket)


class _DagJob:
    __slots__ = ("t1", "t2", "bcol_I", "bcol_M", "brow_D", "brow_M",
                 "arrays", "bucket", "sinks1", "sinks2", "params")

    def __init__(self, graph1, graph2, sources1, sources2, sinks1, sinks2,
                 params):
        self.t1 = DagTables(graph1, sources1)
        self.t2 = DagTables(graph2, sources2)
        self.sinks1 = sinks1
        self.sinks2 = sinks2
        self.params = params
        self.arrays = None
        self.bucket = None

    @property
    def eligible(self):
        return self.t1.eligible and self.t2.eligible \
            and len(self.sinks1) and len(self.sinks2)

    def prepare(self):
        t1, t2, params = self.t1, self.t2, self.params
        self.bcol_I, self.bcol_M, self.brow_D, self.brow_M, bdiag, \
            bdiag_k1 = _boundaries(t1, t2, params)
        K1 = max(t1.K, 1)
        K2 = max(t2.K, 1)
        S1 = _pow2_bucket(max(t1.S, 1), 1)
        S2 = _pow2_bucket(max(t2.S, 1), 1)
        R = _pow2_bucket(max(S1, S2) + 1, 2)
        W = _pow2_bucket(t1.V, 128)
        D = _pow2_bucket(t1.V + t2.V - 1, 128)
        cap2 = _pow2_bucket(t2.V + 1, 128)
        self.bucket = (W, D, cap2, K1, K2, S1, S2, R, params.num_pw,
                       params.match, params.mismatch,
                       tuple(params.gap_open), tuple(params.gap_extend))
        V1, V2 = t1.V, t2.V
        lab1 = np.full(W, -1, dtype=_I32)
        lab1[:V1] = t1.labels
        issrc1 = np.zeros(W, dtype=_I32)
        issrc1[:V1] = t1.is_src[:V1]
        delta1 = np.zeros((K1, W), dtype=_I32)
        delta1[:t1.delta.shape[0], :V1] = t1.delta
        bcolM_l = np.full(W, _NEG, dtype=_I32)
        bcolM_l[:V1] = self.bcol_M
        bdiag_l = np.full(W, _NEG, dtype=_I32)
        bdiag_l[:V1] = bdiag
        bdiagk1_l = np.zeros(W, dtype=_I32)
        bdiagk1_l[:V1] = bdiag_k1
        lab2r = _rev_pad(t2.labels, W, cap2, -2)
        issrc2r = _rev_pad(t2.is_src[:V2], W, cap2, 0)
        delta2r = np.stack([
            _rev_pad(t2.delta[k] if k < t2.delta.shape[0]
                     else np.zeros(V2, _I32), W, cap2, 0)
            for k in range(K2)])
        browMr = _rev_pad(self.brow_M, W, cap2, _NEG)
        delta1p = np.zeros((K1, W), dtype=_I32)
        delta1p[:t1.delta.shape[0], :V1] = t1.delta
        delta2p = np.zeros((K2, D), dtype=_I32)
        delta2p[:t2.delta.shape[0], :V2] = t2.delta
        self.arrays = (lab1, issrc1, delta1, bcolM_l, bdiag_l, bdiagk1_l,
                       lab2r, issrc2r, delta2r, browMr, delta1p, delta2p)


@functools.partial(
    jax.jit,
    static_argnames=("W", "D", "K1", "K2", "S1", "S2", "npw", "R", "cap"))
def _batch_fill_tb(lab1, issrc1, delta1, bcolM, bdiag, bdiagk1,
                   lab2r, issrc2r, delta2r, browMr, V1, V2,
                   pair1, pair2, delta1p, delta2p,
                   match, mismatch, go, ge,
                   W: int, D: int, K1: int, K2: int, S1: int, S2: int,
                   npw: int, R: int, cap: int):
    """vmapped fill + sink select + traceback for one bucket. pair1/pair2:
    (B, P) sink-pair positions padded with copies of pair 0. Returns
    (packed (B, cap+2, 2), best (B,), score (B,))."""
    def one(l1, is1, d1, bm, bd, bdk, l2, is2, d2, brm, v1, v2, p1, p2,
            d1p, d2p):
        bp, M = _fill_scan(
            l1, is1, d1, bm, bd, bdk, l2, is2, d2, brm, v1, v2,
            match, mismatch, go, ge,
            W=W, D=D, K1=K1, K2=K2, S1=S1, S2=S2, npw=npw, R=R)
        vals = M[p1 + p2, p1]
        best = jnp.argmax(vals)
        score = vals[best]
        packed = _traceback_scan(bp, d1p, d2p, p1[best], p2[best],
                                 K1=K1, K2=K2, npw=npw, cap=cap)
        return packed, best, score

    return jax.vmap(one)(lab1, issrc1, delta1, bcolM, bdiag, bdiagk1,
                         lab2r, issrc2r, delta2r, browMr, V1, V2,
                         pair1, pair2, delta1p, delta2p)


def popoa_dag_batch(jobs):
    """jobs: list of _DagJob (all eligible, prepared). Returns a list of
    (alignment, score) with results identical to popoa_dag_device."""
    results = [None] * len(jobs)
    buckets = {}
    for idx, job in enumerate(jobs):
        buckets.setdefault(job.bucket, []).append(idx)
    for bucket, idxs in buckets.items():
        (W, D, cap2, K1, K2, S1, S2, R, npw, match, mismatch,
         gop, gep) = bucket
        cap = D + 4
        go = jnp.asarray(gop, dtype=jnp.int32)
        ge = jnp.asarray(gep, dtype=jnp.int32)
        # pad the batch to a power of two to bound compile variants
        B = _pow2_bucket(len(idxs), 1)
        P = 1
        pairs = []
        for i in idxs:
            job = jobs[i]
            sp1 = job.t1.pos[np.asarray(job.sinks1, dtype=_I64)]
            sp2 = job.t2.pos[np.asarray(job.sinks2, dtype=_I64)]
            p1 = np.repeat(sp1, len(sp2)).astype(_I32)
            p2 = np.tile(sp2, len(sp1)).astype(_I32)
            pairs.append((p1, p2))
            P = max(P, len(p1))
        P = _pow2_bucket(P, 1)
        stacks = [[] for _ in range(12)]
        V1s, V2s, p1s, p2s = [], [], [], []
        for k in range(B):
            i = idxs[min(k, len(idxs) - 1)]
            job = jobs[i]
            for a, arr in enumerate(job.arrays):
                stacks[a].append(arr)
            V1s.append(job.t1.V)
            V2s.append(job.t2.V)
            p1, p2 = pairs[min(k, len(idxs) - 1)]
            pad = P - len(p1)
            p1s.append(np.concatenate([p1, np.full(pad, p1[0], _I32)]))
            p2s.append(np.concatenate([p2, np.full(pad, p2[0], _I32)]))
        args = [jnp.asarray(np.stack(s)) for s in stacks]
        packed, best, score = _batch_fill_tb(
            args[0], args[1], args[2], args[3], args[4], args[5],
            args[6], args[7], args[8], args[9],
            jnp.asarray(np.asarray(V1s, np.int32)),
            jnp.asarray(np.asarray(V2s, np.int32)),
            jnp.asarray(np.stack(p1s)), jnp.asarray(np.stack(p2s)),
            args[10], args[11],
            jnp.int32(match), jnp.int32(mismatch), go, ge,
            W=W, D=D, K1=K1, K2=K2, S1=S1, S2=S2, npw=npw, R=R, cap=cap)
        packed = np.asarray(jax.device_get(packed), dtype=np.int64)
        score = np.asarray(jax.device_get(score))
        for k, i in enumerate(idxs):
            job = jobs[i]
            if score[k] <= int(_NEG_HALF):
                results[i] = None  # no interior alignment; caller falls back
                continue
            results[i] = _assemble_result(
                job, packed[k], int(score[k]), cap)
    return results


def _assemble_result(job, packed, score, cap):
    t1, t2, params = job.t1, job.t2, job.params
    count = int(packed[0, 0])
    exit_kind = int(packed[0, 1])
    exit_r1 = int(packed[1, 0])
    exit_r2 = int(packed[1, 1])
    dev_pairs = packed[len(packed) - count:]
    lead = []
    if exit_kind == _EXIT_ROW:
        lead = _finish_boundary_row(t2, params, job.brow_D, job.brow_M,
                                    exit_r2)
        lead.reverse()
    elif exit_kind == _EXIT_COL:
        lead = _finish_boundary_col(t1, params, job.bcol_I, job.bcol_M,
                                    exit_r1)
        lead.reverse()
    out = []
    for (a, b) in lead:
        out.append((t1.order[a] if a != GAP else GAP,
                    t2.order[b] if b != GAP else GAP))
    for (a, b) in dev_pairs:
        out.append((t1.order[a] if a != -1 else GAP,
                    t2.order[b] if b != -1 else GAP))
    return np.array(out, dtype=_I64).reshape(-1, 2), score


# ---------------------------------------------------------------------------
# public entry


def popoa_dag_device(graph1, graph2, sources1, sources2, sinks1, sinks2,
                     params: AlignmentParams):
    """Device PO-POA for DAG x DAG gaps. Returns (alignment, score) exactly
    equal to ops.popoa_ref.popoa, or None when the graphs are outside the
    kernel envelope (high in-degree / long topological spans)."""
    t1 = DagTables(graph1, sources1)
    t2 = DagTables(graph2, sources2)
    if not (t1.eligible and t2.eligible):
        return None
    V1, V2 = t1.V, t2.V

    bcol_I, bcol_M, brow_D, brow_M, bdiag, bdiag_k1 = _boundaries(
        t1, t2, params)

    K1 = max(t1.K, 1)
    K2 = max(t2.K, 1)
    S1 = _pow2_bucket(max(t1.S, 1), 1)
    S2 = _pow2_bucket(max(t2.S, 1), 1)
    R = _pow2_bucket(max(S1, S2) + 1, 2)
    W = _pow2_bucket(V1, 128)
    D = _pow2_bucket(V1 + V2 - 1, 128)
    cap2 = _pow2_bucket(V2 + 1, 128)
    npw = params.num_pw

    lab1 = np.full(W, -1, dtype=_I32)
    lab1[:V1] = t1.labels
    issrc1 = np.zeros(W, dtype=_I32)
    issrc1[:V1] = t1.is_src[:V1]
    delta1 = np.zeros((K1, W), dtype=_I32)
    delta1[:t1.delta.shape[0], :V1] = t1.delta
    bcolM_l = np.full(W, _NEG, dtype=_I32)
    bcolM_l[:V1] = bcol_M
    bdiag_l = np.full(W, _NEG, dtype=_I32)
    bdiag_l[:V1] = bdiag
    bdiagk1_l = np.zeros(W, dtype=_I32)
    bdiagk1_l[:V1] = bdiag_k1

    lab2r = _rev_pad(t2.labels, W, cap2, -2)
    issrc2r = _rev_pad(t2.is_src[:V2], W, cap2, 0)
    delta2r = np.stack([
        _rev_pad(t2.delta[k] if k < t2.delta.shape[0]
                 else np.zeros(V2, _I32), W, cap2, 0)
        for k in range(K2)])
    browMr = _rev_pad(brow_M, W, cap2, _NEG)

    go = jnp.asarray(params.gap_open, dtype=jnp.int32)
    ge = jnp.asarray(params.gap_extend, dtype=jnp.int32)

    bp, M = _fill_scan(
        jnp.asarray(lab1), jnp.asarray(issrc1), jnp.asarray(delta1),
        jnp.asarray(bcolM_l), jnp.asarray(bdiag_l), jnp.asarray(bdiagk1_l),
        jnp.asarray(lab2r), jnp.asarray(issrc2r), jnp.asarray(delta2r),
        jnp.asarray(browMr),
        jnp.int32(V1), jnp.int32(V2),
        jnp.int32(params.match), jnp.int32(params.mismatch), go, ge,
        W=W, D=D, K1=K1, K2=K2, S1=S1, S2=S2, npw=npw, R=R)

    # sink-pair opt: first strictly-better wins == first argmax, s1-major
    sp1 = t1.pos[np.asarray(sinks1, dtype=_I64)]
    sp2 = t2.pos[np.asarray(sinks2, dtype=_I64)]
    pair1 = np.repeat(sp1, len(sp2)).astype(_I32)
    pair2 = np.tile(sp2, len(sp1)).astype(_I32)
    if len(pair1) == 0:
        return None
    dd = jnp.asarray(pair1) + jnp.asarray(pair2)
    vals = M[dd, jnp.asarray(pair1)]
    best = int(jax.device_get(jnp.argmax(vals)))
    score = int(jax.device_get(vals[best]))
    if score <= int(_NEG_HALF):
        return None  # no interior alignment; leave to the host path
    tb1, tb2 = int(pair1[best]), int(pair2[best])

    delta1p = np.zeros((K1, max(V1, 1)), dtype=_I32)
    delta1p[:t1.delta.shape[0]] = t1.delta
    delta2p = np.zeros((K2, max(V2, 1)), dtype=_I32)
    delta2p[:t2.delta.shape[0]] = t2.delta
    cap = V1 + V2 + 2
    packed = _traceback_scan(
        bp, jnp.asarray(delta1p), jnp.asarray(delta2p),
        jnp.int32(tb1), jnp.int32(tb2), K1=K1, K2=K2, npw=npw, cap=cap)
    packed = np.asarray(jax.device_get(packed), dtype=np.int64)
    count = int(packed[0, 0])
    exit_kind = int(packed[0, 1])
    exit_r1 = int(packed[1, 0])
    exit_r2 = int(packed[1, 1])
    dev_pairs = packed[len(packed) - count:]

    lead = []
    if exit_kind == _EXIT_ROW:
        lead = _finish_boundary_row(t2, params, brow_D, brow_M, exit_r2)
        lead.reverse()
    elif exit_kind == _EXIT_COL:
        lead = _finish_boundary_col(t1, params, bcol_I, bcol_M, exit_r1)
        lead.reverse()

    out = []
    for (a, b) in lead:
        out.append((t1.order[a] if a != GAP else GAP,
                    t2.order[b] if b != GAP else GAP))
    for (a, b) in dev_pairs:
        out.append((t1.order[a] if a != -1 else GAP,
                    t2.order[b] if b != -1 else GAP))
    return np.array(out, dtype=_I64).reshape(-1, 2), score
