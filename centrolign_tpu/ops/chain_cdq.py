"""Device realization of SparseAffine chain x chain chaining values.

This is the jnp twin of the native offline CDQ engine
(native/chain_affine_cdq.cpp): the same event timeline — anchor i publishes
6 piecewise channel values f32(f64(dp_i) +/- scale*ge[k]*shift_i) keyed by
(shift_i = e1-e2, offset_i = e2) plus dp_i on the gap-free channel; anchor j
queries the dominance region (time <, offset <, shift </==/>) and folds the
7 channel maxima with the reference's exact f32/f64 rounding sequence
(reference sparse_affine_chain_dp, anchorer.hpp:1812-2470, fold order
anchorer.hpp:2381-2420). Where the native engine resolves the dominance
maxima with CDQ divide-and-conquer + Fenwick sweeps (the right shape for a
pointer-rich host), the device realization linearizes the SAME timeline
into a `lax.scan` over anchors in start-position order whose step does
dense masked max-reductions over the published channel table — no trees,
no pointers, pure VPU work, vmap-batchable across subproblems so one
launch carries e.g. every calibration-leaf chain of a scheduler layer.

Exactness: every f32 add/max runs in the reference's own order; the two
f64-sensitive spots (channel publication and the fold's scale*inner
subtraction) keep their f64 intermediates — per-anchor f64 constants
(scale*ge[k]*shift_i and scale*(go[k] +/- ge[k]*qshift_j)) are computed on
the host with numpy f64 in the native engine's op order, and the kernel
performs only f64 widen/add/sub/round, under a scoped x64 context (jax.enable_x64). On
backends with IEEE f64 (the CPU, and the GPU natively) dp/tie/struct/stored
are bit-identical to the native engine — asserted by
tests/test_chain_cdq.py.

Backpointers: anchors whose winning channel has a unique achiever get the
exact backpointer; tied steps are flagged and re-resolved by the caller's
host replica of the tree visit order (chain_ties.AffineTieResolver),
identical to the native engine's contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..device import configure_compile_cache

configure_compile_cache()
import numpy as np

_NEGF = np.float32(np.finfo(np.float32).min)
_NPW = 3


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.partial(jax.jit, static_argnames=())
def _cdq_scan(pe1, pe2, shift, valid, xs):
    """One chain problem in start-sorted layout.

    pe1/pe2/shift: (N,) int32 static per-anchor end keys. valid: (N,) bool.
    xs: per-step inputs, each (N, ...): t, ps1, ps2, qshift, w, init,
    has_query, fc (6 x f64), cs (3 x f64).

    Returns (dp f32, bp i32 sorted-index or -1, tie u8, struct u8 (255 =
    none), stored f32) all (N,) in the sorted layout.
    """
    N = pe1.shape[0]
    iota = jnp.arange(N, dtype=jnp.int32)

    def step(carry, x):
        dp, st6 = carry
        t, ps1_j, ps2_j, qs_j, w_j, init_j, hasq_j, fc_j, cs_j = x

        base = (pe1 < ps1_j) & (pe2 < ps2_j) & valid

        best = init_j
        bp = jnp.int32(-1)
        tie = jnp.uint8(0)
        strct = jnp.uint8(255)
        stored_v = _NEGF

        def consider(best, bp, tie, strct, stored_v, c, mask, vals):
            has = mask.any()
            m = jnp.where(mask, vals, -jnp.inf)
            v = jnp.max(m, initial=-jnp.inf)
            who = jnp.argmax(m).astype(jnp.int32)
            cnt = jnp.sum(jnp.where(mask & (vals == v), 1, 0))
            if c == 0:
                value = v + w_j  # reference: cd.v + ww, plain f32 add
            else:
                # (f32)((f64)(f32)(cd.v + ww) - scale*inner)
                value = ((v + w_j).astype(jnp.float64)
                         - fc_j[c - 1]).astype(jnp.float32)
            upd = has & (value > best)
            return (jnp.where(upd, value, best),
                    jnp.where(upd, who, bp),
                    jnp.where(upd, (cnt > 1).astype(jnp.uint8), tie),
                    jnp.where(upd, jnp.uint8(c), strct),
                    jnp.where(upd, v, stored_v))

        # fold order: gap-free, then pw = 0..5 (anchorer.hpp:2381-2420)
        best, bp, tie, strct, stored_v = consider(
            best, bp, tie, strct, stored_v, 0,
            base & (shift == qs_j), dp)
        for pw in range(2 * _NPW):
            mask = base & ((shift < qs_j) if pw % 2 == 1
                           else (shift > qs_j))
            best, bp, tie, strct, stored_v = consider(
                best, bp, tie, strct, stored_v, 1 + pw, mask, st6[:, pw])

        dp_j = jnp.where(hasq_j, best, init_j)
        bp_j = jnp.where(hasq_j, bp, jnp.int32(-1))
        tie_j = jnp.where(hasq_j, tie, jnp.uint8(0))
        strct_j = jnp.where(hasq_j, strct, jnp.uint8(255))
        stored_j = jnp.where(hasq_j, stored_v, _NEGF)

        # publish the 6 channel values: (f32)((f64)dp -/+ ck[k]*shift)
        d64 = dp_j.astype(jnp.float64)
        row = jnp.stack([(d64 - cs_j[0]).astype(jnp.float32),
                         (d64 + cs_j[0]).astype(jnp.float32),
                         (d64 - cs_j[1]).astype(jnp.float32),
                         (d64 + cs_j[1]).astype(jnp.float32),
                         (d64 - cs_j[2]).astype(jnp.float32),
                         (d64 + cs_j[2]).astype(jnp.float32)])
        dp = dp.at[t].set(dp_j)
        st6 = st6.at[t].set(row)
        return (dp, st6), (dp_j, bp_j, tie_j, strct_j, stored_j)

    dp0 = jnp.full((N,), _NEGF, jnp.float32)
    st0 = jnp.full((N, 2 * _NPW), _NEGF, jnp.float32)
    (_, _), outs = jax.lax.scan(step, (dp0, st0), xs)
    return outs


def _prepare(ps1, pe1, ps2, pe2, w, init, go, ge, scale, n_pad):
    """Host-side exact f64 constant preparation + start-order sort/pad."""
    n = len(ps1)
    order = np.lexsort((np.arange(n), ps1))  # (ps1, id) ascending

    def pad_i32(a, fill):
        out = np.full(n_pad, fill, dtype=np.int32)
        out[:n] = a[order]
        return out

    qs = (ps1 - ps2).astype(np.int64)
    go = np.asarray(go, dtype=np.float64)
    ge = np.asarray(ge, dtype=np.float64)
    scale = np.float64(scale)
    ck = scale * ge  # native: ck[k] = scale * gap_extend[k]

    sh = (pe1 - pe2).astype(np.float64)
    cs = np.empty((n, _NPW), dtype=np.float64)
    for k in range(_NPW):
        cs[:, k] = ck[k] * sh  # native store_channels: ck[k]*(double)sh

    # fold constants fc[j, pw] = scale * (go[k] +/- ge[k]*qshift_j) with
    # the native op order: t = ge*q; inner = go +/- t; fc = scale*inner
    q64 = qs.astype(np.float64)
    fc = np.empty((n, 2 * _NPW), dtype=np.float64)
    for k in range(_NPW):
        t = ge[k] * q64
        fc[:, 2 * k] = scale * (go[k] - t)      # pw even: shift > qshift
        fc[:, 2 * k + 1] = scale * (go[k] + t)  # pw odd: shift < qshift

    big = np.int32(2**31 - 2)
    pe1_s = pad_i32(pe1.astype(np.int64), big)
    pe2_s = pad_i32(pe2.astype(np.int64), big)
    shift_s = pad_i32((pe1 - pe2).astype(np.int64), big)
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True

    def pad_f(a, fill, dtype):
        out = np.full(a.shape[:0] + (n_pad,) + a.shape[1:], fill,
                      dtype=dtype)
        out[:n] = a[order]
        return out

    xs = (
        np.arange(n_pad, dtype=np.int32),
        pad_i32(ps1.astype(np.int64), big),
        pad_i32(ps2.astype(np.int64), big),
        pad_i32(qs, big),
        pad_f(np.asarray(w, dtype=np.float32), 0.0, np.float32),
        pad_f(np.asarray(init, dtype=np.float32), _NEGF, np.float32),
        np.concatenate([(ps1[order] >= 1), np.zeros(n_pad - n, bool)]),
        pad_f(fc, 0.0, np.float64),
        pad_f(cs, 0.0, np.float64),
    )
    return order, (pe1_s, pe2_s, shift_s, valid), xs


def _unsort(order, n, dp, bp, tie, strct, stored):
    """Scatter sorted-layout outputs back to anchor-id order; remap bp
    through the sort order."""
    out_dp = np.empty(n, np.float32)
    out_bp = np.full(n, -1, np.int64)
    out_tie = np.zeros(n, np.uint8)
    out_struct = np.full(n, 255, np.uint8)
    out_stored = np.full(n, _NEGF, np.float32)
    order = np.asarray(order)
    dp = np.asarray(dp[:n])
    bp = np.asarray(bp[:n])
    out_dp[order] = dp
    mapped = np.where(bp >= 0, order[np.clip(bp, 0, n - 1)], -1)
    out_bp[order] = mapped
    out_tie[order] = np.asarray(tie[:n])
    out_struct[order] = np.asarray(strct[:n])
    out_stored[order] = np.asarray(stored[:n])
    return out_dp, out_bp, out_tie, out_struct, out_stored


def chain_cdq_device(ps1, pe1, ps2, pe2, w, init, go, ge, scale):
    """Drop-in device twin of native.chain_affine_cdq: returns
    (dp, bp, tie, struct, stored, qshift) in anchor-id order. Raises on
    backends without f64 support (callers fall back to the native engine).
    """
    n = len(ps1)
    qshift = np.asarray(ps1, dtype=np.int64) - np.asarray(ps2,
                                                          dtype=np.int64)
    if n == 0:
        return (np.empty(0, np.float32), np.empty(0, np.int64),
                np.empty(0, np.uint8), np.empty(0, np.uint8),
                np.empty(0, np.float32), qshift)
    n_pad = _next_pow2(max(n, 8))
    with jax.enable_x64(True):
        order, stat, xs = _prepare(ps1, pe1, ps2, pe2, w, init, go, ge,
                                   scale, n_pad)
        stat = tuple(jnp.asarray(a) for a in stat)
        xs = tuple(jnp.asarray(a) for a in xs)
        dp, bp, tie, strct, stored = (np.asarray(o) for o in
                                      _cdq_scan(*stat, xs))
    return (*_unsort(order, n, dp, bp, tie, strct, stored), qshift)


def chain_cdq_device_batch(problems):
    """Batch several chain problems into ONE device computation.

    problems: list of (ps1, pe1, ps2, pe2, w, init, go, ge, scale) tuples.
    All problems are padded to the largest power-of-two anchor count and
    the scan is vmapped over the problem dimension, so e.g. a scheduler
    layer's calibration-leaf chains ride one launch instead of one each.
    Returns a list of (dp, bp, tie, struct, stored, qshift) per problem.
    """
    if not problems:
        return []
    n_pad = _next_pow2(max(max(len(p[0]) for p in problems), 8))
    orders, stats, xss, qshifts = [], [], [], []
    with jax.enable_x64(True):
        for (ps1, pe1, ps2, pe2, w, init, go, ge, scale) in problems:
            qshifts.append(np.asarray(ps1, np.int64)
                           - np.asarray(ps2, np.int64))
            order, stat, xs = _prepare(ps1, pe1, ps2, pe2, w, init,
                                       go, ge, scale, n_pad)
            orders.append(order)
            stats.append(stat)
            xss.append(xs)
        stat_b = tuple(jnp.asarray(np.stack([s[i] for s in stats]))
                       for i in range(len(stats[0])))
        xs_b = tuple(jnp.asarray(np.stack([x[i] for x in xss]))
                     for i in range(len(xss[0])))
        outs = jax.vmap(_cdq_scan)(*stat_b, xs_b)
        outs = [np.asarray(o) for o in outs]
    res = []
    for b, (p, order) in enumerate(zip(problems, orders)):
        n = len(p[0])
        res.append((*_unsort(order, n, *(o[b] for o in outs)),
                    qshifts[b]))
    return res
