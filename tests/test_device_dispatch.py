"""End-to-end device stitcher dispatch.

Pushes gaps through the public ``Stitcher.stitch`` entry with the device
threshold lowered so they ride ``_Pending`` -> the asynchronous bucket
launches -> ``_flush_pending``: chain x chain gaps through the batched
Gotoh entry (ops/gotoh_pallas.py: the Triton-route kernels, here in
interpret mode) and DAG x DAG
gaps through the topological-wavefront kernel (ops/popoa_dag.py, pure
jax — runs anywhere). Output must be byte-identical to the native path.

This is the guard for the round-2 field failure: a type-confused dispatch
in ``_flush_pending`` crashed every run that queued a chain device gap, and
no test constructed a ``_Pending`` through the public ``stitch`` entry.
"""

import os

import numpy as np
import pytest

from centrolign_tpu import metrics
from centrolign_tpu.anchorer import Anchor
from centrolign_tpu.graph import BaseGraph
from centrolign_tpu.modify_graph import add_sentinels
from centrolign_tpu.path_merge import PathMerge
from centrolign_tpu.stitcher import Stitcher


def _chain_graph(seq):
    g = BaseGraph()
    ids = g.add_nodes(np.asarray(seq, dtype=np.uint8))
    if len(ids) > 1:
        g.add_edges(ids[:-1], ids[1:])
    pid = g.add_path("p0")
    g.extend_path_array(pid, ids)
    return g, ids


def _bubble_graph(seq, rng, every=9):
    """Chain graph with single-base substitution bubbles every `every`
    bases: both alleles kept, two covering paths. In-degree <= 2 and
    topological span <= 2, i.e. inside the DAG kernel envelope."""
    g = BaseGraph()
    main_ids = []
    alt_steps = []
    prev = None
    for k, c in enumerate(np.asarray(seq, dtype=np.uint8)):
        nid = g.add_nodes(np.array([c], dtype=np.uint8))[0]
        main_ids.append(nid)
        alt_id = None
        if prev is not None:
            g.add_edges([prev], [nid])
        if 0 < k < len(seq) - 1 and k % every == 0:
            alt = np.uint8((int(c) + 1 + rng.integers(0, 3)) % 4)
            alt_id = g.add_nodes(np.array([alt], dtype=np.uint8))[0]
            g.add_edges([prev], [alt_id])
        alt_steps.append(alt_id)
        prev = nid
    for k, alt_id in enumerate(alt_steps):
        if alt_id is not None:
            g.add_edges([alt_id], [main_ids[k + 1]])
    p_main = g.add_path("p0")
    g.extend_path_array(p_main, np.array(main_ids, dtype=np.int64))
    alt_walk = [alt_steps[k] if alt_steps[k] is not None else main_ids[k]
                for k in range(len(main_ids))]
    p_alt = g.add_path("p1")
    g.extend_path_array(p_alt, np.array(alt_walk, dtype=np.int64))
    return g, np.array(main_ids, dtype=np.int64)


def _setup(build1, build2, anchor_len=24):
    """Two graphs sharing exact anchor walks at both ends; one segment of
    two anchors so stitch aligns the big middle gap."""
    g1, ids1 = build1
    g2, ids2 = build2
    t1 = add_sentinels(g1, 5, 6)
    t2 = add_sentinels(g2, 7, 8)
    xm1 = PathMerge(g1, t1)
    xm2 = PathMerge(g2, t2)

    def mk_anchor(sl1, sl2):
        return Anchor(walk1=np.asarray(sl1, dtype=np.int64),
                      walk2=np.asarray(sl2, dtype=np.int64),
                      count1=1, count2=1, full_length=anchor_len, score=1.0)

    a_l = mk_anchor(ids1[:anchor_len], ids2[:anchor_len])
    a_r = mk_anchor(ids1[-anchor_len:], ids2[-anchor_len:])
    segments = [[a_l, a_r]]
    return segments, g1, g2, t1, t2, xm1, xm2


def _run_both(args, monkeypatch):
    """Stitch natively and through the device path; compare."""
    monkeypatch.delenv("CENTROLIGN_TPU_USE_DEVICE", raising=False)
    monkeypatch.setenv("CENTROLIGN_TPU_DEVICE_DAG", "1")
    native = Stitcher(use_device=False).stitch(*args)

    metrics.reset()
    st = Stitcher()
    st.device_min_cells = 1
    forced = st.stitch(*args)
    summ = metrics.summary()
    n_dev = (summ.get("pod", {}).get("count", 0)
             + summ.get("podag", {}).get("count", 0))
    assert n_dev >= 1, (
        "device run never dispatched a device batch: "
        f"{ {k: v for k, v in summ.items() if isinstance(v, dict)} }")
    assert np.array_equal(forced, native)


def _seqs(rng, mid_len=260, anchor_len=24):
    anchor_l = rng.integers(0, 4, size=anchor_len)
    anchor_r = rng.integers(0, 4, size=anchor_len)
    mid1 = rng.integers(0, 4, size=mid_len)
    mid2 = mid1.copy()
    mid2[::11] = (mid2[::11] + 1) % 4  # ~9% substitutions
    s1 = np.concatenate([anchor_l, mid1, anchor_r])
    s2 = np.concatenate([anchor_l, mid2, anchor_r])
    return s1, s2


def test_forced_device_chain_gap(monkeypatch):
    """Chain x chain >= device_min_cells gap through stitch: batched device
    Gotoh result must equal the native PO-POA byte-for-byte."""
    rng = np.random.default_rng(90210)
    s1, s2 = _seqs(rng)
    args = _setup(_chain_graph(s1), _chain_graph(s2))
    _run_both(args, monkeypatch)


def test_forced_device_dag_gap(monkeypatch):
    """DAG x DAG gap (bubble graphs) through stitch: the topological
    wavefront kernel's batch must equal the native PO-POA byte-for-byte."""
    rng = np.random.default_rng(31337)
    s1, s2 = _seqs(rng)
    args = _setup(_bubble_graph(s1, rng), _bubble_graph(s2, rng))
    _run_both(args, monkeypatch)


def test_forced_device_mixed_batch(monkeypatch):
    """Both kinds of pending job queued in ONE stitch call (several
    segments): dispatch must route each to its kernel and keep slot order."""
    rng = np.random.default_rng(777)
    s1, s2 = _seqs(rng, mid_len=300)
    g1, ids1 = _chain_graph(s1)
    g2, ids2 = _bubble_graph(s2, rng)
    t1 = add_sentinels(g1, 5, 6)
    t2 = add_sentinels(g2, 7, 8)
    xm1 = PathMerge(g1, t1)
    xm2 = PathMerge(g2, t2)
    AL = 24
    n = len(ids1)

    def mk(sl1, sl2):
        return Anchor(walk1=np.asarray(sl1, dtype=np.int64),
                      walk2=np.asarray(sl2, dtype=np.int64),
                      count1=1, count2=1, full_length=AL, score=1.0)

    # three anchors -> two interior gaps; graph2 side is a DAG between
    # bubbles, graph1 side a chain, so jobs take the DAG route; plus a
    # second segment pair of pure chains for the chain route
    mid = n // 2
    segments = [[mk(ids1[:AL], ids2[:AL]),
                 mk(ids1[mid:mid + AL], ids2[mid:mid + AL]),
                 mk(ids1[-AL:], ids2[-AL:])]]
    args = (segments, g1, g2, t1, t2, xm1, xm2)
    _run_both(args, monkeypatch)


def test_native_only_switch(monkeypatch):
    """CENTROLIGN_TPU_USE_DEVICE=0 keeps every gap on the native engines:
    no device batch, same output as the device path."""
    rng = np.random.default_rng(90210)
    s1, s2 = _seqs(rng)
    args = _setup(_chain_graph(s1), _chain_graph(s2))
    monkeypatch.setenv("CENTROLIGN_TPU_USE_DEVICE", "0")
    metrics.reset()
    st = Stitcher()
    st.device_min_cells = 1
    assert st.use_device is False
    native = st.stitch(*args)
    assert "pod" not in metrics.summary()
    monkeypatch.delenv("CENTROLIGN_TPU_USE_DEVICE")
    st = Stitcher()
    st.device_min_cells = 1
    assert np.array_equal(st.stitch(*args), native)
    assert metrics.summary()["pod"]["count"] == 1


def test_mixed_buckets_async(monkeypatch):
    """Gaps of several compile buckets in one stitch call: each bucket
    launches asynchronously and every result lands in its own slot."""
    rng = np.random.default_rng(4242)
    AL = 24
    parts1, parts2 = [], []
    mids = [(150, 170), (300, 260), (90, 140), (170, 150)]
    for L1, L2 in mids:
        parts1 += [rng.integers(0, 4, AL), rng.integers(0, 4, L1)]
        m = rng.integers(0, 4, L2)
        m[:min(L1, L2)] = parts1[-1][:min(L1, L2)]
        m[::7] = (m[::7] + 1) % 4
        parts2 += [parts1[-2], m]
    tail = rng.integers(0, 4, AL)
    s1 = np.concatenate(parts1 + [tail])
    s2 = np.concatenate(parts2 + [tail])
    g1, ids1 = _chain_graph(s1)
    g2, ids2 = _chain_graph(s2)
    t1, t2 = add_sentinels(g1, 5, 6), add_sentinels(g2, 7, 8)
    xm1, xm2 = PathMerge(g1, t1), PathMerge(g2, t2)
    anchors, o1, o2 = [], 0, 0
    for L1, L2 in mids:
        anchors.append(Anchor(walk1=ids1[o1:o1 + AL], walk2=ids2[o2:o2 + AL],
                              count1=1, count2=1, full_length=AL, score=1.0))
        o1, o2 = o1 + AL + L1, o2 + AL + L2
    anchors.append(Anchor(walk1=ids1[o1:o1 + AL], walk2=ids2[o2:o2 + AL],
                          count1=1, count2=1, full_length=AL, score=1.0))
    args = ([anchors], g1, g2, t1, t2, xm1, xm2)

    from centrolign_tpu.ops import gotoh_pallas
    launched = []
    dispatch = gotoh_pallas.gotoh_dispatch
    monkeypatch.setattr(gotoh_pallas, "gotoh_dispatch", lambda b, jobs: (
        launched.append((b, len(jobs))), dispatch(b, jobs))[1])
    _run_both(args, monkeypatch)
    assert len(launched) >= 3, launched
    assert sum(n for _, n in launched) == len(mids)


def test_chain_gaps_native_off_gpu(monkeypatch):
    """Where the kernels do not run (a CPU backend, not interpreted), chain
    gaps stay on the native engines: no device batch, same output."""
    from centrolign_tpu.ops import gotoh_pallas
    rng = np.random.default_rng(90210)
    s1, s2 = _seqs(rng)
    args = _setup(_chain_graph(s1), _chain_graph(s2))
    monkeypatch.delenv("CENTROLIGN_TPU_USE_DEVICE", raising=False)
    native = Stitcher(use_device=False).stitch(*args)
    monkeypatch.setattr(gotoh_pallas, "INTERPRET", False)
    metrics.reset()
    st = Stitcher()
    st.device_min_cells = 1
    assert np.array_equal(st.stitch(*args), native)
    assert "pod" not in metrics.summary()
