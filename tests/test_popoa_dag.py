"""The device DAG x DAG PO-POA must reproduce the host oracle exactly —
alignment arrays and scores — across random DAGs, chains, multi-source /
multi-sink shapes, and all piecewise-affine parameter sets."""

import numpy as np
import pytest

from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.popoa_ref import popoa
from centrolign_tpu.ops.popoa_dag import popoa_dag_device, DagTables

from util import random_dag, random_chain, graph_sources, graph_sinks

PARAMS = [
    AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1)),
    AlignmentParams(1, 1, (1,), (1,)),
    AlignmentParams(2, 3, (4, 1), (2, 5)),
]


def _check(g1, g2, s1, s2, k1, k2, params):
    import jax
    # pin to the CPU device: the check is of the kernel's arithmetic
    with jax.default_device(jax.devices("cpu")[0]):
        got = popoa_dag_device(g1, g2, s1, s2, k1, k2, params)
    if got is None:
        return False
    aln_d, score_d = got
    aln_h, score_h = popoa(g1, g2, s1, s2, k1, k2, params)
    assert score_d == score_h, (score_d, score_h)
    assert np.array_equal(aln_d, aln_h), (aln_d, aln_h)
    return True


@pytest.mark.parametrize("params", PARAMS)
def test_random_dags(params):
    rng = np.random.default_rng(7000 + params.num_pw)
    ran = 0
    for trial in range(12):
        g1 = random_dag(rng, int(rng.integers(4, 30)))
        g2 = random_dag(rng, int(rng.integers(4, 30)))
        s1, s2 = graph_sources(g1), graph_sources(g2)
        k1, k2 = graph_sinks(g1), graph_sinks(g2)
        if _check(g1, g2, s1, s2, k1, k2, params):
            ran += 1
    assert ran >= 4, f"only {ran} eligible draws"


@pytest.mark.parametrize("trial", range(3))
def test_chains(trial):
    rng = np.random.default_rng(81 + trial)
    params = PARAMS[0]
    g1 = random_chain(rng, int(rng.integers(5, 80)))
    g2 = random_chain(rng, int(rng.integers(5, 80)))
    assert _check(g1, g2, graph_sources(g1), graph_sources(g2),
                  graph_sinks(g1), graph_sinks(g2), params)


def test_subset_sources_sinks():
    # sources/sinks that are strict subsets of the graph's degree-0 nodes,
    # like stitcher extractions produce
    rng = np.random.default_rng(4242)
    params = PARAMS[0]
    ran = 0
    for trial in range(10):
        g1 = random_dag(rng, int(rng.integers(6, 25)))
        g2 = random_dag(rng, int(rng.integers(6, 25)))
        s1, s2 = graph_sources(g1), graph_sources(g2)
        k1, k2 = graph_sinks(g1), graph_sinks(g2)
        s1 = s1[: max(1, len(s1) - 1)]
        k2 = k2[: max(1, len(k2) - 1)]
        if _check(g1, g2, s1, s2, k1, k2, params):
            ran += 1
    assert ran >= 3


def test_identical_graphs_tie_heavy():
    # identical low-entropy graphs maximize score ties — the tie-rule
    # encoding must still match the oracle exactly
    rng = np.random.default_rng(99)
    params = PARAMS[0]
    for trial in range(4):
        g = random_dag(rng, 20)
        # low-entropy labels
        lab = rng.integers(0, 2, g.node_size)
        for v in range(g.node_size):
            g.relabel(v, int(lab[v]))
        s, k = graph_sources(g), graph_sinks(g)
        assert _check(g, g, s, s, k, k, params)


def test_eligibility_gate():
    # a graph with a long-span edge must be rejected, not misaligned
    from centrolign_tpu.graph import BaseGraph
    g = BaseGraph()
    g.add_nodes(np.zeros(40, dtype=np.uint8))
    for v in range(39):
        g.add_edge(v, v + 1)
    g.add_edge(0, 39)  # span 39 > S_MAX in any topo order of this graph
    t = DagTables(g, [0])
    assert not t.eligible


def test_batch_matches_oracle():
    from centrolign_tpu.ops.popoa_dag import _DagJob, popoa_dag_batch
    import jax
    rng = np.random.default_rng(1234)
    params = PARAMS[0]
    jobs = []
    expected = []
    for trial in range(10):
        g1 = random_dag(rng, int(rng.integers(5, 40)))
        g2 = random_dag(rng, int(rng.integers(5, 40)))
        s1, s2 = graph_sources(g1), graph_sources(g2)
        k1, k2 = graph_sinks(g1), graph_sinks(g2)
        job = _DagJob(g1, g2, s1, s2, k1, k2, params)
        if not job.eligible:
            continue
        job.prepare()
        jobs.append(job)
        expected.append(popoa(g1, g2, s1, s2, k1, k2, params))
    assert len(jobs) >= 4
    with jax.default_device(jax.devices("cpu")[0]):
        results = popoa_dag_batch(jobs)
    for got, (aln_h, score_h) in zip(results, expected):
        assert got is not None
        aln_d, score_d = got
        assert score_d == score_h
        assert np.array_equal(aln_d, aln_h)


@pytest.mark.slow
def test_stitcher_device_dag_path_byte_parity(tmp_path):
    """A small MSA with the device threshold lowered so DAG gaps go through
    the batched kernel must produce the identical GFA to the native path."""
    import io
    import jax
    from centrolign_tpu.core import Core
    from centrolign_tpu.tree import Tree, in_order_newick_string
    from centrolign_tpu.io.gfa import write_gfa

    rng = np.random.default_rng(909)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))

    def mut(s):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < 0.03
                       else c for c in s)
    seqs = [(f"g{i}", mut(base)) for i in range(3)]

    def run(device: bool):
        import os
        core = Core(seqs, Tree(in_order_newick_string(
            [n for n, _ in seqs])))
        if device:
            os.environ["CENTROLIGN_TPU_USE_DEVICE"] = "force"
        else:
            os.environ["CENTROLIGN_TPU_USE_DEVICE"] = "0"
        core.stitcher.__post_init__()
        core.stitcher.device_min_cells = 2000
        with jax.default_device(jax.devices("cpu")[0]):
            core.execute()
        buf = io.StringIO()
        root = core.root_subproblem()
        write_gfa(root.graph, root.tableau, buf)
        os.environ.pop("CENTROLIGN_TPU_USE_DEVICE", None)
        return buf.getvalue()

    native = run(False)
    device = run(True)
    assert native == device
