"""Multi-host subproblem scheduler: layer-wise data parallelism over the
guide tree.

The reference executes subproblems strictly serially (reference
src/execution.cpp:83-124); sibling subtrees are independent, so the guide
tree decomposes into dependency layers (Execution.independent_layers) whose
members can run on different hosts concurrently. This module dispatches each
layer over a pool of worker processes and gathers the fused parent graphs
for the next layer.

Process model / transport: one OS process per worker; the main process
only orchestrates and never opens the device itself. Each worker gets its
own card (CUDA_VISIBLE_DEVICES from its worker index, set before it imports
JAX); workers beyond the card count share cards, each with an equal share
of the card's memory. The unit of exchange (a completed subproblem's graph)
is exactly the reference's checkpoint contract (GFA per subproblem,
reference src/execution.cpp:223-279). In-process transport uses pickled
graph arrays so distributed results are bit-identical to the serial path
(GFA text is the durable on-disk form; -S files written by the main process
match the serial run byte-for-byte).

Determinism: every subproblem's result depends only on its two children and
the calibrated parameters, so the distributed output is byte-identical to
the serial run regardless of worker count or completion order.

Coverage: the colinear pipeline (calibration + progressive MSA + all of
-s/-S/-A/CIGAR outputs), cyclization (-c, bonding rounds dispatched per
layer with cross-round mask state carried in the main process), and
checkpoint restart (-R resumes into the layered schedule); see run() below
and tests/test_scheduler.py.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import numpy as np

from .. import logging as logmod


# This worker's index and card, set by _init_worker.
_worker = {"index": None, "card": None}


def _test_failure_hook() -> None:
    """Failure injection for the scheduler tests: '1' raises in the worker
    (the error reaches the main process and ends the run), '2' kills the
    worker process outright (the pool breaks and must be rebuilt)."""
    mode = os.environ.get("CENTROLIGN_TPU_TEST_WORKER_FAIL", "0")
    if mode == "1":
        raise RuntimeError("injected worker failure (test hook)")
    if mode == "2":
        os._exit(1)


def _worker_align(cfg_bytes, payload1, payload2):
    """Run one pairwise subproblem: returns pickled (graph, tableau,
    alignment) of the fused parent and (worker index, card, the task's
    aligner counters of metrics.py)."""
    _test_failure_hook()
    from .. import metrics
    from ..core import pairwise_align_step, fuse_step
    from ..execution import Subproblem
    metrics.reset()
    (max_count, score_function, anchorer, partitioner, stitcher,
     memory_restraint_size) = pickle.loads(cfg_bytes)
    sub1, sub2 = Subproblem(), Subproblem()
    sub1.graph, sub1.tableau = pickle.loads(payload1)
    sub2.graph, sub2.tableau = pickle.loads(payload2)
    alignment = pairwise_align_step(
        sub1, sub2, max_count, score_function, anchorer, partitioner,
        stitcher, memory_restraint_size=memory_restraint_size)
    graph, tableau = fuse_step(sub1, sub2, alignment)
    report = (_worker["index"], _worker["card"], dict(metrics.counters))
    return pickle.dumps((graph, tableau, alignment, report),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _worker_scale(cfg_bytes, payload):
    """Per-leaf intrinsic-scale estimate (calibration)."""
    _test_failure_hook()
    from ..core import leaf_intrinsic_scale
    from ..execution import Subproblem
    max_count, score_function, anchorer = pickle.loads(cfg_bytes)
    sub = Subproblem()
    sub.graph, sub.tableau = pickle.loads(payload)
    scale, _matches, _chain = leaf_intrinsic_scale(
        sub, max_count, score_function, anchorer)
    return float(scale)


def _worker_leaf_bonds(cfg_bytes, payload):
    """One leaf's full tandem-duplication bonding rounds (-c). The worker
    re-derives the leaf's self-matches (cheaper than shipping them) and runs
    the round loop with the already-calibrated global scale baked into the
    pickled anchorer, so results are byte-identical to the serial pass."""
    _test_failure_hook()
    from ..core import leaf_intrinsic_scale, leaf_bond_alignments
    from ..execution import Subproblem
    (max_count, score_function, anchorer, bonder, stitcher, max_rounds,
     collect_raw) = pickle.loads(cfg_bytes)
    sub = Subproblem()
    sub.graph, sub.tableau, sub.name, scale = pickle.loads(payload)
    _scale, matches, chain = leaf_intrinsic_scale(
        sub, max_count, score_function, anchorer)
    bond_alns, raw_alns = leaf_bond_alignments(
        sub, scale, matches, chain, anchorer, bonder, stitcher, max_rounds,
        collect_raw=collect_raw)
    return pickle.dumps((bond_alns, raw_alns),
                        protocol=pickle.HIGHEST_PROTOCOL)


def worker_env(index: int, n_workers: int, cards: list) -> dict:
    """Environment of pool worker `index` of `n_workers` on the visible
    `cards`: one card each, round robin. Workers that share a card split
    the memory JAX reserves for one process (0.9 of the card, leaving room
    for each process's CUDA context). Empty without cards."""
    if not cards:
        return {}
    slot = index % len(cards)
    sharing = len(range(slot, n_workers, len(cards)))
    env = {"CUDA_VISIBLE_DEVICES": str(cards[slot])}
    if sharing > 1:
        env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = f"{0.9 / sharing:.3f}"
    return env


def _init_worker(envs, counter, level) -> None:
    """Pool initializer: claim the next worker index, take its card, and
    (on the device path) open the card now, so that JAX's start-up
    overlaps the first tasks and a card that cannot be opened fails here."""
    with counter.get_lock():
        index = counter.value
        counter.value += 1
    os.environ.update(envs[index])
    _worker.update(index=index,
                   card=envs[index].get("CUDA_VISIBLE_DEVICES", "default"))
    logmod.level = level
    from ..device import use_device
    if use_device():
        from ..device import device_kind
        info = device_kind()
        logmod.log(logmod.Basic,
                   f"Worker {index} opened {info['platform']} device "
                   f"{info['kind']!r} on card {_worker['card']}.")


_pool = None
_pool_hosts = 0


def _worker_pool(n_hosts: int) -> ProcessPoolExecutor:
    """Process pool reused across calls: spawn + package import in a fresh
    worker costs seconds, which would otherwise land on every run's first
    layer (and on every benchmark rep)."""
    global _pool, _pool_hosts
    if _pool is None or _pool_hosts != n_hosts:
        if _pool is not None:
            _pool.shutdown(wait=False)
        from ..device import visible_cards
        cards = visible_cards()
        envs = [worker_env(i, n_hosts, cards) for i in range(n_hosts)]
        for i, env in enumerate(envs):
            if env:
                logmod.log(logmod.Basic, f"Worker {i}: " + " ".join(
                    f"{k}={v}" for k, v in env.items()))
        ctx = mp.get_context("spawn")
        _pool = ProcessPoolExecutor(
            max_workers=n_hosts, mp_context=ctx, initializer=_init_worker,
            initargs=(envs, ctx.Value("i", 0), logmod.level))
        _pool_hosts = n_hosts
    return _pool


def _rebuild_pool(n_hosts: int) -> ProcessPoolExecutor:
    """Discard a broken pool and spawn a fresh one: after a worker process
    dies (killed for memory, say) the executor refuses further submissions,
    but the scheduler can keep going — the lost subproblems are recomputed
    in the main process and later layers get new workers."""
    global _pool
    if _pool is not None:
        _pool.shutdown(wait=False)
        _pool = None
    return _worker_pool(n_hosts)


def distributed_execute(core, n_hosts: int) -> None:
    """Drive Core's pipeline with layer-parallel subproblem dispatch across
    `n_hosts` worker processes — including cyclization (-c, whose per-leaf
    bonding rounds fan out one leaf per worker) and checkpoint restarts
    (already-complete subproblems are skipped layer by layer)."""
    ex = core.main_execution
    tree = ex.tree
    cyclic = core.cyclize_tandem_duplications
    restarted = core._restarted_bond_alignments is not None
    bond_alignments = core._restarted_bond_alignments if restarted else []
    # -S needs every computed graph alive for the deferred emit loop below;
    # cyclization needs the root graph for apply_bonds
    keep_graphs = bool(core.preserve_subproblems
                       or core.subalignments_filepath
                       or core.subproblems_prefix
                       or cyclic
                       or len(ex.execution_order) == 1)

    from .. import metrics
    pool = _worker_pool(n_hosts)
    failed = [False]

    def _recover(what: str, exc: BrokenProcessPool):
        """A worker process died: log, remember to rebuild the pool before
        the next fan-out, and let the caller recompute `_locally` — the main
        process holds every input. Only a dead process is recovered from;
        an error raised inside a worker (the device's included) propagates
        and ends the run."""
        logmod.log(logmod.Minimal,
                   f"Worker failed during {what} (its process died: "
                   f"{exc}); recomputing locally on the native path.")
        failed[0] = True

    @contextlib.contextmanager
    def _locally():
        """Recompute in the main process on the native engines: the
        workers hold the cards."""
        saved = core.stitcher.use_device
        core.stitcher.use_device = False
        try:
            yield
        finally:
            core.stitcher.use_device = saved

    def _fresh_pool():
        nonlocal pool
        if failed[0]:
            pool = _rebuild_pool(n_hosts)
            failed[0] = False
        return pool

    def _submit(what, fn, *args):
        """submit() itself raises once a worker has died (broken pool); a
        None future tells the gather site to recompute locally."""
        try:
            return pool.submit(fn, *args)
        except BrokenProcessPool as e:
            _recover(what, e)
            return None

    def _result(fut):
        if fut is None:
            raise BrokenProcessPool("submission failed")
        return fut.result()

    # ---- calibration: per-leaf scale estimates, embarrassingly
    # parallel (reference src/core.cpp:122-175 runs them serially)
    layers = ex.independent_layers()
    scales = []
    leaves = list(ex.leaf_subproblems())
    if not core.skip_calibration or cyclic:
        logmod.log(logmod.Basic,
                   "Calibrating scale of anchoring parameters."
                   if not cyclic else
                   "Calibrating scale of anchoring parameters and "
                   "identifying tandem duplications.")
        cfg0 = pickle.dumps(
            (core.max_count, core.score_function, core.anchorer))
        futs = [_submit(f"calibration of {s.name}", _worker_scale, cfg0,
                        pickle.dumps((s.graph, s.tableau)))
                for s in leaves]
        for f, s in zip(futs, leaves):
            try:
                scales.append(float(_result(f)))
            except BrokenProcessPool as e:
                _recover(f"calibration of {s.name}", e)
                from ..core import leaf_intrinsic_scale
                with _locally():
                    scales.append(float(leaf_intrinsic_scale(
                        s, core.max_count, core.score_function,
                        core.anchorer)[0]))
        for sub, scale in zip(leaves, scales):
            logmod.log(logmod.Debug,
                       f"Computed intrinsic scale of {scale} for "
                       f"sequence {sub.name}")
        if not core.skip_calibration and scales:
            core.score_function.score_scale = float(np.mean(scales))

    # ---- cyclization: the per-leaf bonding rounds are independent
    # once the global scale is fixed — one leaf per worker
    if cyclic and not restarted:
        cfg1 = pickle.dumps(
            (core.max_count, core.score_function, core.anchorer,
             core.bonder, core.stitcher,
             core.max_tandem_duplication_search_rounds,
             bool(core.bonds_prefix)))
        _fresh_pool()
        futs = [_submit(f"bonding rounds of {s.name}",
                        _worker_leaf_bonds, cfg1,
                        pickle.dumps((s.graph, s.tableau, s.name,
                                      scales[i])))
                for i, s in enumerate(leaves)]
        for i, (sub, fut) in enumerate(zip(leaves, futs)):
            try:
                alns, raw = pickle.loads(_result(fut))
            except BrokenProcessPool as e:
                _recover(f"bonding rounds of {sub.name}", e)
                from ..core import (leaf_intrinsic_scale,
                                    leaf_bond_alignments)
                with _locally():
                    _s, matches, chain = leaf_intrinsic_scale(
                        sub, core.max_count, core.score_function,
                        core.anchorer)
                    alns, raw = leaf_bond_alignments(
                        sub, scales[i], matches, chain, core.anchorer,
                        core.bonder, core.stitcher,
                        core.max_tandem_duplication_search_rounds,
                        collect_raw=bool(core.bonds_prefix))
            if core.bonds_prefix:
                for k, raw_aln in enumerate(raw):
                    core.output_bond_alignment(raw_aln, sub.graph, 0, k)
            bond_alignments.extend(alns)
        if core.subproblems_prefix:
            core.emit_restart_bonds(bond_alignments)

    # ---- layer-wise progressive MSA
    logmod.log(logmod.Minimal, "Beginning MSA.")
    cfg = pickle.dumps((core.max_count, core.score_function,
                        core.anchorer, core.partitioner, core.stitcher,
                        core.memory_restraint_size))
    computed = set()
    for li, layer in enumerate(layers):
        logmod.log(logmod.Basic,
                   f"Executing layer {li + 1} of {len(layers)} "
                   f"({len(layer)} subproblem(s)) across {n_hosts} "
                   "host(s).")
        pending = [node_id for node_id in layer
                   if not ex.subproblems[node_id].complete]
        _fresh_pool()
        futs = {}
        for node_id in pending:
            c1, c2 = tree.get_children(node_id)
            s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
            futs[node_id] = _submit(
                f"subproblem {node_id}", _worker_align, cfg,
                pickle.dumps((s1.graph, s1.tableau)),
                pickle.dumps((s2.graph, s2.tableau)))
        for node_id, fut in futs.items():
            try:
                graph, tableau, alignment, (worker, card, counters) = \
                    pickle.loads(_result(fut))
                metrics.merge(counters)
                pod = counters.get("pod", (0, 0, 0.0))
                logmod.log(logmod.Basic,
                           f"Subproblem {node_id}: worker {worker} on card "
                           f"{card}, {pod[1]} cells filled on the device.")
            except BrokenProcessPool as e:
                _recover(f"subproblem {node_id}", e)
                from ..core import pairwise_align_step, fuse_step
                c1, c2 = tree.get_children(node_id)
                s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
                with _locally():
                    alignment = pairwise_align_step(
                        s1, s2, core.max_count, core.score_function,
                        core.anchorer, core.partitioner, core.stitcher,
                        memory_restraint_size=core.memory_restraint_size)
                graph, tableau = fuse_step(s1, s2, alignment,
                                           preserve=keep_graphs)
            parent = ex.subproblems[node_id]
            parent.graph = graph
            parent.tableau = tableau
            parent.alignment = alignment
            parent.complete = True
            computed.add(node_id)
        if not keep_graphs:
            for node_id in layer:
                for c in tree.get_children(node_id):
                    ex.subproblems[c].graph = None

    # ---- side outputs, emitted in the serial execution order so the
    # files are byte-identical to a serial run
    if core.subalignments_filepath or core.subproblems_prefix:
        for node_id in ex.execution_order:
            if node_id not in computed:
                continue
            parent = ex.subproblems[node_id]
            if core.subalignments_filepath:
                c1, c2 = tree.get_children(node_id)
                core.emit_subalignment(parent, ex.subproblems[c1],
                                       ex.subproblems[c2])
            if core.subproblems_prefix:
                core.emit_subproblem(parent)

    if core.induced_pairwise_prefix:
        core.output_pairwise_alignments(False)

    # ---- cyclization epilogue (reference src/core.cpp:594-648): merge the
    # bond alignments into the root graph and polish, exactly as the serial
    # path does after its MSA
    if cyclic:
        core.apply_bonds(bond_alignments)
        if core.induced_pairwise_prefix:
            logmod.log(logmod.Verbose,
                       "Outputting non-colinear pairwise alignments")
            core.output_pairwise_alignments(True)
