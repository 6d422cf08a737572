"""Smoke run of the system on the GPU, through the entry points a user calls.

    python chip_smoke.py                  # one card, every phase below
    python chip_smoke.py --only kernel    # phases 1-2: compile + check
    python chip_smoke.py --four-cards     # the four-card MSA, nothing else

One card (everything in this one process; any failure exits non-zero):
  1. device: JAX must run on a GPU; prints device_kind, device count, the
     card's name and power limit, XLA_FLAGS and the JAX version.
  2. Gotoh kernel: compiled at every lane bucket from 128 to 8192, compared
     bit-for-bit (score and alignment) with the lax oracle for both lane
     orientations, num_pw 1-3 and swap_pref; prints memory_analysis().
  3. opt-in engines: one call each of popoa_dag, chain_cdq and chain_scan
     at small real shapes, compared with their native twins.
  4. pair CLI: benchdata/pair.fasta must give benchdata/ref_pair.cigar.txt
     byte-for-byte with device gap fills ('pod' cells) > 0.
  5. the pair's device gap bag, timed: the kernels against the plain fill
     XLA compiles from the oracle (its scan vmapped over each bucket, with
     the traceback on the host), fill and traceback apart; then the pair
     CLI end to end, warm.
  6. five-sequence MSA: the GFA must equal benchdata/ref_five.gfa, with
     device gap fills > 0.

--four-cards: the same five-sequence MSA with --hosts 4, one pool worker
per card; the GFA must be identical, four distinct cards opened, no worker
lost, and the workers' device gap fills > 0. This process never imports
JAX: the cards belong to the workers.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "benchdata")
RESULTS: dict = {}


def say(msg: str) -> None:
    print(msg, flush=True)


def read(name: str) -> str:
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def run_cli(argv):
    """The CLI in this process; returns (stdout text, wall seconds)."""
    from centrolign_tpu.cli import main as cli_main
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
    finally:
        sys.stdout = stdout
    assert rc == 0, f"CLI {argv} exited {rc}"
    return buf.getvalue(), wall


# ---------------------------------------------------------------------------


def phase_device():
    import jax
    from centrolign_tpu.device import card_power_line, require_gpu
    info = require_gpu()
    card = card_power_line()
    say(f"[1 device] {info['kind']} x{info['count']} ({info['platform']})")
    say(f"[1 device] card: {card}")
    say(f"[1 device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"jax {jax.__version__}")
    RESULTS["device"] = info
    RESULTS["card"] = card
    return info


def _mutated(rng, s1, L2):
    """A second sequence of length L2 resembling s1: 5% substitutions and
    a block of unrelated bases, so the traceback meets gaps of all kinds."""
    import numpy as np
    s2 = np.resize(s1, L2).astype(np.int32) if len(s1) else \
        rng.integers(0, 4, L2).astype(np.int32)
    if L2:
        idx = rng.integers(0, L2, max(1, L2 // 20))
        s2[idx] = (s2[idx] + 1) % 4
        k = int(rng.integers(0, L2))
        s2[k:k + L2 // 8] = rng.integers(0, 4, len(s2[k:k + L2 // 8]))
    return s2


def check_jobs(jobs, tag):
    """Dispatch `jobs` bucket by bucket and compare each result with the
    lax oracle bit-for-bit."""
    import numpy as np
    from centrolign_tpu.ops import gotoh_pallas as gp
    from centrolign_tpu.ops.gotoh import gotoh_align
    buckets = {}
    for k, job in enumerate(jobs):
        buckets.setdefault(gp._job_bucket(job), []).append(k)
    for bucket, ks in buckets.items():
        got = gp.gotoh_fetch(gp.gotoh_dispatch(bucket, [jobs[k] for k in ks]))
        for k, (aln, score) in zip(ks, got):
            s1, s2, swp, p = jobs[k]
            aln_o, score_o = gotoh_align(s1, s2, p, swap_pref=swp)
            assert score == score_o and np.array_equal(aln, aln_o), (
                f"{tag}: kernel differs from the oracle for a "
                f"{len(s1)}x{len(s2)} job in bucket {bucket}")
    return len(buckets)


def phase_kernel(max_w: int = 8192):
    import numpy as np
    import jax.numpy as jnp
    from centrolign_tpu.ops import gotoh_pallas as gp
    from centrolign_tpu.ops.align_params import AlignmentParams
    rng = np.random.default_rng(20261016)
    full = AlignmentParams()
    jobs = []

    def add(L1, L2, npw, swp):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        jobs.append((s1, _mutated(rng, s1, L2), swp, full.truncated(npw)))

    # every combination at W = 128, several jobs per launch, edge lengths
    for npw in (1, 2, 3):
        for swp in (False, True):
            for L1, L2 in ((100, 126), (126, 90), (0, 40), (40, 0), (1, 1),
                           (1, 70), (127, 127)):
                add(L1, L2, npw, swp)
    # both orientations at every larger lane bucket
    W = 256
    while W <= max_w:
        add(W - 1, W + W // 4, 3, False)
        add(W + W // 4, W - 1, 3, True)
        add(W // 2 + 3, W - 1, 2, False)
        W *= 2
    t0 = time.perf_counter()
    n_buckets = check_jobs(jobs, "[2 kernel]")
    say(f"[2 kernel] {len(jobs)} jobs in {n_buckets} buckets bit-identical "
        f"to the oracle ({time.perf_counter() - t0:.1f} s incl. compile)")

    for W in (128, 1024, max_w):
        bucket = (W, gp._pow2_bucket(2 * W + W // 4, 256), True, False, 3)
        par, a, b = gp._pack_jobs(bucket, [], 1)
        compiled = gp.kernel_fill.lower(
            jnp.asarray(par), jnp.asarray(a), jnp.asarray(b),
            num_diags=bucket[1], lane_is_i=True, npw=3, swap_pref=False,
            block=gp._block(W), interpret=gp.INTERPRET).compile()
        say(f"[2 kernel] W={W} fill memory_analysis: "
            f"{compiled.memory_analysis()}")
    RESULTS["kernel_check"] = {"jobs": len(jobs), "buckets": n_buckets}


def phase_engines():
    import numpy as np
    from centrolign_tpu.ops.align_params import AlignmentParams

    # popoa_dag: bubble graphs (two alleles every 9 bases)
    from centrolign_tpu.graph import BaseGraph
    from centrolign_tpu.native import popoa_align
    from centrolign_tpu.ops.popoa_dag import _DagJob, popoa_dag_batch
    rng = np.random.default_rng(7)

    def bubble_graph(seq):
        g = BaseGraph()
        prev, alts = None, []
        for k, c in enumerate(seq):
            nid = g.add_nodes(np.array([c], dtype=np.uint8))[0]
            alt = None
            if prev is not None:
                g.add_edges([prev], [nid])
                if k % 9 == 0 and k < len(seq) - 1:
                    alt = g.add_nodes(np.array([(c + 1) % 4],
                                               dtype=np.uint8))[0]
                    g.add_edges([prev], [alt])
            alts.append((alt, nid))
            prev = nid
        for k, (alt, _nid) in enumerate(alts[:-1]):
            if alt is not None:
                g.add_edges([alt], [alts[k + 1][1]])
        return g

    params = AlignmentParams()
    base = rng.integers(0, 4, 600)
    other = base.copy()
    other[::13] = (other[::13] + 1) % 4
    g1, g2 = bubble_graph(base), bubble_graph(other)
    src = lambda g: np.flatnonzero(g.in_degrees() == 0)  # noqa: E731
    snk = lambda g: np.flatnonzero(g.out_degrees() == 0)  # noqa: E731
    args = (g1, g2, src(g1), src(g2), snk(g1), snk(g2), params)
    job = _DagJob(*args)
    assert job.eligible
    job.prepare()
    (aln_d, score_d), = popoa_dag_batch([job])
    aln_n, score_n = popoa_align(*args)
    assert score_d == score_n and np.array_equal(aln_d, aln_n), \
        "popoa_dag differs from the native PO-POA"
    say(f"[3 engines] popoa_dag {g1.node_size}x{g2.node_size} "
        "bit-identical to native")

    # chain_cdq: random anchors on a 20 kbp diagonal
    from centrolign_tpu.native import chain_affine_cdq
    from centrolign_tpu.ops.chain_cdq import chain_cdq_device
    n = 3000
    p1 = rng.integers(1, 20000, n)
    p2 = np.maximum(0, p1 + rng.integers(-40, 40, n))
    w = (rng.integers(1, 5, n) * 4.0).astype(np.float32)
    prob = (p1.astype(np.int64), (p1 + rng.integers(4, 40, n)).astype(
        np.int64), p2.astype(np.int64), (p2 + rng.integers(4, 40, n)).astype(
        np.int64), w, w.copy(), (1.25, 50.0, 5000.0), (2.5, 0.1, 0.0015),
        0.7)
    native, device = chain_affine_cdq(*prob), chain_cdq_device(*prob)
    tie = native[2] != 0
    for k, (x, y) in enumerate(zip(native, device)):
        if k == 1:   # backpointers agree where the winner is untied
            x, y = x[~tie], y[~tie]
        assert np.array_equal(x, y), f"chain_cdq output {k} differs"
    say(f"[3 engines] chain_cdq {n} anchors bit-identical to native")

    # chain_scan: tandem chain graphs through the anchorer
    from centrolign_tpu.anchorer import Anchorer, ChainAlgorithm
    from centrolign_tpu.match_finder import find_matches
    from centrolign_tpu.modify_graph import add_sentinels
    from centrolign_tpu.path_merge import ChainMerge
    from centrolign_tpu.score_function import ScoreFunction

    def chain(seq, name, a, b):
        g = BaseGraph()
        ids = g.add_nodes(np.asarray(seq, dtype=np.uint8))
        g.add_edges(ids[:-1], ids[1:])
        g.extend_path_array(g.add_path(name), ids)
        return g, add_sentinels(g, a, b)

    unit = rng.integers(0, 4, 2000)
    seq1 = np.concatenate([unit, unit])
    seq1[::17] = (seq1[::17] + 1) % 4
    seq2 = np.concatenate([unit, unit, unit[:500]])
    (g1, t1), (g2, t2) = chain(seq1, "a", 5, 6), chain(seq2, "b", 7, 8)
    sf = ScoreFunction()
    xm1, xm2 = ChainMerge(g1, t1), ChainMerge(g2, t2)

    def anchors():
        matches = find_matches(g1, g2, t1, t2, 3000, sf)
        return Anchorer(score_function=sf)._anchor_chain_global(
            matches, g1, g2, t1, t2, xm1, xm2, ChainAlgorithm.Sparse, 1.0,
            None)

    os.environ.pop("CENTROLIGN_TPU_DEVICE_CHAIN", None)
    native = anchors()
    os.environ["CENTROLIGN_TPU_DEVICE_CHAIN"] = "1"
    try:
        device = anchors()
    finally:
        del os.environ["CENTROLIGN_TPU_DEVICE_CHAIN"]
    assert len(native) == len(device) and len(native) > 0
    for a, b in zip(native, device):
        assert np.array_equal(a.walk1, b.walk1) and \
            np.array_equal(a.walk2, b.walk2), "chain_scan chain differs"
    say(f"[3 engines] chain_scan {len(native)}-anchor chain identical to "
        "native")


def phase_pair():
    from centrolign_tpu import metrics
    from centrolign_tpu.ops import gotoh_pallas as gp
    bag = []
    dispatch = gp.gotoh_dispatch

    def recording(bucket, jobs):
        bag.append((bucket, list(jobs)))
        return dispatch(bucket, jobs)

    gp.gotoh_dispatch = recording
    metrics.reset()
    try:
        out, wall = run_cli(["-v", "0", os.path.join(DATA, "pair.fasta")])
    finally:
        gp.gotoh_dispatch = dispatch
    assert out == read("ref_pair.cigar.txt"), \
        "pair CIGAR differs from benchdata/ref_pair.cigar.txt"
    pod = metrics.summary().get("pod", {"cells": 0, "count": 0})
    assert pod["cells"] > 0, "no gap was filled on the device"
    n_jobs = sum(len(j) for _, j in bag)
    say(f"[4 pair] CIGAR byte-identical; pod cells {pod['cells']} in "
        f"{n_jobs} device gaps, {len(bag)} launches; wall {wall:.2f} s "
        f"(first run, compiles included) on {RESULTS['card']}")
    RESULTS["pair_first_wall_s"] = wall
    RESULTS["pair_pod"] = pod
    RESULTS["pair_bag"] = sorted(
        [(len(s1), len(s2), p.num_pw, bool(swp)) for _, jobs in bag
         for s1, s2, swp, p in jobs], key=lambda x: -x[0] * x[1])
    return bag


def _plain_fill(par, a, b, num_diags, lane_is_i, npw, swap_pref):
    """The oracle's scan vmapped over a packed bucket: the plain version
    of kernel_fill that XLA compiles. Returns (bp, score) like it."""
    import jax
    from centrolign_tpu.ops.gotoh import _gotoh_scan

    def one(p, a_row, b_row):
        return _gotoh_scan(a_row, b_row, p[0], p[1], p[2], p[3],
                           p[4:4 + npw], p[4 + npw:4 + 2 * npw],
                           num_diags=num_diags, lane_is_i=lane_is_i,
                           npw=npw, swap_pref=swap_pref)

    return jax.vmap(one)(par, a, b)


def _time_bag(bag, variant):
    """Device time of the gap bag: the fill alone and the traceback alone,
    with the kernels or with the plain fill and the host traceback."""
    import jax
    from centrolign_tpu.ops import gotoh_pallas as gp
    from centrolign_tpu.ops.gotoh import _traceback_bp
    plain = jax.jit(_plain_fill, static_argnums=(3, 4, 5, 6))
    packed = []
    for bucket, jobs in bag:
        B = gp._pow2_bucket(len(jobs), 1)
        par, a, b = gp._pack_jobs(bucket, jobs, B)
        packed.append((bucket, len(jobs), par,
                       *jax.device_put((par, a, b))))

    def fill():
        outs = []
        for (W, D, lii, swp, npw), _n, _par, par, a, b in packed:
            if variant == "kernel":
                outs.append(gp.kernel_fill(par, a, b, D, lii, npw, swp,
                                           gp._block(W),
                                           interpret=gp.INTERPRET))
            else:
                outs.append(plain(par, a, b, D, lii, npw, swp))
        return jax.block_until_ready(outs)

    def traceback(fills):
        outs = []
        for ((W, D, lii, swp, npw), n, par_h, par, _a, _b), (bp, sc) in zip(
                packed, fills):
            if variant == "kernel":
                outs.append(gp.kernel_traceback(par, bp, sc, lii,
                                                interpret=gp.INTERPRET))
            else:
                bp_h, _sc = jax.device_get((bp, sc))
                outs.append([_traceback_bp(bp_h[k], int(par_h[k, 0]),
                                           int(par_h[k, 1]), lii, npw)
                             for k in range(n)])
        return jax.block_until_ready(outs)

    traceback(fill())          # compiled and warm from here on
    best = {"fill_s": [], "traceback_s": []}
    for _rep in range(3):
        t0 = time.perf_counter()
        fills = fill()
        best["fill_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        traceback(fills)
        best["traceback_s"].append(time.perf_counter() - t0)
    return {k: min(v) for k, v in best.items()}


def phase_timing(bag):
    cells = sum((len(s1) + 1) * (len(s2) + 1) for _, jobs in bag
                for s1, s2, _s, _p in jobs)
    bag_times = {}
    for variant in ("kernel", "plain"):
        bag_times[variant] = t = _time_bag(bag, variant)
        say(f"[5 timing] gap bag ({cells} cells, {len(bag)} launches) "
            f"{variant}: fill {t['fill_s'] * 1e3:.2f} ms, traceback "
            f"{t['traceback_s'] * 1e3:.2f} ms")
    walls = []
    for _rep in range(2):
        out, wall = run_cli(["-v", "0", os.path.join(DATA, "pair.fasta")])
        assert out == read("ref_pair.cigar.txt"), "pair CIGAR differs"
        walls.append(wall)
    say(f"[5 timing] pair CLI end to end, warm: "
        f"{', '.join(f'{w:.3f}' for w in walls)} s on {RESULTS['card']}")
    RESULTS["bag_cells"] = cells
    RESULTS["bag_times"] = bag_times
    RESULTS["pair_walls"] = walls


def phase_five():
    from centrolign_tpu import metrics
    metrics.reset()
    out, wall = run_cli(["-v", "0", "-T", os.path.join(DATA, "five.nwk"),
                         os.path.join(DATA, "five.fasta")])
    assert out == read("ref_five.gfa"), \
        "five-sequence GFA differs from benchdata/ref_five.gfa"
    pod = metrics.summary().get("pod", {"cells": 0, "count": 0})
    assert pod["cells"] > 0, "no gap of the MSA was filled on the device"
    say(f"[6 five] GFA byte-identical; pod cells {pod['cells']} in "
        f"{pod['count']} batches; wall {wall:.2f} s on {RESULTS['card']}")
    RESULTS["five_wall_s"] = wall
    RESULTS["five_pod"] = pod


def four_cards():
    """The five-sequence MSA with --hosts 4 in a child CLI whose pool
    workers each open one card. Returns the device as the workers' JAX
    reports it; this process never imports JAX."""
    from centrolign_tpu.device import card_power_line, visible_cards
    cards_seen = visible_cards()
    if len(cards_seen) != 4:
        raise SystemExit(f"--four-cards needs a GPU host with 4 cards; "
                         f"found {cards_seen}")
    RESULTS["card"] = card = card_power_line()
    say(f"[four cards] cards {cards_seen}: {card}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", "-v", "2",
         "--hosts", "4", "-T", os.path.join(DATA, "five.nwk"),
         os.path.join(DATA, "five.fasta")],
        cwd=HERE, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-4000:])
    assert proc.returncode == 0, f"--hosts 4 MSA exited {proc.returncode}"
    assert "Worker failed" not in proc.stderr, "a worker was lost"
    assert proc.stdout == read("ref_five.gfa"), \
        "--hosts 4 GFA differs from benchdata/ref_five.gfa"
    opened = {w: (platform, kind, c) for w, platform, kind, c in re.findall(
        r"Worker (\d+) opened (\S+) device '(.*)' on card (\S+)\.",
        proc.stderr)}
    cards = {c for _p, _k, c in opened.values()}
    assert len(opened) == 4 and len(cards) == 4, \
        f"expected four workers on four cards, saw {opened}"
    kinds = {(p, k) for p, k, _c in opened.values()}
    assert len(kinds) == 1 and next(iter(kinds))[0] == "gpu", kinds
    filled = re.findall(r"Subproblem \d+: worker (\d+) on card (\S+), "
                        r"(\d+) cells filled on the device\.", proc.stderr)
    pod = sum(int(n) for _w, _c, n in filled)
    assert pod > 0, f"no gap was filled on a card: {filled}"
    by_card = {}
    for _w, c, n in filled:
        by_card[c] = by_card.get(c, 0) + int(n)
    say(f"[four cards] GFA byte-identical; workers on cards "
        f"{sorted(cards)}; device cells by card {by_card}; wall "
        f"{wall:.2f} s on {card}")
    RESULTS["four_cards_wall_s"] = wall
    RESULTS["four_cards_pod_by_card"] = by_card
    platform, kind = next(iter(kinds))
    return {"platform": platform, "kind": kind, "count": len(cards)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--only", choices=["kernel"])
    ap.add_argument("--out", help="also write the measurements as JSON")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.four_cards:
        info = four_cards()
    else:
        info = phase_device()
        phase_kernel()
        if args.only != "kernel":
            phase_engines()
            bag = phase_pair()
            phase_timing(bag)
            phase_five()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
