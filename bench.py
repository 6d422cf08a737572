"""End-to-end benchmark on the GPU: pairwise alignment of a simulated
centromere pair (benchdata/pair.fasta, ~190 kbp + ~180 kbp) through the
normal CLI path — match finding -> sparse affine chaining -> partition ->
stitch (the device Gotoh kernel for chain x chain gaps) -> CIGAR.

Runs three reps in this one process (rep 0 also compiles the kernels) and
refuses to run when JAX finds no GPU. The CIGAR must be byte-identical to
benchdata/ref_pair.cigar.txt.

Prints the card's name and power limit, then ONE JSON line with:
  value / vs_baseline : best wall-clock seconds, and the speedup over the
                        reference C++ centrolign on the same input
                        (benchdata/baseline.json)
  device              : platform, device_kind and device count
  dp_cells_per_sec    : DP cell updates/sec through the stitch aligners
  aligners            : per-aligner counters (tag -> count/cells/seconds)
"""

import io
import json
import os
import sys
import time


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    from centrolign_tpu.device import card_power_line, require_gpu
    device = require_gpu()
    card = card_power_line()
    print(f"# {device['kind']} x{device['count']}; {card}", file=sys.stderr)

    from centrolign_tpu import metrics
    from centrolign_tpu.cli import main as cli_main

    with open(os.path.join(here, "benchdata", "baseline.json")) as f:
        ref_s = float(json.load(f)["reference_wall_s"])
    with open(os.path.join(here, "benchdata", "ref_pair.cigar.txt")) as f:
        ref_cigar = f.read()

    reps = []
    for _rep in range(3):
        metrics.reset()
        buf = io.StringIO()
        stdout, sys.stdout = sys.stdout, buf
        try:
            t0 = time.perf_counter()
            rc = cli_main(["-v", "0",
                           os.path.join(here, "benchdata", "pair.fasta")])
            elapsed = time.perf_counter() - t0
        finally:
            sys.stdout = stdout
        assert rc == 0, f"pipeline failed rc={rc}"
        assert buf.getvalue() == ref_cigar, \
            "CIGAR differs from benchdata/ref_pair.cigar.txt"
        reps.append((elapsed, metrics.summary()))

    elapsed, summ = min(reps, key=lambda r: r[0])
    print(json.dumps({
        "metric": "pairwise_centromere_msa_wall_clock",
        "value": elapsed,
        "unit": "s",
        "vs_baseline": ref_s / elapsed,
        "device": device,
        "card": card,
        "dp_cells_per_sec": summ["dp_cells_per_sec"],
        "device_cells": summ["device_cells"],
        "device_contribution_s": summ["device_contribution_s"],
        "aligners": {k: v for k, v in summ.items() if isinstance(v, dict)},
    }))


if __name__ == "__main__":
    main()
