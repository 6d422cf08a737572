#!/bin/bash
# 50-sequence centromere-scale MSA measurement (BASELINE.json config 5 scale class,
# sequences at the bottom of the 100kbp-10Mbp band: 50 x ~184 kbp, 9.18 Mbp total,
# simulated with tools/sim_centromere from benchdata/anc.fasta on fifty.nwk).
#
# Usage: run_fifty.sh [ours|ref|compare|all]     (default: all)
#
# Each leg runs with subproblem checkpointing (-S) and auto-resumes (-R) from
# any earlier partial run, so a wall-clock-limited session can finish the
# measurement in pieces; per-attempt records append to /tmp/fifty_run/<tag>.attempts.jsonl
# and `compare` aggregates both legs + a GFA parity verdict into
# benchdata/results_r05.json.
#
# The reference binary defaults to /tmp/refbuild/centrolign; tests/conftest.py
# builds it automatically from /root/reference (cmake -B /tmp/refbuild), or set
# REF_BIN. Reference restart contract: /root/reference/src/execution.cpp:223-279.
set -u
cd "$(dirname "$0")/.."
RUNDIR=${RUNDIR:-/tmp/fifty_run}
REF_BIN=${REF_BIN:-/tmp/refbuild/centrolign}
mkdir -p "$RUNDIR"
leg=${1:-all}

measure() {  # measure <tag> <cmd...>; appends an attempt record, resumes via -R
  local tag=$1; shift
  mkdir -p "$RUNDIR/ckpt_$tag"
  local resume=()
  if ls "$RUNDIR/ckpt_$tag"/chk_*.gfa >/dev/null 2>&1; then
    resume=(-R)
    echo "[$tag] resuming from $(ls "$RUNDIR/ckpt_$tag"/chk_*.gfa | wc -l) checkpointed subproblems"
  fi
  python - "$tag" "$RUNDIR" "$@" "${resume[@]}" -S "$RUNDIR/ckpt_$tag/chk" <<'PYEOF'
import json, resource, subprocess, sys, time
tag, rundir, cmd = sys.argv[1], sys.argv[2], sys.argv[3:]
t0 = time.monotonic()
with open(f"{rundir}/{tag}.gfa", "wb") as out, \
     open(f"{rundir}/{tag}.log", "wb") as err:
    rc = subprocess.run(cmd, stdout=out, stderr=err).returncode
wall = time.monotonic() - t0
ru = resource.getrusage(resource.RUSAGE_CHILDREN)
rec = {"tag": tag, "rc": rc, "wall_s": round(wall, 1),
       "user_s": round(ru.ru_utime, 1), "sys_s": round(ru.ru_stime, 1),
       "max_rss_gb": round(ru.ru_maxrss / 1024**2, 2),
       "resumed": "-R" in cmd}
print(json.dumps(rec))
with open(f"{rundir}/{tag}.attempts.jsonl", "a") as f:
    f.write(json.dumps(rec) + "\n")
sys.exit(0 if rc == 0 else 1)
PYEOF
  local rc=$?
  if [ $rc -ne 0 ]; then
    echo "[$tag] RUN FAILED (rc!=0) — log tail:"; tail -3 "$RUNDIR/$tag.log"
    return 1
  fi
  if [ ! -s "$RUNDIR/$tag.gfa" ]; then
    echo "[$tag] RUN FAILED (empty GFA)"; tail -3 "$RUNDIR/$tag.log"; return 1
  fi
  tail -2 "$RUNDIR/$tag.log"
}

run_ours() {
  echo "== ours =="
  measure ours python -m centrolign_tpu.cli -v 1 -T benchdata/fifty.nwk benchdata/fifty.fasta
}

run_ref() {
  echo "== reference =="
  if [ ! -x "$REF_BIN" ]; then
    echo "[ref] RUN FAILED: reference binary not found at $REF_BIN" \
         "(build: cmake -B /tmp/refbuild -DCMAKE_BUILD_TYPE=Release /root/reference && cmake --build /tmp/refbuild -j)"
    return 1
  fi
  measure ref "$REF_BIN" -v 1 -T benchdata/fifty.nwk benchdata/fifty.fasta
}

aggregate() {
  python - "$RUNDIR" <<'PYEOF'
import json, os, sys
rundir = sys.argv[1]
out = {"config": "50 x ~184 kbp simulated centromeres (benchdata/fifty.fasta), "
                 "on the host and GPU this script runs on",
       "note": "wall_s sums all resume attempts; user_s is the "
               "scheduler-sharing-robust metric on this shared box"}
have = True
for tag in ("ours", "ref"):
    path = f"{rundir}/{tag}.attempts.jsonl"
    if not os.path.exists(path):
        print(f"[compare] missing {path} — run the '{tag}' leg first"); have = False; continue
    attempts = [json.loads(l) for l in open(path)]
    done = attempts[-1]["rc"] == 0 and os.path.getsize(f"{rundir}/{tag}.gfa") > 0
    out[tag] = {"wall_s": round(sum(a["wall_s"] for a in attempts), 1),
                "user_s": round(sum(a["user_s"] for a in attempts), 1),
                "max_rss_gb": max(a["max_rss_gb"] for a in attempts),
                "attempts": len(attempts), "completed": done}
    if not done:
        # a leg that cannot finish is itself a result (e.g. the reference
        # binary was OOM-killed at ~125 GB on this box): record the
        # evidence instead of refusing to write the JSON
        out[tag]["failure"] = attempts[-1].get("note") or \
            f"last attempt rc={attempts[-1]['rc']}"
        print(f"[compare] {tag} leg has not completed successfully "
              f"(recorded as incomplete)")
if not have:
    sys.exit(1)
both = out["ours"]["completed"] and out["ref"]["completed"]
if both:
    ours = open(f"{rundir}/ours.gfa", "rb").read()
    ref = open(f"{rundir}/ref.gfa", "rb").read()
    out["gfa_byte_identical"] = ours == ref
    out["speedup_wall"] = round(out["ref"]["wall_s"] / out["ours"]["wall_s"], 3)
    out["speedup_user"] = round(out["ref"]["user_s"] / out["ours"]["user_s"], 3)
# per-subproblem byte parity: the two tools share the checkpoint digest
# scheme, so every subproblem BOTH completed is directly comparable even
# when a leg has not finished (e.g. the reference ran out of wall/RAM)
shared = ident = 0
ours_dir, ref_dir = f"{rundir}/ckpt_ours", f"{rundir}/ckpt_ref"
if os.path.isdir(ours_dir) and os.path.isdir(ref_dir):
    ref_names = set(os.listdir(ref_dir))
    for name in sorted(os.listdir(ours_dir)):
        if not name.endswith(".gfa") or name not in ref_names:
            continue
        shared += 1
        a = open(os.path.join(ours_dir, name), "rb").read()
        b = open(os.path.join(ref_dir, name), "rb").read()
        ident += int(a == b)
    out["shared_subproblems"] = shared
    out["shared_subproblems_byte_identical"] = ident
    # per-subproblem wall estimates from checkpoint mtime deltas
    # (caveats: host sharing inflates both legs; deltas spanning a
    # resume gap (> 2 h) are dropped as attempt boundaries)
    per = {}
    for tag, d in (("ours", ours_dir), ("ref", ref_dir)):
        files = sorted(((os.path.getmtime(os.path.join(d, n)), n)
                        for n in os.listdir(d) if n.endswith(".gfa")))
        for (t0, _), (t1, name) in zip(files, files[1:]):
            dt = t1 - t0
            if dt < 7200:
                per.setdefault(name, {})[tag] = round(dt, 1)
    out["per_subproblem_wall_s"] = {
        k: v for k, v in sorted(per.items()) if len(v) == 2}
with open("benchdata/results_r05.json", "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out, indent=1))
print("wrote benchdata/results_r05.json")
PYEOF
}

case "$leg" in
  ours)    run_ours ;;
  ref)     run_ref ;;
  compare) aggregate ;;
  all)     run_ours && run_ref && aggregate ;;
  *) echo "usage: $0 [ours|ref|compare|all]"; exit 2 ;;
esac
