"""The multi-host layer scheduler must reproduce the serial run exactly:
final GFA, subalignment (-s) file, and subproblem checkpoint (-S) files."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_fasta(path, n_seqs, length=2500, seed=11):
    rng = np.random.default_rng(seed)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, length))

    def mut(s):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < 0.02
                       else c for c in s)
    with open(path, "w") as f:
        for i in range(n_seqs):
            f.write(f">s{i}\n{mut(base)}\n")


def _run(fa, out_dir, extra):
    env = dict(os.environ, CENTROLIGN_TPU_USE_DEVICE="0")
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", "-v", "0",
         "-s", str(out_dir / "sub.txt"), "-S", str(out_dir / "cp"),
         *extra, str(fa)],
        capture_output=True, text=True, timeout=500, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    return r.stdout


@pytest.mark.parametrize("n_seqs", [3, 5])
@pytest.mark.slow
def test_distributed_matches_serial(tmp_path, n_seqs):
    fa = tmp_path / "in.fa"
    _make_fasta(fa, n_seqs)
    ser_dir = tmp_path / "ser"
    dist_dir = tmp_path / "dist"
    ser_dir.mkdir()
    dist_dir.mkdir()
    out_ser = _run(fa, ser_dir, [])
    out_dist = _run(fa, dist_dir, ["--hosts", "4"])
    assert out_ser == out_dist, "stdout GFA differs"
    assert ((ser_dir / "sub.txt").read_text()
            == (dist_dir / "sub.txt").read_text()), "-s output differs"
    ser_files = sorted(p.name for p in ser_dir.iterdir())
    dist_files = sorted(p.name for p in dist_dir.iterdir())
    assert ser_files == dist_files
    for name in ser_files:
        a = (ser_dir / name).read_text()
        b = (dist_dir / name).read_text()
        if name == "cp_info.txt":  # embeds the output directory path
            a = a.replace(str(ser_dir), "")
            b = b.replace(str(dist_dir), "")
        assert a == b, f"-S file {name} differs"


def _make_tandem_fasta(path, n_seqs, unit=700, copies=2, seed=23):
    """Sequences that are `copies` mutated copies of one unit: the -c
    bonding rounds find the tandem duplication in every leaf."""
    rng = np.random.default_rng(seed)
    unit_seq = "".join("ACGT"[i] for i in rng.integers(0, 4, unit))

    def mut(s, rate=0.02):
        return "".join("ACGT"[rng.integers(0, 4)] if rng.random() < rate
                       else c for c in s)
    with open(path, "w") as f:
        for i in range(n_seqs):
            s = "".join(mut(unit_seq) for _ in range(copies))
            f.write(f">s{i}\n{s}\n")


def _run_cyclic(fa, out_dir, extra):
    env = dict(os.environ, CENTROLIGN_TPU_USE_DEVICE="0")
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", "-v", "0", "-c",
         "-y", "900",
         "-s", str(out_dir / "sub.txt"), "-S", str(out_dir / "cp"),
         "--bond-prefix", str(out_dir / "bond"),
         *extra, str(fa)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    return r.stdout


@pytest.mark.slow
def test_distributed_cyclization_matches_serial(tmp_path):
    """-c across workers: per-leaf bonding rounds fan out, and every
    output (GFA, -s, -S incl. the bonds restart file, --bonds cigars) must
    be byte-identical to the serial run."""
    fa = tmp_path / "in.fa"
    _make_tandem_fasta(fa, 3)
    ser_dir = tmp_path / "ser"
    dist_dir = tmp_path / "dist"
    ser_dir.mkdir()
    dist_dir.mkdir()
    out_ser = _run_cyclic(fa, ser_dir, [])
    out_dist = _run_cyclic(fa, dist_dir, ["--hosts", "3"])
    assert out_ser == out_dist, "stdout GFA differs"
    ser_files = sorted(p.name for p in ser_dir.iterdir())
    dist_files = sorted(p.name for p in dist_dir.iterdir())
    assert ser_files == dist_files
    for name in ser_files:
        a = (ser_dir / name).read_text()
        b = (dist_dir / name).read_text()
        if name == "cp_info.txt":
            a = a.replace(str(ser_dir), "")
            b = b.replace(str(dist_dir), "")
        assert a == b, f"output file {name} differs"


@pytest.mark.slow
def test_distributed_restart_matches_serial(tmp_path):
    """Kill a distributed -c -S run after its checkpoints exist, then -R
    restart it distributed: final outputs must equal an uninterrupted
    serial run."""
    fa = tmp_path / "in.fa"
    _make_tandem_fasta(fa, 3, seed=41)
    ser_dir = tmp_path / "ser"
    dist_dir = tmp_path / "dist"
    ser_dir.mkdir()
    dist_dir.mkdir()
    out_ser = _run_cyclic(fa, ser_dir, [])
    # first distributed pass writes the checkpoints; then wipe the root's
    # completion marker... simplest faithful interruption: run fully, drop
    # the LAST subproblem file, and restart
    out_first = _run_cyclic(fa, dist_dir, ["--hosts", "3"])
    subs = sorted(dist_dir.glob("cp*.gfa"))
    assert subs, "expected subproblem checkpoints"
    biggest = max(subs, key=lambda p: p.stat().st_size)
    biggest.unlink()
    out_dist = _run_cyclic(fa, dist_dir, ["--hosts", "3", "-R"])
    assert out_dist == out_ser == out_first, "restarted GFA differs"


def _run_fail(fa, out_dir, extra, fail_mode, cyclic=False, rc=0):
    env = dict(os.environ, CENTROLIGN_TPU_USE_DEVICE="0",
               CENTROLIGN_TPU_TEST_WORKER_FAIL=fail_mode)
    cyc = ["-c", "-y", "900"] if cyclic else []
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", "-v", "1", *cyc,
         "-s", str(out_dir / "sub.txt"), "-S", str(out_dir / "cp"),
         *extra, str(fa)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    assert (r.returncode == 0) == (rc == 0), r.stderr[-1500:]
    return r.stdout, r.stderr


@pytest.mark.slow
@pytest.mark.parametrize("fail_mode", ["2"])
def test_worker_failure_recovery(tmp_path, fail_mode):
    """Recovery from dead workers: with every worker process killed
    outright (broken pool), the scheduler recomputes each subproblem inline
    and the outputs stay byte-identical to the serial run."""
    fa = tmp_path / "in.fa"
    _make_fasta(fa, 5, seed=17)
    ser_dir = tmp_path / "ser"
    fail_dir = tmp_path / "fail"
    ser_dir.mkdir()
    fail_dir.mkdir()
    out_ser = _run(fa, ser_dir, [])
    out_fail, err = _run_fail(fa, fail_dir, ["--hosts", "3"], fail_mode)
    assert "Worker failed" in err, "recovery path never engaged"
    assert out_ser == out_fail, "stdout GFA differs after worker failures"
    assert ((ser_dir / "sub.txt").read_text()
            == (fail_dir / "sub.txt").read_text()), "-s output differs"
    ser_files = sorted(p.name for p in ser_dir.iterdir())
    fail_files = sorted(p.name for p in fail_dir.iterdir())
    assert ser_files == fail_files
    for name in ser_files:
        a = (ser_dir / name).read_text()
        b = (fail_dir / name).read_text()
        if name == "cp_info.txt":
            a = a.replace(str(ser_dir), "")
            b = b.replace(str(fail_dir), "")
        assert a == b, f"-S file {name} differs"


@pytest.mark.slow
def test_worker_failure_recovery_cyclic(tmp_path):
    """-c with dying workers: the per-leaf bonding rounds recompute
    inline and the cyclized GFA matches the serial run."""
    fa = tmp_path / "in.fa"
    _make_tandem_fasta(fa, 3, seed=53)
    ser_dir = tmp_path / "ser"
    fail_dir = tmp_path / "fail"
    ser_dir.mkdir()
    fail_dir.mkdir()
    out_ser = _run_cyclic(fa, ser_dir, [])
    out_fail, err = _run_fail(fa, fail_dir, ["--hosts", "3"], "2",
                              cyclic=True)
    assert "Worker failed" in err, "recovery path never engaged"
    assert out_ser == out_fail, "cyclized GFA differs after worker failures"


@pytest.mark.slow
def test_worker_error_propagates(tmp_path):
    """An error raised inside a worker (a device error, say) is not
    recovered from: the run fails with it and never reruns elsewhere."""
    fa = tmp_path / "in.fa"
    _make_fasta(fa, 3, seed=17)
    _out, err = _run_fail(fa, tmp_path, ["--hosts", "2"], "1", rc=1)
    assert "injected worker failure" in err
    assert "Worker failed" not in err
