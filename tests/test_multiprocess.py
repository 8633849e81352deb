"""REAL multi-process execution: two OS processes under
jax.distributed.initialize (local coordinator, CPU backend, 2 virtual
devices each -> a 4-device global mesh), each parsing only its
byte-range slice of the FASTQ through the actual CLI, must reproduce
the single-process CSV exactly.

This is the N=2-host test: collectives cross a
process boundary (gloo), data is process-local, and only process 0
writes output.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from util import decode, make_transcriptome, sample_reads, write_fasta, write_fastq

pytestmark = pytest.mark.slow  # spawns 2-process jax.distributed CLI runs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, extra_env, timeout=420):
    env = dict(os.environ)
    env.update(extra_env)
    env["PYTHONPATH"] = _REPO
    return subprocess.Popen(
        [sys.executable, "-m", "sketch_rna_tpu.cli", *args],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        cwd=_REPO,
    )


def _read_csv(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return {r[0]: (float(r[1]), float(r[2])) for r in rows[1:]}


def _assert_really_distributed(outs):
    """Guard against the silent single-process fallback: if
    jax.distributed.initialize fails, each process quantifies the whole
    file on its own and the CSV comparison passes vacuously (this
    happened: a module-level jnp constant initialized the backend at
    import, breaking initialize in every CLI run).  Real distributed
    runs have exactly one primary writer and no init failure."""
    assert not any("initialize failed" in o for o in outs), outs[0]
    writers = sum("Output written" in o for o in outs)
    assert writers == 1, f"expected 1 primary writer, got {writers}"


def test_two_process_cli_matches_single(tmp_path):
    rng = np.random.default_rng(77)
    seqs = make_transcriptome(rng, n=12, len_range=(60, 400))
    fa = tmp_path / "ref.fa"
    fq = tmp_path / "reads.fq"
    write_fasta(str(fa), [f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs])
    reads = [r for r in sample_reads(rng, seqs, n_reads=240, read_len=90) if r.size >= 31]
    write_fastq(str(fq), [f"r{i}" for i in range(len(reads))], [decode(r) for r in reads])

    base_env = {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_ENABLE_X64": "1",
    }
    idx = str(tmp_path / "ref.idx.npz")
    single_csv = str(tmp_path / "single.csv")
    multi_csv = str(tmp_path / "multi.csv")

    p = _run_cli(["-o", "index", "-k", "31", str(fa), idx], base_env)
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    p = _run_cli(
        ["-o", "quant", "--em-dtype", "float64", idx, str(fq), single_csv],
        base_env,
    )
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    port = 29731
    procs = []
    for pid in range(2):
        procs.append(
            _run_cli(
                [
                    "-o",
                    "quant",
                    "--em-dtype",
                    "float64",
                    "--coordinator",
                    f"localhost:{port}",
                    "--num-processes",
                    "2",
                    "--process-id",
                    str(pid),
                    idx,
                    str(fq),
                    multi_csv,
                ],
                base_env,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    _assert_really_distributed(outs)

    a = _read_csv(single_csv)
    b = _read_csv(multi_csv)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-12)


def test_two_process_overflow_retry_consensus(tmp_path):
    """The sharded class-overflow retry is a host-side branch taken from
    psum'd scalars; both processes must take it identically (a diverged
    branch deadlocks or corrupts collectives).  Tiny buffer + diverse
    reads force the retry across a REAL 2-process mesh."""
    rng = np.random.default_rng(910)
    seqs = make_transcriptome(rng, n=40, len_range=(60, 500))
    fa = tmp_path / "ref.fa"
    fq = tmp_path / "reads.fq"
    write_fasta(str(fa), [f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs])
    reads = [
        r
        for r in sample_reads(rng, seqs, n_reads=600, read_len=80, error_rate=0.02)
        if r.size >= 31
    ]
    write_fastq(str(fq), [f"r{i}" for i in range(len(reads))], [decode(r) for r in reads])

    base_env = {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_ENABLE_X64": "1",
    }
    knobs = ["--batch-size", "32", "--stream-class-capacity", "64"]
    idx = str(tmp_path / "ref.idx.npz")
    single_csv = str(tmp_path / "single.csv")
    multi_csv = str(tmp_path / "multi.csv")

    p = _run_cli(["-o", "index", "-k", "31", str(fa), idx], base_env)
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    p = _run_cli(
        ["-o", "quant", "--em-dtype", "float64", *knobs, idx, str(fq), single_csv],
        base_env,
    )
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    port = 29741
    procs = []
    for pid in range(2):
        procs.append(
            _run_cli(
                [
                    "-o", "quant", "--em-dtype", "float64", *knobs,
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                    idx, str(fq), multi_csv,
                ],
                base_env,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    _assert_really_distributed(outs)
    # The retry must actually have engaged (the warning is printed by
    # every process; the workload overflows 64 rows by construction).
    assert any("rerunning with" in out for out in outs), outs[0]

    a = _read_csv(single_csv)
    b = _read_csv(multi_csv)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-12)


def test_two_process_multisample(tmp_path):
    """Multi-sample under a REAL 2-process mesh: each process parses
    only its slice of each sample; per-sample CSVs match single-process
    runs exactly and only the primary writes them."""
    rng = np.random.default_rng(88)
    seqs = make_transcriptome(rng, n=10, len_range=(60, 350))
    fa = tmp_path / "ref.fa"
    write_fasta(str(fa), [f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs])
    fqs = []
    for s in range(2):
        reads = [r for r in sample_reads(rng, seqs, n_reads=90, read_len=80)
                 if r.size >= 31]
        fq = tmp_path / f"s{s}.fq"
        write_fastq(str(fq), [f"s{s}_r{i}" for i in range(len(reads))],
                    [decode(r) for r in reads])
        fqs.append(str(fq))

    base_env = {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_ENABLE_X64": "1",
    }
    idx = str(tmp_path / "ref.idx.npz")
    p = _run_cli(["-o", "index", "-k", "31", str(fa), idx], base_env)
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    single_out = str(tmp_path / "single.csv")
    p = _run_cli(["-o", "quant", "--em-dtype", "float64", idx,
                  ",".join(fqs), single_out], base_env)
    out, _ = p.communicate(timeout=420)
    assert p.returncode == 0, out.decode()

    multi_out = str(tmp_path / "multi.csv")
    port = 29751
    procs = [
        _run_cli(
            ["-o", "quant", "--em-dtype", "float64",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             idx, ",".join(fqs), multi_out],
            base_env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert not any("initialize failed" in o for o in outs), outs[0]

    for s in range(2):
        with open(tmp_path / f"single.s{s}.csv") as a, \
             open(tmp_path / f"multi.s{s}.csv") as b:
            assert a.read() == b.read()
