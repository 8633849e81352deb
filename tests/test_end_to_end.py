"""File-level golden test: FASTA + FASTQ fixtures -> CSV, vs the oracle
run on the same parsed inputs (SURVEY.md §4 "Golden end-to-end")."""

import csv
import subprocess
import sys

import numpy as np
import pytest

from sketch_rna_tpu.cli import main as cli_main
from sketch_rna_tpu.io.fasta import load_fasta
from sketch_rna_tpu.io.fastq import load_fastq_dict
from sketch_rna_tpu.io.packing import encode_sequence
from sketch_rna_tpu.oracle.reference_oracle import oracle_quant

from util import decode, make_transcriptome, sample_reads, write_fasta, write_fastq


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(2024)
    seqs = make_transcriptome(rng, n=16, len_range=(60, 500))
    names = [f"ENST{i:05d}.1" for i in range(len(seqs))]
    reads = sample_reads(rng, seqs, n_reads=200, read_len=90)
    read_names = [f"read_{i}/1" for i in range(len(reads))]
    fasta = tmp / "ref.fa"
    fastq = tmp / "reads.fq"
    write_fasta(str(fasta), names, [decode(s) for s in seqs])
    write_fastq(str(fastq), read_names, [decode(r) for r in reads])
    # Adversarial extras: an invalid read, a too-short read.
    with open(fastq, "a") as fh:
        fh.write("@bad_n\nACGTN" + "A" * 60 + "\n+\nI\n")
        fh.write("@too_short\nACGTACGT\n+\nIIIIIIII\n")
    return tmp, fasta, fastq, names, seqs, reads, read_names


def run_cli(args):
    rc = cli_main(args)
    assert rc == 0


def test_cli_index_quant_vs_oracle(fixture_files):
    tmp, fasta, fastq, names, seqs, reads, read_names = fixture_files
    idx_path = str(tmp / "ref.skidx.npz")
    csv_path = str(tmp / "out.csv")
    run_cli(["-o", "index", "-k", "31", str(fasta), idx_path])
    run_cli(["-o", "quant", idx_path, str(fastq), csv_path])

    # Oracle on identically parsed inputs.
    recs = load_fasta(str(fasta))
    assert recs.names == names
    seq_codes = [encode_sequence(s) for s in recs.seqs]
    rd = load_fastq_dict(str(fastq))
    read_codes = {
        rid: encode_sequence(s)
        for rid, s in rd.items()
        if encode_sequence(s) is not None and len(s) >= 31
    }
    segments, o_pi, o_weighted, o_csv_tids = oracle_quant(seq_codes, read_codes, (31,))

    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    assert [r["Name"] for r in rows] == [names[t] for t in o_csv_tids]
    for row, t in zip(rows, o_csv_tids):
        assert float(row["NumReads"]) == pytest.approx(o_weighted[t], rel=1e-5)
        assert float(row["EM_Abundance"]) == pytest.approx(o_pi[t], rel=1e-5)
    # Rank-identity of abundances across the emitted rows.
    got_rank = np.argsort([-float(r["EM_Abundance"]) for r in rows], kind="stable")
    want_rank = np.argsort([-o_pi[t] for t in o_csv_tids], kind="stable")
    np.testing.assert_array_equal(got_rank, want_rank)


def test_cli_multik(fixture_files):
    tmp, fasta, fastq, names, seqs, reads, read_names = fixture_files
    idx_path = str(tmp / "ref_mk.skidx.npz")
    csv_path = str(tmp / "out_mk.csv")
    run_cli(["-o", "index", "-k", "21,31", str(fasta), idx_path])
    run_cli(["-o", "quant", "-k", "63", idx_path, str(fastq), csv_path])  # -k ignored (Q1)

    recs = load_fasta(str(fasta))
    seq_codes = [encode_sequence(s) for s in recs.seqs]
    rd = load_fastq_dict(str(fastq))
    read_codes = {
        rid: encode_sequence(s)
        for rid, s in rd.items()
        if encode_sequence(s) is not None and len(s) >= 31
    }
    segments, o_pi, o_weighted, o_csv_tids = oracle_quant(seq_codes, read_codes, (21, 31))
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    assert [r["Name"] for r in rows] == [names[t] for t in o_csv_tids]
    for row, t in zip(rows, o_csv_tids):
        assert float(row["EM_Abundance"]) == pytest.approx(o_pi[t], rel=1e-5)


def test_cli_chunked_stream_route_matches_fused(fixture_files, monkeypatch):
    """Forcing the CLI's chunked-streaming route (native scan +
    chunks_from_scan + quantify_streamed) must reproduce the default
    fused route's CSV exactly."""
    from sketch_rna_tpu.io import native

    if not native.native_available():
        pytest.skip("native fastio not built")
    tmp, fasta, fastq, names, seqs, reads, read_names = fixture_files
    idx_path = str(tmp / "ref_cs.skidx.npz")
    run_cli(["-o", "index", "-k", "31", str(fasta), idx_path])
    csv_fused = str(tmp / "out_cs_fused.csv")
    run_cli(["-o", "quant", idx_path, str(fastq), csv_fused])

    import sketch_rna_tpu.pipeline as pl

    # Push every dataset over the "too big to fuse" edge and force tiny
    # chunks so several chunk iterations really happen.
    monkeypatch.setattr(pl, "FUSED_MAX_PADDED_READS", 8)
    csv_stream = str(tmp / "out_cs_stream.csv")
    run_cli(
        ["-o", "quant", "--stream-chunk-reads", "64", idx_path, str(fastq), csv_stream]
    )
    with open(csv_fused) as fh:
        fused_rows = list(csv.DictReader(fh))
    with open(csv_stream) as fh:
        stream_rows = list(csv.DictReader(fh))
    assert [r["Name"] for r in stream_rows] == [r["Name"] for r in fused_rows]
    for a, b in zip(stream_rows, fused_rows):
        assert float(a["NumReads"]) == pytest.approx(float(b["NumReads"]), rel=2e-5)
        assert float(a["EM_Abundance"]) == pytest.approx(
            float(b["EM_Abundance"]), rel=2e-5
        )


def test_cli_em_flags_match_default(fixture_files):
    """--em-segsum on must plumb through and reproduce the
    default route's CSV within float32 summation-order tolerance."""
    tmp, fasta, fastq, names, seqs, reads, read_names = fixture_files
    idx_path = str(tmp / "ref_ef.skidx.npz")
    run_cli(["-o", "index", "-k", "31", str(fasta), idx_path])
    base = str(tmp / "out_ef_base.csv")
    run_cli(["-o", "quant", idx_path, str(fastq), base])
    with open(base) as fh:
        base_rows = list(csv.DictReader(fh))
    for flag, value in (("--em-segsum", "on"),):
        out = str(tmp / f"out_ef_{flag.strip('-').replace('-', '_')}.csv")
        run_cli(["-o", "quant", flag, value, idx_path, str(fastq), out])
        with open(out) as fh:
            rows = list(csv.DictReader(fh))
        assert [r["Name"] for r in rows] == [r["Name"] for r in base_rows], flag
        for a, b in zip(rows, base_rows):
            assert float(a["EM_Abundance"]) == pytest.approx(
                float(b["EM_Abundance"]), rel=3e-5
            ), flag


def test_cli_subprocess_smoke(fixture_files):
    """The installed entry point works as a real process."""
    tmp, fasta, fastq, *_ = fixture_files
    idx_path = str(tmp / "ref_sp.skidx.npz")
    csv_path = str(tmp / "out_sp.csv")
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env.get("PYTHONPATH", "")]
    )
    r1 = subprocess.run(
        [sys.executable, "-m", "sketch_rna_tpu.cli", "-o", "index", str(fasta), idx_path],
        capture_output=True,
        text=True,
        env=env,
        timeout=240,
    )
    assert r1.returncode == 0, r1.stderr
    assert "Index built in" in r1.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "sketch_rna_tpu.cli", "-o", "quant", idx_path, str(fastq), csv_path],
        capture_output=True,
        text=True,
        env=env,
        timeout=240,
    )
    assert r2.returncode == 0, r2.stderr
    for phase in [
        "Loading index completed",
        "Loading read completed",
        "Sparse chaining completed",
        "EM estimation completed",
        "Read assignment completed",
        "Output written to",
    ]:
        assert phase in r2.stdout


def test_cli_lazy_stream_route_matches_fused(fixture_files, tmp_path, monkeypatch):
    """The big-file LazyScanFeed route (background scan + streaming
    engine) must produce the same CSV as the default fused route.
    SKETCH_TPU_STREAM_MIN_BYTES=1 forces the lazy route on the small
    fixture; FUSED_MAX_PADDED_READS is irrelevant there (the route is
    chosen by file size before any scan)."""
    import sketch_rna_tpu.io.native as native

    if not native.native_available():
        pytest.skip("native fastio unavailable")
    tmp, fasta, fastq, names, seqs, reads, read_names = fixture_files
    idx_path = str(tmp / "ref.skidx.npz")
    if not __import__("os").path.exists(idx_path):
        run_cli(["-o", "index", "-k", "31", str(fasta), idx_path])
    fused_csv = str(tmp_path / "fused.csv")
    lazy_csv = str(tmp_path / "lazy.csv")
    run_cli(["-o", "quant", idx_path, str(fastq), fused_csv])
    monkeypatch.setenv("SKETCH_TPU_STREAM_MIN_BYTES", "1")
    run_cli(["-o", "quant", idx_path, str(fastq), lazy_csv])
    with open(fused_csv) as a, open(lazy_csv) as b:
        ra = sorted(a.readlines())
        rb = sorted(b.readlines())
    assert len(ra) == len(rb) and len(ra) > 1
    for la, lb in zip(ra, rb):
        if la != lb:
            na, va, wa = la.strip().split(",")
            nb, vb, wb = lb.strip().split(",")
            assert na == nb
            assert abs(float(va) - float(vb)) <= 1e-4 * max(abs(float(vb)), 1.0)
            assert abs(float(wa) - float(wb)) <= 1e-4 * max(abs(float(wb)), 1.0)
