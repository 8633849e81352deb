"""quantify_sharded public API (auto mesh over all devices) equals the
single-device quantify, and works through the CLI flag."""

import numpy as np

from sketch_rna_tpu.cli import main as cli_main
from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.build import build_index
from sketch_rna_tpu.io.fasta import FastaRecords
from sketch_rna_tpu.io.packing import PackedReads
from sketch_rna_tpu.pipeline import quantify, quantify_sharded

from util import decode, make_transcriptome, sample_reads, write_fasta, write_fastq


def test_quantify_sharded_auto_mesh():
    rng = np.random.default_rng(55)
    seqs = make_transcriptome(rng, n=12, len_range=(60, 400))
    recs = FastaRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    cfg = QuantConfig(kmer_lengths=(31,), batch_size=64, max_read_len=128, em_dtype="float64")
    idx = build_index(recs, cfg)
    reads = [r for r in sample_reads(rng, seqs, n_reads=100, read_len=90) if r.size >= 31]
    codes = np.zeros((len(reads), 128), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    packed = PackedReads(codes, lens, [str(i) for i in range(len(reads))])

    a = quantify(idx, packed, cfg)
    b = quantify_sharded(idx, packed, cfg)
    np.testing.assert_allclose(a.pi, b.pi, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a.weighted_counts, b.weighted_counts, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(a.has_entry, b.has_entry)
    assert a.em_iterations == b.em_iterations


def test_cli_sharded_flag(tmp_path):
    rng = np.random.default_rng(56)
    seqs = make_transcriptome(rng, n=8, len_range=(60, 300))
    names = [f"T{i}" for i in range(len(seqs))]
    fasta = tmp_path / "r.fa"
    fq = tmp_path / "r.fq"
    write_fasta(str(fasta), names, [decode(s) for s in seqs])
    reads = sample_reads(rng, seqs, n_reads=50, read_len=80)
    write_fastq(str(fq), [f"r{i}" for i in range(len(reads))], [decode(r) for r in reads])
    idx = str(tmp_path / "r.npz")
    out_a = str(tmp_path / "a.csv")
    out_b = str(tmp_path / "b.csv")
    assert cli_main(["-o", "index", str(fasta), idx]) == 0
    assert cli_main(["-o", "quant", idx, str(fq), out_a]) == 0
    assert cli_main(["-o", "quant", "--sharded", idx, str(fq), out_b]) == 0
    assert open(out_a).read() == open(out_b).read()


def test_quantify_sharded_empty_reads():
    # R == 0 must yield the same clean empty result as quantify(), not
    # inf pi from the pc/0 EM term.
    rng = np.random.default_rng(57)
    seqs = make_transcriptome(rng, n=6, len_range=(60, 200))
    recs = FastaRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    cfg = QuantConfig(kmer_lengths=(31,), batch_size=64, max_read_len=128)
    idx = build_index(recs, cfg)
    packed = PackedReads(np.zeros((0, 128), np.uint8), np.zeros(0, np.int32), [])
    a = quantify(idx, packed, cfg)
    b = quantify_sharded(idx, packed, cfg)
    assert b.num_reads == 0 and b.em_iterations == 0
    assert np.isfinite(b.pi).all()
    np.testing.assert_array_equal(a.pi, b.pi)
    np.testing.assert_array_equal(a.has_entry, b.has_entry)


def test_sharded_class_overflow_retries_exact(caplog):
    """Distinct classes exceed the per-device buffer: the sharded engine
    must rerun its device-resident scan with a doubled buffer until the
    overflow clears, staying exactly equal to quantify()."""
    import dataclasses
    import logging

    rng = np.random.default_rng(910009)
    seqs = make_transcriptome(rng, n=20, len_range=(60, 700))
    recs = FastaRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    cfg = QuantConfig(
        kmer_lengths=(21,),
        batch_size=32,
        max_read_len=128,
        em_dtype="float64",
        stream_class_capacity=64,  # per-device m_cap = max(64, 2*B) = 64
    )
    idx = build_index(recs, cfg)
    reads = [r for r in sample_reads(rng, seqs, n_reads=800, read_len=70,
                                     error_rate=0.02) if r.size >= 21]
    codes = np.zeros((len(reads), 128), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    packed = PackedReads(codes, lens, [str(i) for i in range(len(reads))])

    a = quantify(idx, packed, cfg)
    with caplog.at_level(logging.WARNING, logger="sketch_rna_tpu.pipeline"):
        b = quantify_sharded(idx, packed, cfg)
    # The retry engaged (the workload genuinely overflows 64 rows)...
    assert any("rerunning with" in r.message for r in caplog.records)
    # ...and the final result is overflow-free and exact.
    assert b.stats.get("class_overflow", 0) == 0
    np.testing.assert_allclose(a.pi, b.pi, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a.weighted_counts, b.weighted_counts, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(a.has_entry, b.has_entry)

    # With stream_drain=False the old counted-drop behavior remains.
    c = quantify_sharded(idx, packed, dataclasses.replace(cfg, stream_drain=False))
    assert c.stats.get("class_overflow", 0) > 0


def test_sharded_spill_plus_overflow_stays_flat(monkeypatch, caplog):
    """Pretail spill AND class overflow together: the overflow retry
    must rerun FLAT (the regression was re-running tiered, quietly
    reintroducing the dropped events)."""
    import logging

    import sketch_rna_tpu.pipeline as pl

    rng = np.random.default_rng(910009)
    # Tiering engages at >= 1024 rows per device batch.  A (data=1,
    # index=2) mesh puts all 16384 reads on one data shard against a
    # 2*B = 2048-row buffer, so the 200-isoform-family transcriptome's
    # distinct candidate profiles genuinely overflow it.
    seqs = make_transcriptome(rng, n=200, len_range=(60, 500))
    recs = FastaRecords([f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0)
    cfg = QuantConfig(
        kmer_lengths=(21,),
        batch_size=1024,
        max_read_len=128,
        em_dtype="float64",
        stream_class_capacity=64,
        chain_fraction=0.5,  # wider candidate profiles -> more classes
    )
    idx = build_index(recs, cfg)
    reads = [r for r in sample_reads(rng, seqs, n_reads=16384, read_len=100,
                                     error_rate=0.04) if r.size >= 21]
    codes = np.zeros((len(reads), 128), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    packed = PackedReads(codes, lens, [str(i) for i in range(len(reads))])

    a = quantify(idx, packed, cfg)

    # Under-size the tier windows so the tiered sharded scan spills.
    real = pl._tier_widths_for
    monkeypatch.setattr(
        pl, "_tier_widths_for", lambda *args, **kw: ((1, 2), 1)
    )
    from sketch_rna_tpu.dist.mesh import make_mesh

    with caplog.at_level(logging.WARNING, logger="sketch_rna_tpu.pipeline"):
        b = quantify_sharded(idx, packed, cfg, mesh=make_mesh(1, 2))
    assert any("rerunning flat" in r.message for r in caplog.records)
    assert any("rerunning with" in r.message for r in caplog.records)
    assert b.stats.get("class_overflow", 0) == 0
    assert b.stats.get("expand_dropped_pretail", 0) == 0
    np.testing.assert_allclose(a.pi, b.pi, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a.weighted_counts, b.weighted_counts, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(a.has_entry, b.has_entry)
