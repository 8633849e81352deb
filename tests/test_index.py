"""Index build: CSR arrays vs the dict oracle; artifact round-trip."""

import numpy as np
import pytest

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.artifact import load_index, save_index
from sketch_rna_tpu.index.build import build_index
from sketch_rna_tpu.io.fasta import FastaRecords
from sketch_rna_tpu.oracle.reference_oracle import oracle_build_index

from util import decode, make_transcriptome


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(42)
    seqs = make_transcriptome(rng, n=20, len_range=(20, 900))
    names = [f"T{i:03d}" for i in range(len(seqs))]
    return FastaRecords(names, [decode(s) for s in seqs], 0), seqs


@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_build_matches_oracle(records, ks):
    recs, seqs = records
    cfg = QuantConfig(kmer_lengths=ks)
    idx = build_index(recs, cfg)
    oracle = oracle_build_index(seqs, ks, cfg.sketch_fraction)
    assert idx.num_transcripts == len(seqs)
    np.testing.assert_array_equal(idx.lengths, [len(s) for s in seqs])
    for k in ks:
        ki = idx.per_k[k]
        got = {}
        for i, h in enumerate(ki.keys):
            got[int(h)] = ki.postings[ki.row_ptr[i] : ki.row_ptr[i + 1]].tolist()
        want = {h: tids for h, tids in oracle[k].items()}
        assert got == want


def test_short_transcripts_excluded_from_postings(records):
    recs, seqs = records
    ks = (31,)
    cfg = QuantConfig(kmer_lengths=ks)
    idx = build_index(recs, cfg)
    short = {i for i, s in enumerate(seqs) if len(s) < 31}
    posted = set(idx.per_k[31].postings.tolist())
    assert not (short & posted)
    # ... but they remain in the transcript table (reference serializes
    # all transcripts, src/data_io.cpp:184-196).
    assert idx.num_transcripts == len(seqs)


def test_artifact_roundtrip(tmp_path, records):
    recs, _ = records
    cfg = QuantConfig(kmer_lengths=(21, 31))
    idx = build_index(recs, cfg)
    path = str(tmp_path / "test.skidx.npz")
    save_index(path, idx)
    idx2 = load_index(path)
    assert idx2.names == idx.names
    assert idx2.kmer_lengths == idx.kmer_lengths
    assert idx2.sketch_fraction == idx.sketch_fraction
    np.testing.assert_array_equal(idx2.lengths, idx.lengths)
    for k in idx.kmer_lengths:
        np.testing.assert_array_equal(idx2.per_k[k].keys, idx.per_k[k].keys)
        np.testing.assert_array_equal(idx2.per_k[k].row_ptr, idx.per_k[k].row_ptr)
        np.testing.assert_array_equal(idx2.per_k[k].postings, idx.per_k[k].postings)


@pytest.mark.slow  # runs the full build twice
def test_build_backends_identical(records, monkeypatch):
    """The CPU-backend build (the default without an accelerator) and
    the accelerator-path kernels
    (_hash_pos_batch + device pair sort) must produce identical CSR
    arrays — the backend is a performance choice, never a semantic one."""
    recs, _ = records
    cfg = QuantConfig(kmer_lengths=(21, 31))
    idx_cpu = build_index(recs, cfg)
    monkeypatch.setenv("SKETCH_TPU_INDEX_BACKEND", "accelerator")
    idx_acc = build_index(recs, cfg)
    for k in cfg.kmer_lengths:
        np.testing.assert_array_equal(idx_acc.per_k[k].keys, idx_cpu.per_k[k].keys)
        np.testing.assert_array_equal(
            idx_acc.per_k[k].row_ptr, idx_cpu.per_k[k].row_ptr
        )
        np.testing.assert_array_equal(
            idx_acc.per_k[k].postings, idx_cpu.per_k[k].postings
        )
