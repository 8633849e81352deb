"""Parser/packing edge cases mirroring reference skip rules
(SURVEY.md §4: "FASTA/FASTQ parsing incl. the reference's skip rules")."""

import numpy as np

from sketch_rna_tpu.io.fasta import load_fasta
from sketch_rna_tpu.io.fastq import iter_fastq_records, load_fastq_dict
from sketch_rna_tpu.io.packing import encode_sequence, is_valid_sequence, pack_reads


def test_is_valid_sequence():
    assert is_valid_sequence("ACGT")
    assert is_valid_sequence("")  # empty is valid in the reference too
    assert not is_valid_sequence("ACGTN")
    assert not is_valid_sequence("acgt")  # lowercase invalid (reference LUT)
    assert not is_valid_sequence("ACG T")
    assert not is_valid_sequence("ACGU")


def test_encode_sequence():
    np.testing.assert_array_equal(encode_sequence("ACGT"), [0, 1, 2, 3])
    assert encode_sequence("ACGN") is None


def test_fasta_multiline_and_id_extraction(tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(
        ">tx1 some description here\nACGTACGT\nACGT\n\n"
        ">tx2\nGGGG\n"
        ">tx3_bad\nACGTN\n"  # invalid -> dropped (we validate ALL records)
        ">tx1 duplicate id\nTTTT\n"  # dup header: first wins
    )
    recs = load_fasta(str(p))
    assert recs.names == ["tx1", "tx2"]
    assert recs.seqs == ["ACGTACGTACGT", "GGGG"]
    assert recs.n_invalid == 1


def test_fasta_last_record_validated(tmp_path):
    # Reference quirk Q2: last record skips validation; we fix that.
    p = tmp_path / "t.fa"
    p.write_text(">a\nACGT\n>b\nNNNN\n")
    recs = load_fasta(str(p))
    assert recs.names == ["a"]
    assert recs.n_invalid == 1


def test_fastq_header_heuristic_and_full_id(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text(
        "garbage line\n"
        "@r1 desc kept in id\nACGT\n+\nIIII\n"
        "@r2\nGGTT\n+anything\n@@II\n"  # quality starting '@' consumed in-record
        "@r1 desc kept in id\nTTTT\n+\nIIII\n"  # dup id: LAST wins
    )
    recs = list(iter_fastq_records(str(p)))
    assert [r[0] for r in recs] == ["r1 desc kept in id", "r2", "r1 desc kept in id"]
    d = load_fastq_dict(str(p))
    assert d["r1 desc kept in id"] == "TTTT"
    assert d["r2"] == "GGTT"


def test_fastq_invalid_duplicate_does_not_clobber(tmp_path):
    # The reference only inserts VALIDATED reads into read_sketches
    # (src/main.cpp:132-150): a later invalid or too-short record with
    # the same ID must not erase an earlier valid read.
    p = tmp_path / "dup.fq"
    p.write_text(
        "@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
        "@r1\nACGTNNNN\n+\nIIIIIIII\n"  # invalid chars: skipped, not clobbering
        "@r2\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
        "@r2\nACG\n+\nIII\n"  # too short for min_len: skipped
        "@r3\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
        "@r3\nTTTTTTTTTTTT\n+\nIIIIIIIIIIII\n"  # valid dup: last wins
    )
    d = load_fastq_dict(str(p), min_len=8)
    assert d["r1"] == "ACGTACGTACGT"
    assert d["r2"] == "ACGTACGTACGT"
    assert d["r3"] == "TTTTTTTTTTTT"


def test_pack_reads_filters(tmp_path):
    seqs = ["ACGT" * 10, "ACGTN" + "A" * 40, "ACG", "A" * 50]
    ids = ["ok", "invalid", "short", "ok2"]
    packed, n_invalid, n_too_long = pack_reads(seqs, ids, min_len=31, pad_len=64)
    assert packed.ids == ["ok", "ok2"]
    assert n_invalid == 2  # invalid chars + too short both counted
    assert n_too_long == 0
    assert packed.codes.shape == (2, 64)
    np.testing.assert_array_equal(packed.lengths, [40, 50])
    # Padding is zeros past the length.
    assert (packed.codes[0, 40:] == 0).all()


def test_pack_reads_batches():
    seqs = ["ACGT" * 10] * 5
    packed, _, _ = pack_reads(seqs, [str(i) for i in range(5)], min_len=4, pad_len=48)
    batches = list(packed.batches(2))
    assert len(batches) == 3
    c, l, off = batches[2]
    assert c.shape == (2, 48)
    assert l[1] == 0  # padded row
    assert off == 4


def test_fastq_byte_ranges_cover_exactly(tmp_path):
    # Union of disjoint byte ranges == full sequential parse, each record
    # exactly once — including quality lines that start with '@'.
    from sketch_rna_tpu.io.fastq import (
        byte_range_for_process,
        iter_fastq_records_range,
    )

    rng = np.random.default_rng(123)
    p = tmp_path / "big.fq"
    recs = []
    with open(p, "w") as fh:
        for i in range(200):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=40))
            qual = "@" + "I" * 39 if i % 3 == 0 else "I" * 40  # '@'-leading quality
            fh.write(f"@r{i} d\n{seq}\n+\n{qual}\n")
            recs.append((f"r{i} d", seq, qual))
    full = list(iter_fastq_records(str(p)))
    assert full == recs
    for nproc in (2, 3, 5):
        got = []
        for pi in range(nproc):
            a, b = byte_range_for_process(str(p), pi, nproc)
            got.extend(iter_fastq_records_range(str(p), a, b))
        assert got == recs, nproc


def test_load_fastq_with_quality(tmp_path):
    """Quality strings survive with the same validation/duplicate rules
    as the sequence-only loader (reference Read model,
    include/data_io.h:38-43)."""
    from sketch_rna_tpu.io.fastq import load_fastq_dict, load_fastq_with_quality

    fq = tmp_path / "q.fq"
    fq.write_text(
        "@r1\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
        "@r2\nACGTNNGT\n+\nIIIIIIII\n"          # invalid: N
        "@r1\nACGTACGTACGA\n+\nJJJJJJJJJJJJ\n"  # valid duplicate: wins
        "@r3\nACG\n+\nIII\n"                    # too short for min_len
    )
    wq = load_fastq_with_quality(str(fq), min_len=4)
    assert set(wq) == {"r1"}  # N-record and too-short record filtered
    assert wq["r1"] == ("ACGTACGTACGA", "JJJJJJJJJJJJ")
    # sequence view agrees with the sequence-only loader
    assert {k: v[0] for k, v in wq.items()} == load_fastq_dict(str(fq), min_len=4)
