"""Native (C++) parser vs Python reference parsers: identical results on
normal data and edge cases; throughput sanity."""

import numpy as np
import pytest

from sketch_rna_tpu.io.fasta import load_fasta
from sketch_rna_tpu.io.fastq import load_fastq_dict
from sketch_rna_tpu.io.packing import pack_reads
from sketch_rna_tpu.io import native

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native fastio not built"
)


def write(p, text):
    p.write_text(text)
    return str(p)


def test_fastq_native_matches_python(tmp_path):
    path = write(
        tmp_path / "r.fq",
        "junk\n"
        "@r1 with description\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
        "@r2\nACGTNACGTACG\n+\nIIIIIIIIIIII\n"  # invalid
        "@r3\nACG\n+\nIII\n"  # too short
        "@r1 with description\nTTTTACGTACGT\n+\nIIIIIIIIIIII\n"  # dup: last wins
        "@r4\nGGGGCCCCAAAA\n+\nIIIIIIIIIIII\n",
    )
    packed, stats = native.pack_fastq_native(path, min_len=8, pad_len=16, with_ids=True)

    d = load_fastq_dict(path)
    keep = {k: v for k, v in d.items() if len(v) >= 8 and set(v) <= set("ACGT")}
    py_packed, _, _ = pack_reads(list(keep.values()), list(keep.keys()), min_len=8, pad_len=16)

    assert packed.ids == py_packed.ids
    np.testing.assert_array_equal(packed.lengths, py_packed.lengths)
    np.testing.assert_array_equal(packed.codes, py_packed.codes)
    assert stats["n_seen"] == 5
    assert stats["n_invalid"] == 2


def test_fasta_native_matches_python(tmp_path):
    path = write(
        tmp_path / "t.fa",
        ">tx1 desc\nACGTACGT\nACGT\n\n>tx2\nGGGG\n>bad\nACGTN\n>tx1 dup\nTTTT\n",
    )
    a = native.load_fasta_native(path)
    b = load_fasta(path)
    assert a.names == b.names
    assert a.seqs == b.seqs
    assert a.n_invalid == b.n_invalid


def test_fastq_native_random_large(tmp_path, rng):
    n = 5000
    lines = []
    for i in range(n):
        ln = int(rng.integers(40, 200))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
        lines.append(f"@read{i}\n{seq}\n+\n{'I' * ln}\n")
    path = write(tmp_path / "big.fq", "".join(lines))
    packed, stats = native.pack_fastq_native(path, min_len=31, with_ids=True)

    d = load_fastq_dict(path)
    keep = {k: v for k, v in d.items() if len(v) >= 31}
    py_packed, _, _ = pack_reads(
        list(keep.values()), list(keep.keys()), min_len=31, pad_len=packed.padded_len
    )
    assert packed.ids == py_packed.ids
    np.testing.assert_array_equal(packed.codes, py_packed.codes)
    np.testing.assert_array_equal(packed.lengths, py_packed.lengths)


def test_fastq_native_missing_file():
    with pytest.raises(FileNotFoundError):
        native.pack_fastq_native("/nonexistent/x.fq", min_len=31)
    with pytest.raises(FileNotFoundError):
        native.NativeFastqScan("/nonexistent/x.fq", 31)


def test_fastq_chunked_iter_matches_whole_pack(tmp_path, rng):
    """The double-buffered chunk feed (chunks_from_scan) must concatenate
    to exactly the whole-file pack — same rows, same order, same padding
    — including when duplicates/invalid records sit near chunk splits
    (dedup is global, done at scan time, so splits can't affect it)."""
    n = 1000
    lines = []
    for i in range(n):
        ln = int(rng.integers(40, 120))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
        lines.append(f"@read{i}\n{seq}\n+\n{'I' * ln}\n")
    # A duplicate of an early read (last wins) + an invalid record.
    lines.append("@read3\n" + "ACGT" * 20 + "\n+\n" + "I" * 80 + "\n")
    lines.append("@bad\nACGTN\n+\nIIIII\n")
    path = write(tmp_path / "c.fq", "".join(lines))

    whole, stats = native.pack_fastq_native(path, min_len=31)
    for chunk_reads in (64, 999, 4096):
        got = list(
            native.iter_fastq_chunks_native(
                path, 31, chunk_reads, pad_len=whole.padded_len
            )
        )
        assert sum(c.num_reads for c in got) == whole.num_reads
        np.testing.assert_array_equal(
            np.concatenate([c.codes for c in got]), whole.codes
        )
        np.testing.assert_array_equal(
            np.concatenate([c.lengths for c in got]), whole.lengths
        )


@pytest.mark.parametrize("threads", [1, 3, 4, 7])
def test_fastq_parallel_scan_matches_sequential(tmp_path, rng, threads):
    """The byte-range parallel scan must reproduce the sequential scan
    exactly: same records, same order, same dedup resolution (first
    position / last content), with duplicates far apart so they land in
    different threads' ranges."""
    n = 4000
    lines = []
    for i in range(n):
        ln = int(rng.integers(40, 120))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
        lines.append(f"@read{i} extra\n{seq}\n+\n{'I' * ln}\n")
    # Duplicates of EARLY ids appended at the END (cross-thread), one
    # valid (content must win) and one invalid (must not clobber).
    lines.append("@read7 extra\n" + "ACGT" * 25 + "\n+\n" + "I" * 100 + "\n")
    lines.append("@read11 extra\nACGTN\n+\nIIIII\n")
    # Quality line starting '@' (alignment must not misframe it).
    lines.append("@qtrap\n" + "ACGT" * 20 + "\n+\n@" + "I" * 79 + "\n")
    path = write(tmp_path / "mt.fq", "".join(lines))

    def snap(threads):
        with native.NativeFastqScan(path, 31, scan_threads=threads) as s:
            p = s.pack_range(0, s.num_reads, 128)
            return s.num_reads, s.stats, p

    n_seq, stats_seq, p_seq = snap(1)
    n_mt, stats_mt, p_mt = snap(threads)
    assert n_mt == n_seq
    assert stats_mt == stats_seq
    np.testing.assert_array_equal(p_mt.codes, p_seq.codes)
    np.testing.assert_array_equal(p_mt.lengths, p_seq.lengths)
    # And sequential must itself match the Python reference parser.
    d = load_fastq_dict(path, min_len=31)
    assert n_seq == len(d)


def test_fastq_scan_pack_range(tmp_path, rng):
    n = 257
    lines = []
    for i in range(n):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=60))
        lines.append(f"@r{i}\n{seq}\n+\n{'I' * 60}\n")
    path = write(tmp_path / "pr.fq", "".join(lines))
    whole, _ = native.pack_fastq_native(path, min_len=31)
    with native.NativeFastqScan(path, 31) as scan:
        assert scan.num_reads == n
        mid = scan.pack_range(100, 57, whole.padded_len)
        np.testing.assert_array_equal(mid.codes, whole.codes[100:157])
        np.testing.assert_array_equal(mid.lengths, whole.lengths[100:157])
        empty = scan.pack_range(0, 0, whole.padded_len)
        assert empty.num_reads == 0


def test_fastq_native_gzip_matches_python(tmp_path):
    """The native parser inflates .fq.gz itself (zlib, incl. multi-member
    streams) — no Python line-loop fallback."""
    import gzip

    from sketch_rna_tpu.io import native

    if not native.native_available():
        pytest.skip("native lib not built")
    content = (
        "@r1\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n"
        "@r2 extra\nTTTTGGGGCCCCAAAA\n+\nIIIIIIIIIIIIIIII\n"
        "@bad\nACGTNNACGTACGTAC\n+\nIIIIIIIIIIIIIIII\n"
        "@r1\nGGGGGGGGCCCCCCCC\n+\nIIIIIIIIIIIIIIII\n"  # dup: last wins
    )
    plain = tmp_path / "r.fq"
    plain.write_text(content)
    gz = tmp_path / "r.fq.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(content)
    # Multi-member gzip (bgzip-style concatenation).
    multi = tmp_path / "m.fq.gz"
    half1, half2 = content[: len(content) // 2], content[len(content) // 2 :]
    with open(multi, "wb") as fh:
        fh.write(gzip.compress(half1.encode()))
        fh.write(gzip.compress(half2.encode()))

    ref, _ = native.pack_fastq_native(str(plain), min_len=8)
    for path in (gz, multi):
        got, stats = native.pack_fastq_native(str(path), min_len=8)
        np.testing.assert_array_equal(got.codes, ref.codes)
        np.testing.assert_array_equal(got.lengths, ref.lengths)
        assert got.ids == ref.ids
