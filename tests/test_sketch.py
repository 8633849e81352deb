"""FracMinHash sketching: batch implementation vs scalar set oracle."""

import numpy as np
import pytest

from sketch_rna_tpu.sketch.fracminhash import (
    fracminhash_threshold,
    sketch_batch,
    sketch_scalar,
)


def test_threshold_truncating_cast():
    # The reference passes `float sketch_size = 0.05f` into a double
    # parameter (src/main.cpp:43 -> src/sketch.cpp:25-26), so the
    # threshold is uint32(4294967295 * double(0.05f)) == 214748367 —
    # NOT int(4294967295 * 0.05) == 214748364.
    assert fracminhash_threshold(0.05) == 214748367
    assert fracminhash_threshold(0.05) == int(
        np.float64(4294967295) * np.float64(np.float32(0.05))
    )
    assert fracminhash_threshold(0.0) == 0
    with pytest.raises(ValueError):
        fracminhash_threshold(1.0)


@pytest.mark.parametrize("k,fraction", [(31, 0.05), (21, 0.05), (31, 0.3)])
def test_batch_matches_scalar_sets(rng, k, fraction):
    B, L = 16, 150
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    cap = 64
    hs, mask, overflow = sketch_batch(codes, lengths, k, fraction, cap)
    hs = np.asarray(hs)
    mask = np.asarray(mask)
    assert int(overflow) == 0
    for b in range(B):
        expected = sketch_scalar(codes[b, : lengths[b]], k, fraction)
        got = set(hs[b][mask[b]].tolist())
        assert got == expected
        # Ascending and sentinel-padded.
        row = hs[b][mask[b]]
        assert (np.diff(row.astype(np.int64)) > 0).all()


def test_capacity_overflow_counted(rng):
    # fraction 0.9 on long reads forces far more than capacity=8 hashes.
    B, L, k = 4, 200, 21
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    hs, mask, overflow = sketch_batch(codes, lengths, k, 0.9, 8)
    hs, mask = np.asarray(hs), np.asarray(mask)
    assert int(overflow) > 0
    # Kept hashes are the smallest distinct ones.
    for b in range(B):
        expected = sorted(sketch_scalar(codes[b], k, 0.9))[:8]
        assert hs[b][mask[b]].tolist() == expected


def test_short_read_no_kmers():
    # Length < k yields an empty sketch via the position mask.
    codes = np.zeros((2, 64), np.uint8)
    lengths = np.array([10, 64], np.int32)
    hs, mask, _ = sketch_batch(codes, lengths, 31, 0.5, 16)
    assert not np.asarray(mask)[0].any()


def _oracle_rows(codes, lengths, k, fraction):
    return [sorted(sketch_scalar(codes[b, : lengths[b]], k, fraction)) for b in range(len(codes))]


@pytest.mark.parametrize("k", [21, 31])
def test_batch_matches_oracle_at_read_width(rng, k):
    """150 bp reads in the pipeline's 256-wide pad, with the auto-sized
    capacity: every row is the oracle's sorted set."""
    from sketch_rna_tpu.config import QuantConfig

    B, L, pad = 32, 150, 256
    codes = np.zeros((B, pad), np.uint8)
    codes[:, :L] = rng.integers(0, 4, size=(B, L))
    lengths = np.full(B, L, np.int32)
    lengths[: B // 2] = rng.integers(k, L + 1, size=B // 2)
    cap = QuantConfig().sketch_capacity_for(k)
    hs, mask, overflow = sketch_batch(codes, lengths, k, 0.05, cap)
    hs, mask = np.asarray(hs), np.asarray(mask)
    assert int(overflow) == 0
    for b, want in enumerate(_oracle_rows(codes, lengths, k, 0.05)):
        assert hs[b][mask[b]].tolist() == want


@pytest.mark.parametrize("ks", [(21, 31), (15, 25, 33)])
def test_multik_batch_matches_oracle(rng, ks):
    """Each k of one batch sketched independently equals the oracle."""
    B, L = 16, 150
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(max(ks), L + 1, size=B).astype(np.int32)
    for k in ks:
        hs, mask, overflow = sketch_batch(codes, lengths, k, 0.05, 24)
        hs, mask = np.asarray(hs), np.asarray(mask)
        assert int(overflow) == 0
        for b, want in enumerate(_oracle_rows(codes, lengths, k, 0.05)):
            assert hs[b][mask[b]].tolist() == want


def test_overflow_count_is_exact(rng):
    """Past capacity the row keeps the smallest distinct hashes and the
    overflow counts exactly the distinct hashes dropped."""
    k, B, L, cap = 15, 16, 150, 8
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    hs, mask, overflow = sketch_batch(codes, lengths, k, 0.5, cap)
    hs, mask = np.asarray(hs), np.asarray(mask)
    want = _oracle_rows(codes, lengths, k, 0.5)
    assert int(overflow) == sum(max(len(w) - cap, 0) for w in want) > 0
    for b in range(B):
        assert hs[b][mask[b]].tolist() == want[b][:cap]


@pytest.mark.parametrize("k", [15, 31])
def test_repeated_kmers_collapse(rng, k):
    """Repeated blocks and homopolymer runs give one entry per distinct
    hash, as the oracle's set does."""
    block = rng.integers(0, 4, size=40).astype(np.uint8)
    row = np.concatenate([block, block, block, np.zeros(30, np.uint8)])
    codes = np.tile(row, (4, 1))
    lengths = np.full(4, row.size, np.int32)
    hs, mask, overflow = sketch_batch(codes, lengths, k, 0.3, 32)
    hs, mask = np.asarray(hs), np.asarray(mask)
    assert int(overflow) == 0
    for b, want in enumerate(_oracle_rows(codes, lengths, k, 0.3)):
        assert hs[b][mask[b]].tolist() == want
