"""ntHash2 correctness: algebraic properties, cross-implementation
agreement, vectorized-vs-scalar equality, and frozen golden vectors
(SURVEY.md §4 "ntHash forward-hash vectors... golden 64-bit values and
their 32-bit truncations")."""

import os

import numpy as np
import pytest

from sketch_rna_tpu.hash.nthash import (
    NTHASH_SEEDS,
    SROL_PERIOD,
    nthash_batch_u32,
    nthash_forward_scalar,
    nthash_forward_scalar_direct,
    srol,
    window_tables_u32,
)

BASES = "ACGT"


def codes_of(s):
    return [BASES.index(c) for c in s]


def random_codes(rng, n):
    return list(rng.integers(0, 4, size=n))


# ---------------------------------------------------------------- srol ---


def test_srol_identity_and_period():
    x = 0xDEADBEEFCAFEF00D
    assert srol(x, 0) == x
    assert srol(x, SROL_PERIOD) == x
    assert srol(srol(x, 5), 7) == srol(x, 12)


def test_srol_is_permutation_of_bits():
    # srol by 1 must preserve popcount and be invertible via d=period-1.
    x = 0x123456789ABCDEF0
    y = srol(x, 1)
    assert bin(x).count("1") == bin(y).count("1")
    assert srol(y, SROL_PERIOD - 1) == x


def test_srol_field_split():
    # Bit 32 (top of the low 33-bit field) wraps to bit 0, not bit 33.
    assert srol(1 << 32, 1) == 1
    # Bit 63 (top of the high 31-bit field) wraps to bit 33.
    assert srol(1 << 63, 1) == 1 << 33
    # Bits below the field tops shift left normally.
    assert srol(1 << 10, 1) == 1 << 11
    assert srol(1 << 40, 1) == 1 << 41


# ------------------------------------------------- scalar implementations ---


@pytest.mark.parametrize("k", [3, 5, 21, 31, 63])
def test_rolling_matches_direct(rng, k):
    codes = random_codes(rng, 200)
    a = nthash_forward_scalar(codes, k)
    b = nthash_forward_scalar_direct(codes, k)
    assert a == b
    assert len(a) == 200 - k + 1


def test_first_kmer_is_windowed_xor_of_seeds():
    # By definition: fh = XOR_j srol^(k-1-j)(seed_j).
    codes = codes_of("ACGTA")
    k = 5
    expected = 0
    for j in range(k):
        expected ^= srol(NTHASH_SEEDS[codes[j]], k - 1 - j)
    assert nthash_forward_scalar(codes, k)[0] == expected


def test_single_base_kmer_is_seed():
    for b in range(4):
        assert nthash_forward_scalar([b], 1) == [NTHASH_SEEDS[b]]


def test_hash_depends_on_position():
    # srol-based mixing: "AA" at k=1 gives same hash twice, but a k=2
    # window distinguishes AC from CA.
    ac = nthash_forward_scalar(codes_of("AC"), 2)[0]
    ca = nthash_forward_scalar(codes_of("CA"), 2)[0]
    assert ac != ca


# ------------------------------------------------------- golden vectors ---

# Frozen outputs of the scalar implementation, cross-validated against
# the REAL ntHash2 library embedded in the reference's checked-in binary
# (/root/reference/build/test, Mach-O with libnthash statically linked):
# all 4 per-base seeds, the full 256-entry ASCII seedTab assignment
# (incl. lowercase), and every msTab33r/msTab31l split-rotation table
# entry (33+31 rotations x 4 bases = 256 constants) were located
# verbatim in the binary's data section (seedTab at offset 0x39f00),
# with perturbed-seed negative controls absent.
# test_srol_tables_match_reference_binary below re-runs that scan
# whenever the binary is present; these vectors freeze the result for
# environments without it.  Note ACGTACGT at k=4: positions 0 and 4
# hold the same 4-mer and must hash identically.
GOLDEN_FROZEN = {
    ("A", 1): [0x3C8BFBB395C60474],
    ("ACGTACGT", 4): [
        0x4B21EFD76BFC8C8A,
        0x62779F381E5F5A2D,
        0xEC40E7B3741C2BDD,
        0xFB901CB24F1D46DB,
        0x4B21EFD76BFC8C8A,
    ],
    ("T" * 31, 31): [0xFFFFFFFE08F64CC1],
}


def test_golden_vectors():
    for (seq, k), expected in GOLDEN_FROZEN.items():
        got = nthash_forward_scalar(codes_of(seq), k)
        assert got == expected, (seq, k, [hex(g) for g in got])


def test_homopolymer_hashes_equal():
    # Every window of a homopolymer is the same k-mer -> same hash.
    got = nthash_forward_scalar(codes_of("T" * 40), 31)
    assert len(set(got)) == 1


# --------------------------------------------------------- batch (jnp) ---


@pytest.mark.parametrize("k", [5, 21, 31])
def test_batch_matches_scalar_low32(rng, k):
    B, L = 7, 120
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    out = np.asarray(nthash_batch_u32(codes, k))
    assert out.shape == (B, L - k + 1)
    assert out.dtype == np.uint32
    for b in range(B):
        ref = nthash_forward_scalar(list(codes[b]), k)
        ref32 = np.array([h & 0xFFFFFFFF for h in ref], dtype=np.uint32)
        np.testing.assert_array_equal(out[b], ref32)


def test_window_tables_content():
    t = window_tables_u32(31)
    assert t.shape == (31, 4)
    # Last window offset applies no rotation: the raw seed low words.
    for b in range(4):
        assert int(t[30, b]) == NTHASH_SEEDS[b] & 0xFFFFFFFF
        assert int(t[0, b]) == srol(NTHASH_SEEDS[b], 30) & 0xFFFFFFFF


# ------------------------------------------------ native C++ witness ---


def test_cpp_witness_matches_python(rng, tmp_path):
    """Third independent derivation: native/nthash_witness.cpp expresses
    srol in the canonical bit-twiddle form and maintains hashes ONLY via
    the rolling recurrence (no windowed-XOR shortcut).  Bit-equality with
    the Python scalar forms across random sequences and k values guards
    the recurrence composition, complementing the binary table scan
    below (which guards the constants)."""
    import subprocess

    src = os.path.join(os.path.dirname(__file__), "..", "native", "nthash_witness.cpp")
    exe = str(tmp_path / "nthash_witness")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-o", exe, src], check=True, capture_output=True
    )
    cases = [("A", 1), ("ACGTACGT", 4), ("T" * 31, 31)]
    for _ in range(25):
        k = int(rng.choice([2, 3, 5, 15, 21, 31, 63]))
        n = int(rng.integers(k, k + 120))
        seq = "".join(BASES[c] for c in random_codes(rng, n))
        cases.append((seq, k))
    stdin = "".join(f"{k} {seq}\n" for seq, k in cases)
    out = subprocess.run(
        [exe], input=stdin, capture_output=True, text=True, check=True
    ).stdout.splitlines()
    assert len(out) == len(cases)
    for line, (seq, k) in zip(out, cases):
        got = [int(tok, 16) for tok in line.split()]
        assert got == nthash_forward_scalar(codes_of(seq), k), (seq, k)
        if (seq, k) in GOLDEN_FROZEN:
            assert got == GOLDEN_FROZEN[(seq, k)]


# ---------------------------------------- real-library cross-validation ---

_REF_BINARY = "/root/reference/build/test"


@pytest.mark.skipif(
    not os.path.exists(_REF_BINARY), reason="reference binary not present"
)
def test_srol_tables_match_reference_binary():
    """Bit-level cross-check against the ACTUAL ntHash2 library.

    The reference's checked-in executable statically links libnthash
    (SURVEY.md §2 C15), whose data section embeds the precomputed
    rotation tables: seedTab[256] (ASCII -> 64-bit seed) and the
    msTab33r/msTab31l split-rotation tables the rolling hash is built
    from.  This test recomputes every one of those constants from OUR
    seeds + srol and requires each to appear verbatim in the binary —
    so a wrong seed, a wrong base assignment, or any deviation in the
    33/31 split-rotation fails here against the real library, not
    against a reimplementation trusting itself.
    """
    import struct

    blob = open(_REF_BINARY, "rb").read()
    m33 = (1 << 33) - 1
    m31 = (1 << 31) - 1

    def rot33(x, d):
        d %= 33
        return ((x << d) | (x >> (33 - d))) & m33 if d else x

    def rot31(x, d):
        d %= 31
        return ((x << d) | (x >> (31 - d))) & m31 if d else x

    # 1. The full ASCII seed table with our base assignment, upper+lower.
    seed_by_base = dict(zip("ACGT", NTHASH_SEEDS))
    pat_a = struct.pack("<Q", seed_by_base["A"])
    table_base = None
    start = 0
    while True:
        i = blob.find(pat_a, start)
        if i < 0:
            break
        base = i - 8 * ord("A")
        if base >= 0 and all(
            blob[base + 8 * ord(c) : base + 8 * ord(c) + 8] == struct.pack("<Q", s)
            and blob[base + 8 * ord(c.lower()) : base + 8 * ord(c.lower()) + 8]
            == struct.pack("<Q", s)
            for c, s in seed_by_base.items()
        ):
            table_base = base
            break
        start = i + 1
    assert table_base is not None, "seedTab[ACGT/acgt] not found in libnthash data"

    # 2. Every split-rotation constant (msTab33r / msTab31l layouts).
    for seed in NTHASH_SEEDS:
        lo, hi = seed & m33, (seed >> 33) & m31
        for r in range(33):
            assert blob.find(struct.pack("<Q", rot33(lo, r))) >= 0, (hex(seed), r)
        for r in range(31):
            assert blob.find(struct.pack("<Q", rot31(hi, r) << 33)) >= 0, (hex(seed), r)

    # 3. Negative control: single-bit-perturbed seeds must be absent.
    for seed in NTHASH_SEEDS:
        assert blob.find(struct.pack("<Q", seed ^ 1)) < 0

    # 4. srol consistency: full srol == msTab31l | msTab33r composition.
    for seed in NTHASH_SEEDS:
        lo, hi = seed & m33, (seed >> 33) & m31
        for d in range(64):
            assert srol(seed, d) == (rot31(hi, d) << 33) | rot33(lo, d)
