"""Sequence validation and 2-bit packing into fixed-shape device batches.

Validation mirrors the reference exactly: only the uppercase characters
A, T, C, G are valid (reference is_valid_sequence, src/data_io.cpp:17-34);
anything else — N, lowercase, IUPAC codes, whitespace — invalidates the
whole sequence and the record is dropped.

Packing maps bases to 2-bit codes A=0, C=1, G=2, T=3 (the order the hash
seed table uses) and pads reads into [B, L] uint8 arrays with a lengths
vector, the fixed-shape layout the device programs consume (SURVEY.md §7.2
step 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Lookup: ASCII byte -> base code, 255 = invalid.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _CODE_LUT[_b] = _c

BASES = "ACGT"


def is_valid_sequence(seq: str) -> bool:
    """True iff seq contains only uppercase A/T/C/G
    (reference src/data_io.cpp:17-34). Empty sequences are valid there too."""
    arr = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    return bool((_CODE_LUT[arr] != 255).all())


def encode_sequence(seq: str) -> Optional[np.ndarray]:
    """Encode to uint8 base codes; None if any character is invalid."""
    arr = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    codes = _CODE_LUT[arr]
    if (codes == 255).any():
        return None
    return codes


@dataclasses.dataclass
class PackedReads:
    """A fixed-shape batchable view of encoded reads.

    codes:   [N, L] uint8 base codes, zero-padded past each length.
    lengths: [N] int32 true lengths.
    ids:     read identifiers, aligned with rows (reference keeps the full
             FASTQ header minus '@', src/main.cpp:122).
    """

    codes: np.ndarray
    lengths: np.ndarray
    ids: List[str]

    @property
    def num_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def padded_len(self) -> int:
        return self.codes.shape[1]

    def bit_packed(self) -> "Packed2Reads":
        """2-bit repack (4 bases/byte) for transfer-efficient feeds."""
        n, L = self.codes.shape
        L4 = (L + 3) // 4
        c = self.codes
        if L4 * 4 != L:
            c = np.concatenate([c, np.zeros((n, L4 * 4 - L), np.uint8)], axis=1)
        q = c.reshape(n, L4, 4).astype(np.uint8)
        codes2 = (
            q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (q[:, :, 3] << 6)
        )
        return Packed2Reads(codes2, self.lengths, L)

    def batches(self, batch_size: int):
        """Yield (codes, lengths, row_offset) slices padded to batch_size."""
        n = self.num_reads
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            c = self.codes[start:stop]
            l = self.lengths[start:stop]
            if stop - start < batch_size:
                pad = batch_size - (stop - start)
                c = np.concatenate([c, np.zeros((pad, self.padded_len), np.uint8)])
                l = np.concatenate([l, np.zeros(pad, np.int32)])
            yield c, l, start


@dataclasses.dataclass
class Packed2Reads:
    """2-bit-packed reads: 4 base codes per byte (base j in byte j>>2,
    bits (j&3)*2).  Quarters the host->device bytes of the streaming
    feed; the device unpacks with two vector ops (unpack_codes2).

    codes2:  [N, ceil(L/4)] uint8 packed base codes, zero past lengths.
    lengths: [N] int32 true lengths.
    pad_len: the logical padded read length L the rows unpack to.
    """

    codes2: np.ndarray
    lengths: np.ndarray
    pad_len: int
    # Real (non-padding) rows when the block was padded host-side to a
    # batch multiple; None = every row is real.
    n_real: Optional[int] = None

    @property
    def num_reads(self) -> int:
        return self.n_real if self.n_real is not None else self.codes2.shape[0]

    @property
    def padded_len(self) -> int:
        return self.pad_len

    def unpacked(self) -> PackedReads:
        """Host-side unpack (small samples / tests)."""
        n, L4 = self.codes2.shape
        b = self.codes2[:, :, None]
        sh = np.arange(4, dtype=np.uint8) * 2
        codes = ((b >> sh) & 3).reshape(n, L4 * 4)[:, : self.pad_len]
        return PackedReads(np.ascontiguousarray(codes), self.lengths, [])


def unpack_codes2(codes2, L: int):
    """Device-side unpack: [..., ceil(L/4)] uint8 -> [..., L] base codes.

    Pure elementwise shifts/masks — XLA fuses this into the consuming
    hash computation, so packed transfer costs no extra device pass.
    """
    import jax.numpy as jnp

    b = codes2[..., :, None]
    sh = (jnp.arange(4, dtype=jnp.uint8) * 2).astype(jnp.uint8)
    out = (b >> sh) & jnp.uint8(3)
    return out.reshape(*codes2.shape[:-1], codes2.shape[-1] * 4)[..., :L]


def pack_reads(
    seqs: Sequence[str],
    ids: Sequence[str],
    min_len: int,
    pad_len: Optional[int] = None,
) -> Tuple[PackedReads, int, int]:
    """Validate, filter, and pack reads.

    Mirrors process_fastq_single_pass filtering (src/main.cpp:131-138):
    reads with non-ACGT characters or shorter than min_len (= max k) are
    dropped.  Reads longer than pad_len are also dropped (counted; the
    reference has no such limit — size pad_len to the data).

    Returns (packed, n_invalid, n_too_long).
    """
    kept_codes: List[np.ndarray] = []
    kept_ids: List[str] = []
    n_invalid = 0
    n_too_long = 0
    max_seen = 0
    for seq, rid in zip(seqs, ids):
        codes = encode_sequence(seq)
        if codes is None or codes.size < min_len:
            n_invalid += 1
            continue
        if pad_len is not None and codes.size > pad_len:
            n_too_long += 1
            continue
        max_seen = max(max_seen, codes.size)
        kept_codes.append(codes)
        kept_ids.append(rid)

    L = pad_len if pad_len is not None else max(max_seen, min_len)
    N = len(kept_codes)
    out = np.zeros((N, L), dtype=np.uint8)
    lengths = np.zeros(N, dtype=np.int32)
    for i, codes in enumerate(kept_codes):
        out[i, : codes.size] = codes
        lengths[i] = codes.size
    return PackedReads(out, lengths, kept_ids), n_invalid, n_too_long
