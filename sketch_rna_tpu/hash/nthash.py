"""ntHash2 forward rolling k-mer hash, re-derived for vector execution.

The reference calls the external ntHash 2.x C++ library with one hash
function and uses the *forward-strand* hash only, implicitly truncated to
its low 32 bits (reference: src/sketch.cpp:31-37, and the dead variant at
src/kmer.cpp:19-35).  This module reimplements the published ntHash2
algorithm (Kazemi et al., "ntHash2") from its definition:

  - per-base 64-bit seeds for A/C/G/T,
  - "split rotation" srol: the 64-bit word is treated as a 31-bit field
    (bits 33..63) and a 33-bit field (bits 0..32); each field is rotated
    left independently, giving the state a period of 31*33 = 1023 instead
    of 64 and removing rotational hash collisions,
  - forward hash of the k-mer at position i:
        fh(i) = XOR_{j=0..k-1} srol^(k-1-j)( seed[s[i+j]] )
    maintained by the rolling update
        fh(i+1) = srol(fh(i)) ^ srol^k(seed[s[i]]) ^ seed[s[i+k]].

Accelerator design (SURVEY.md §7.2 step 2): instead of translating the
sequential rolling recurrence, we exploit that the hash is a pure XOR of
per-offset *rotated seeds*.  For a fixed k we precompute on the host the
4*k constants  T[j][b] = srol^(k-1-j)(seed_b)  and evaluate every k-mer of
a read batch as a fully parallel windowed XOR — no scan, no sequential
dependency, embarrassingly data-parallel over (read, position) and
XLA-fusable into one elementwise pass.  Because XOR has no cross-bit
interaction and the pipeline only ever consumes the low 32 bits of the
hash (the reference's uint32 truncation), the device computation operates
purely on uint32 words: half the work of a 64-bit emulation.

Two independent scalar implementations (rolling vs. direct windowed) are
kept here and cross-checked in tests/test_nthash.py together with frozen
golden vectors.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

# Published ntHash per-base seeds (ntHash kmer.hpp: seed_a..seed_t).
# Base code order matches our 2-bit packing: A=0, C=1, G=2, T=3.
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
NTHASH_SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T)

_MASK33 = (1 << 33) - 1
_MASK31 = (1 << 31) - 1
SROL_PERIOD = 31 * 33  # 1023


def srol(x: int, d: int = 1) -> int:
    """ntHash2 split-rotate-left by d: independent rotations of the
    33-bit low field (bits 0..32) and the 31-bit high field (bits 33..63)."""
    d33 = d % 33
    d31 = d % 31
    lo = x & _MASK33
    hi = (x >> 33) & _MASK31
    if d33:
        lo = ((lo << d33) | (lo >> (33 - d33))) & _MASK33
    if d31:
        hi = ((hi << d31) | (hi >> (31 - d31))) & _MASK31
    return (hi << 33) | lo


def nthash_forward_scalar(codes: Sequence[int], k: int) -> List[int]:
    """Forward hashes of all k-mers via the published *rolling* recurrence.

    Mirrors nthash::NtHash{seq,1,k}.roll()/get_forward_hash() as used at
    reference src/sketch.cpp:31-36, returning full 64-bit values.
    """
    n = len(codes)
    if n < k:
        return []
    h = 0
    for j in range(k):
        h = srol(h, 1) ^ NTHASH_SEEDS[codes[j]]
    out = [h]
    for i in range(1, n - k + 1):
        h = srol(h, 1) ^ srol(NTHASH_SEEDS[codes[i - 1]], k) ^ NTHASH_SEEDS[codes[i + k - 1]]
        out.append(h)
    return out


def nthash_forward_scalar_direct(codes: Sequence[int], k: int) -> List[int]:
    """Forward hashes via the direct (non-rolling) windowed-XOR definition.

    Independent of nthash_forward_scalar; the two are cross-checked in
    tests to guard the algebra used by the vectorized path.
    """
    n = len(codes)
    out = []
    for i in range(n - k + 1):
        h = 0
        for j in range(k):
            h ^= srol(NTHASH_SEEDS[codes[i + j]], k - 1 - j)
        out.append(h)
    return out


@functools.lru_cache(maxsize=None)
def window_tables_u32(k: int) -> np.ndarray:
    """Host-precomputed low-32-bit rotated-seed table, shape [k, 4] uint32.

    tables[j, b] = low 32 bits of srol^(k-1-j)(seed_b).  Since the hash is
    a pure XOR of these constants and downstream consumes only the low 32
    bits (the reference's uint32 truncation at src/sketch.cpp:33), the
    device never needs the high word.
    """
    t = np.empty((k, 4), dtype=np.uint32)
    for j in range(k):
        for b in range(4):
            t[j, b] = srol(NTHASH_SEEDS[b], k - 1 - j) & 0xFFFFFFFF
    return t


def nthash_batch_u32(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Vectorized forward ntHash (low 32 bits) for a padded batch.

    Args:
      codes: [B, L] integer base codes in {0,1,2,3}; padding may hold any
        value in range (callers mask by length).
      k: k-mer length (static).

    Returns:
      [B, L-k+1] uint32 forward hashes; entry [b, i] hashes the k-mer at
      position i.  Garbage where the window overruns the true read length —
      callers apply the validity mask.

    The 4-way seed lookup is done with bit-selects (codes are 2-bit), which
    XLA fuses into one elementwise pass; there is no gather and no scan.
    """
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {codes.shape}")
    B, L = codes.shape
    nk = L - k + 1
    if nk < 1:
        raise ValueError(f"padded length {L} < k={k}")
    tables = window_tables_u32(k)
    codes = codes.astype(jnp.uint32)
    h = jnp.zeros((B, nk), dtype=jnp.uint32)
    for j in range(k):
        c = codes[:, j : j + nk]
        b0 = (c & jnp.uint32(1)).astype(jnp.bool_)
        b1 = (c >> jnp.uint32(1)).astype(jnp.bool_)
        tj = tables[j]
        lo_pair = jnp.where(b0, jnp.uint32(tj[1]), jnp.uint32(tj[0]))
        hi_pair = jnp.where(b0, jnp.uint32(tj[3]), jnp.uint32(tj[2]))
        h = h ^ jnp.where(b1, hi_pair, lo_pair)
    return h
