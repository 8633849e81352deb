"""Bucketed hash lookup: the index probe as ONE contiguous row gather.

The sorted-array binary search (jnp.searchsorted) costs log2(U) dependent
random gathers per probe.  Because
FracMinHash-kept hashes are uniform in [0, threshold], a direct-address
bucket table with power-of-two bucket count has O(1) expected occupancy:

  host build:  bucket(key) = key >> shift; per-bucket entries padded to
               the max occupancy mb and packed as one int32 row
               [key_bits(mb) | start(mb) | len(mb)]  ->  [nb, 3*mb]
  device probe: one gather of [B, S] contiguous 3*mb-wide rows, then an
               in-register compare + masked sum.  No loops, no
               dependent gathers.

Sentinel key slots hold 0xFFFFFFFF (bitcast -1); every real kept hash is
<= threshold < 2^31 so the int32 compare cannot alias.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class BucketTable(NamedTuple):
    packed: np.ndarray  # [nb, 3*mb] int32
    shift: int  # bucket = hash >> shift
    mb: int  # max bucket occupancy (padded width)


def build_bucket_table(
    keys: np.ndarray, row_ptr: np.ndarray, target_load: int = 2,
    max_row_lanes: int = 128,
) -> BucketTable:
    """Host-side construction from a k's sorted CSR key arrays.

    Bucket-count choice: coarser tables mean fewer, wider row fetches;
    on the accelerator the design was first tuned on, probe time fell as
    the table coarsened until the packed row outgrew 128 lanes.  So:
    start fine (target_load) and merge bucket pairs while the resulting
    3*mb row still fits max_row_lanes.  (Not yet re-tuned on the GPU.)
    Merging halves nb and recomputes the exact max occupancy from the
    pairwise-summed histogram — no re-bucketing pass."""
    U = int(keys.shape[0])
    nb, mb, shift = bucket_table_shape(keys, target_load, max_row_lanes)
    b = (keys.astype(np.uint64) >> shift).astype(np.int64)
    counts = np.bincount(b, minlength=nb) if U else np.zeros(nb, np.int64)
    packed = np.zeros((nb, 3 * mb), dtype=np.int32)
    packed[:, :mb] = -1  # sentinel key bits
    if U:
        # keys are sorted, so buckets are contiguous runs; each key's
        # within-bucket slot is its index minus its bucket's start.
        # Fully vectorized — a per-bucket Python loop costs seconds at
        # GENCODE scale on weak hosts.
        starts = np.zeros(nb, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        within = np.arange(U, dtype=np.int64) - starts[b]
        lens = (row_ptr[1:] - row_ptr[:-1]).astype(np.int32)
        packed[b, within] = keys.view(np.int32)
        packed[b, mb + within] = row_ptr[:-1]
        packed[b, 2 * mb + within] = lens
    return BucketTable(packed=packed, shift=shift, mb=mb)


def bucket_table_shape(
    keys: np.ndarray, target_load: int = 2, max_row_lanes: int = 128
) -> Tuple[int, int, int]:
    """(nb, mb, shift) that build_bucket_table would choose — the same
    histogram + merge logic without constructing the packed table.  Used
    to estimate the device footprint of a replicated index (mesh-width
    auto-selection) before any device allocation."""
    U = int(keys.shape[0])
    nb = 1 << max(10, min(22, (max(U // target_load, 1)).bit_length()))
    max_key = int(keys.max()) if U else 0
    shift = 0
    while (max_key >> shift) >= nb:
        shift += 1
    b = (keys.astype(np.uint64) >> shift).astype(np.int64)
    counts = np.bincount(b, minlength=nb) if U else np.zeros(nb, np.int64)
    while nb > 1024:
        merged = counts.reshape(-1, 2).sum(axis=1)
        if 3 * max(int(merged.max()) if U else 0, 1) > max_row_lanes:
            break
        counts = merged
        nb >>= 1
        shift += 1
    mb = max(int(counts.max()) if U else 0, 1)
    return nb, mb, shift


@partial(jax.jit, static_argnames=("nb", "mb", "shift"))
def build_bucket_table_device(
    keys: jnp.ndarray,  # [U] uint32 sorted
    row_ptr: jnp.ndarray,  # [U+1] int32
    *,
    nb: int,
    mb: int,
    shift: int,
) -> jnp.ndarray:
    """Device-side construction of the packed [nb, 3*mb] probe table.

    Numerically identical to build_bucket_table (tests pin equality) but
    ships only the CSR arrays over the host->device link — ~2.6x fewer
    bytes than the packed table at GENCODE scale (122 MB vs 316 MB).
    The build
    itself is three unique-index scatters over U lanes (keys are sorted,
    so each bucket is a contiguous run and every (bucket, slot) target
    is distinct).
    """
    U = keys.shape[0]
    b = (keys >> jnp.uint32(shift)).astype(jnp.int32)  # [U] ascending
    counts = jnp.zeros(nb, jnp.int32).at[b].add(1)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    within = jnp.arange(U, dtype=jnp.int32) - starts[b]
    flat = jnp.full(nb * 3 * mb, 0, jnp.int32)
    # sentinel key bits in every key slot
    key_slots = (jnp.arange(nb * 3 * mb, dtype=jnp.int32) % (3 * mb)) < mb
    flat = jnp.where(key_slots, jnp.int32(-1), flat)
    base = b * (3 * mb) + within
    lens = (row_ptr[1:] - row_ptr[:-1]).astype(jnp.int32)
    flat = flat.at[base].set(jax.lax.bitcast_convert_type(keys, jnp.int32))
    flat = flat.at[base + mb].set(row_ptr[:-1].astype(jnp.int32))
    flat = flat.at[base + 2 * mb].set(lens)
    return flat.reshape(nb, 3 * mb)


def bucket_lookup(
    hashes: jnp.ndarray,
    mask: jnp.ndarray,
    packed: jnp.ndarray,
    *,
    shift: int,
    mb: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Probe: [B, S] hashes -> (start, length) posting runs, one gather."""
    nb = packed.shape[0]
    b = (hashes >> jnp.uint32(shift)).astype(jnp.int32)
    b = jnp.minimum(b, nb - 1)
    rows = packed[b]  # [B, S, 3*mb] contiguous row gather
    h_i = jax.lax.bitcast_convert_type(hashes, jnp.int32)[..., None]
    eq = (rows[..., :mb] == h_i) & mask[..., None]
    start = jnp.sum(jnp.where(eq, rows[..., mb : 2 * mb], 0), axis=-1)
    length = jnp.sum(jnp.where(eq, rows[..., 2 * mb : 3 * mb], 0), axis=-1)
    return start, length
