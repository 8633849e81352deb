"""FracMinHash sketching: threshold filter + set-dedup, vectorised.

Reference semantics (createSketch_FracMinhash_direct, src/sketch.cpp:24-39):
  threshold = (uint32_t)(UINT32_MAX * fraction)      [C cast truncates]
  keep a k-mer iff its (low-32-bit) forward ntHash <= threshold
  the sketch is a SET: duplicates collapse, multiplicity is discarded.

Accelerator shape (SURVEY.md §7.4 "Set semantics"): per read we produce a
fixed-capacity, ascending-sorted row of distinct kept hashes with a
validity mask.  Dedup is sort-based: masked-out and duplicate entries are
replaced by the sentinel 0xFFFFFFFF and compacted with a second sort.
The sentinel cannot collide with a kept hash for any fraction < 1.

Capacity overflow (more distinct kept hashes than the row holds) keeps
the numerically smallest hashes and is reported via a per-batch count —
never silent (SURVEY.md §7.4 "overflow policies must be explicit").
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from sketch_rna_tpu.hash.nthash import nthash_batch_u32

# np scalar, not a jnp array: module import must not initialize the
# XLA backend (jax.distributed.initialize comes first in multi-host
# CLIs and refuses to run once any device value exists).
_SENTINEL = np.uint32(0xFFFFFFFF)


def fracminhash_threshold(fraction: float) -> int:
    """uint32 keep-threshold with the reference's C-cast truncation
    (src/sketch.cpp:25-26): static_cast<uint32_t>(UINT32_MAX * fraction).

    The reference stores the fraction in a `float` (global sketch_size =
    0.05f, src/main.cpp:43) that widens to the `double` parameter, so
    the product uses double(float(fraction)) — e.g. 0.05 yields
    214748367, not 214748364.  Promote through float32 to match the
    binary bit-for-bit."""
    if not (0.0 <= fraction < 1.0):
        raise ValueError("fraction must be in [0, 1) — 1.0 would collide with the pad sentinel")
    f = np.float64(np.float32(fraction))  # float -> double, like the C++ call
    return int(float(np.float64(0xFFFFFFFF) * f))  # truncates


def sketch_batch(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    fraction: float,
    capacity: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sketch a padded read batch for one k.

    Args:
      codes:   [B, L] uint8 base codes (zero-padded).
      lengths: [B] int32 true read lengths.
      k, fraction: algorithm parameters (static).
      capacity: fixed sketch row width (static).

    Returns:
      hashes:  [B, capacity] uint32, ascending, sentinel-padded.
      mask:    [B, capacity] bool validity.
      n_overflow: [] int32 — total distinct kept hashes dropped for
        exceeding capacity across the batch (0 in healthy configs).
    """
    B, L = codes.shape
    nk = L - k + 1
    h = nthash_batch_u32(codes, k)  # [B, nk]
    pos_ok = jnp.arange(nk, dtype=jnp.int32)[None, :] < (lengths[:, None] - (k - 1))
    thr = jnp.uint32(fracminhash_threshold(fraction))
    keep = pos_ok & (h <= thr)
    hs = jnp.where(keep, h, _SENTINEL)
    return dedup_select(hs, capacity)


def dedup_select(hs: jnp.ndarray, capacity: int):
    """Sort each row, drop duplicates, compact with a second sort, and
    take the first `capacity` distinct values.

    hs: [B, nk] uint32 with sentinel 0xFFFFFFFF on discarded lanes.
    Returns (hashes [B, capacity] ascending sentinel-padded, mask,
    n_overflow) exactly as sketch_batch documents.

    Two full-width row sorts replace a sort + rank-select binary search:
    the rank-select variant's 8 take_along_axis gathers cost 2x the
    second sort on the accelerator this was first tuned on (not yet
    re-measured on the GPU).
    """
    B, nk = hs.shape
    hs = jnp.sort(hs, axis=-1)
    # First occurrence of each distinct value (ascending => runs adjacent).
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=jnp.bool_), hs[:, 1:] == hs[:, :-1]], axis=1
    ) & (hs != _SENTINEL)
    hs = jnp.where(dup, _SENTINEL, hs)
    hs = jnp.sort(hs, axis=-1)
    n_unique = jnp.sum((hs != _SENTINEL).astype(jnp.int32), axis=-1)
    if nk < capacity:
        pad = jnp.full((B, capacity - nk), _SENTINEL, dtype=jnp.uint32)
        hs = jnp.concatenate([hs, pad], axis=1)
    else:
        hs = hs[:, :capacity]
    mask = hs != _SENTINEL
    n_overflow = jnp.sum(jnp.maximum(n_unique - capacity, 0))
    return hs, mask, n_overflow.astype(jnp.int32)


def sketch_scalar(codes, k: int, fraction: float) -> set:
    """Scalar oracle of the exact reference sketch (a Python set of the
    low-32-bit hashes), for tests and the NumPy reference oracle."""
    from sketch_rna_tpu.hash.nthash import nthash_forward_scalar

    thr = fracminhash_threshold(fraction)
    out = set()
    for h in nthash_forward_scalar(list(codes), k):
        h32 = h & 0xFFFFFFFF
        if h32 <= thr:
            out.add(h32)
    return out
