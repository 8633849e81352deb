"""Index lookup + ragged posting expansion, fixed-shape for XLA.

Replaces the inner loops of sparse_chain (reference
src/sparse_chaining.cpp:48-73): per read-sketch hash, find the posting
list and emit one (read, transcript) event per posting.

Accelerator shape: the hash-map probe becomes a batched binary search over
the sorted key array (jnp.searchsorted); the per-hash variable-length
posting walk becomes a flat "expansion" of all postings in the batch into
a fixed budget E, using the standard ragged-gather construction: an
exclusive cumsum of posting-run lengths defines each run's span in the
flat output, and searchsorted over the cumsum inverts flat position ->
owning run.  Everything is static-shaped; spill past the budget is
counted, never silent (SURVEY.md §7.4 "Raggedness everywhere").
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Saturation cap for cumulative posting counts: large enough to exceed any
# sane expansion budget, small enough that int32 a+b cannot wrap.
_CUM_CAP = np.int32(1 << 30)  # np scalar: import must not init the backend


def _saturating_cumsum_i32(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cumsum of nonnegative int32 with saturation at 2^30.

    min(a+b, CAP) is associative for nonnegative inputs bounded by CAP, so
    this lowers to a log-depth associative scan and stays monotone even
    when the true sum would overflow int32.
    """
    return jax.lax.associative_scan(lambda a, b: jnp.minimum(a + b, _CUM_CAP), x)


def lookup_postings(
    hashes: jnp.ndarray,
    mask: jnp.ndarray,
    keys: jnp.ndarray,
    row_ptr: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Probe the sorted key array for each sketch hash.

    Args:
      hashes: [B, S] uint32 sketch hashes (sentinel-padded).
      mask:   [B, S] bool validity.
      keys:   [U] sorted uint32 index keys (U >= 1; callers pad empty
              indexes with one sentinel key and row_ptr [0, 0]).
      row_ptr:[U+1] int32 CSR offsets.

    Returns:
      start: [B, S] int32 posting-run starts (0 where not found).
      length:[B, S] int32 posting-run lengths (0 where not found).
    """
    U = keys.shape[0]
    idx = jnp.searchsorted(keys, hashes, side="left").astype(jnp.int32)
    idx = jnp.minimum(idx, U - 1)
    found = mask & (keys[idx] == hashes)
    start = jnp.where(found, row_ptr[idx], 0).astype(jnp.int32)
    length = jnp.where(found, row_ptr[idx + 1] - row_ptr[idx], 0).astype(jnp.int32)
    return start, length


def expand_postings(
    start: jnp.ndarray,
    length: jnp.ndarray,
    postings: jnp.ndarray,
    budget: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flatten all (read, posting) events of the batch into [budget] lanes.

    Args:
      start, length: [B, S] posting-run spans from lookup_postings.
      postings: [P] int32 transcript indices.
      budget: static flat budget E.

    Returns:
      read_e:  [E] int32 owning read row (B where lane is empty).
      tid_e:   [E] int32 transcript index (0 where lane is empty).
      valid_e: [E] bool.
      n_dropped: [] int32 events beyond the budget (saturating count).
    """
    B, S = start.shape
    P = postings.shape[0]
    flat_start = start.reshape(-1)
    flat_len = length.reshape(-1)
    cum = _saturating_cumsum_i32(flat_len)  # inclusive
    total = cum[-1]
    e = jnp.arange(budget, dtype=jnp.int32)
    # Owning slot: first index with cum > e.
    src = jnp.searchsorted(cum, e, side="right").astype(jnp.int32)
    src = jnp.minimum(src, B * S - 1)
    run_begin = cum[src] - flat_len[src]
    offset = e - run_begin
    valid_e = e < total
    p_idx = jnp.clip(flat_start[src] + offset, 0, P - 1)
    tid_e = jnp.where(valid_e, postings[p_idx], 0).astype(jnp.int32)
    read_e = jnp.where(valid_e, src // S, B).astype(jnp.int32)
    n_dropped = jnp.maximum(total - budget, 0)
    return read_e, tid_e, valid_e, n_dropped
