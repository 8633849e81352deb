"""Candidate-transcript extraction ("sparse chaining"), vectorised.

Replaces the per-read hash-map counting of the reference
(sparse_chain, src/sparse_chaining.cpp:29-115) with a fully batched
construction:

  1. per k: probe + ragged-expand all posting events (match/lookup.py),
  2. group events by (read, transcript) with one lexicographic device
     sort; run boundaries give the per-(read,transcript) match counts per
     k via sorted segment-sums (the match_counts map, :48-73),
  3. per-read per-k maxima via a segment-max over runs (:76-82),
  4. forall-k fractional threshold + summed score (:83-105), with the
     fraction comparison done in exact integer arithmetic when the
     fraction is a small rational (0.9 -> 9/10), which matches the C++
     double comparison for all realistic counts,
  5. per-read top-C candidate tables by (score desc, tid asc), mirroring
     the reference's descending score sort (:108-109); reads keep AT MOST
     candidate_capacity candidates — spills are counted, never silent.

Everything is static-shaped; the only data-dependent quantities are
masks and overflow counters.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from sketch_rna_tpu.match.lookup import expand_postings, lookup_postings


@dataclasses.dataclass
class MatchResult:
    """Fixed-shape per-batch candidate tables.

    tid:   [B, C] int32 candidate transcript index.
    score: [B, C] int32 summed match count (the reference's final_score).
    mask:  [B, C] bool validity; row-major by (score desc, tid asc).
    stats: overflow counters (expansion drops per k, candidate spills).
    """

    tid: jnp.ndarray
    score: jnp.ndarray
    mask: jnp.ndarray
    stats: Dict[str, jnp.ndarray]


def _fraction_compare_params(fraction: float) -> Tuple[int, int]:
    """(p, q) with fraction ~= p/q for exact integer thresholding, or
    (0, 0) if no small rational matches closely enough."""
    fr = Fraction(fraction).limit_denominator(10000)
    if abs(float(fr) - fraction) < 1e-12:
        return fr.numerator, fr.denominator
    return 0, 0


def expand_events(
    sketch_hashes: Sequence[jnp.ndarray],
    sketch_masks: Sequence[jnp.ndarray],
    index_keys: Sequence[jnp.ndarray],
    index_row_ptr: Sequence[jnp.ndarray],
    index_postings: Sequence[jnp.ndarray],
    *,
    expand_per_read: int,
):
    """Steps 1 of match_batch: per-k probe + ragged expansion into flat
    (read, tid, k) match events.  Factored out so the index-sharded path
    can all_gather events across index shards before grouping
    (dist/quant_sharded.py).

    Returns (read_e, tid_e, valid_e, kid_e, drops) — each [K*E] except
    drops, a length-K list of scalars.
    """
    K = len(sketch_hashes)
    assert K == len(index_keys) == len(index_row_ptr) == len(index_postings)
    B = sketch_hashes[0].shape[0]
    E = B * expand_per_read

    read_parts, tid_parts, valid_parts, kid_parts, drops = [], [], [], [], []
    for ki in range(K):
        start, length = lookup_postings(
            sketch_hashes[ki], sketch_masks[ki], index_keys[ki], index_row_ptr[ki]
        )
        r, t, v, d = expand_postings(start, length, index_postings[ki], E)
        read_parts.append(r)
        tid_parts.append(t)
        valid_parts.append(v)
        kid_parts.append(jnp.full(E, ki, dtype=jnp.int32))
        drops.append(d)

    return (
        jnp.concatenate(read_parts),
        jnp.concatenate(tid_parts),
        jnp.concatenate(valid_parts),
        jnp.concatenate(kid_parts),
        drops,
    )


def events_to_candidates(
    read_e: jnp.ndarray,
    tid_e: jnp.ndarray,
    valid_e: jnp.ndarray,
    kid_e: jnp.ndarray,
    *,
    num_reads: int,
    num_k: int,
    chain_fraction: float,
    candidate_capacity: int,
) -> MatchResult:
    """Steps 2-5 of match_batch: group flat events by (read, transcript),
    count per k, threshold, and build per-read top-C tables."""
    B = num_reads
    K = num_k
    C = candidate_capacity
    F = read_e.shape[0]

    # ---- group events by (read, tid): one lexicographic sort ----------
    # Invalid events carry read B / tid 0 and collapse into one tail run.
    s_read, s_tid, s_kid, s_valid = jax.lax.sort(
        (read_e, tid_e, kid_e, valid_e.astype(jnp.int32)), num_keys=2
    )
    s_valid = s_valid.astype(jnp.bool_)
    prev_r = jnp.concatenate([jnp.full(1, -1, jnp.int32), s_read[:-1]])
    prev_t = jnp.concatenate([jnp.full(1, -1, jnp.int32), s_tid[:-1]])
    new_run = (s_read != prev_r) | (s_tid != prev_t)
    run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1  # [F] non-decreasing

    # Per-run per-k match counts (the match_counts vectors).
    counts = [
        jax.ops.segment_sum(
            ((s_kid == ki) & s_valid).astype(jnp.int32),
            run_id,
            num_segments=F,
            indices_are_sorted=True,
        )
        for ki in range(K)
    ]
    # Run representatives (duplicate scatter writes carry equal values).
    run_read = jnp.full(F, B, jnp.int32).at[run_id].set(s_read)
    run_tid = jnp.zeros(F, jnp.int32).at[run_id].set(s_tid)
    run_valid = run_read < B

    # ---- per-read per-k maxima ---------------------------------------
    seg_read = jnp.minimum(run_read, B)  # invalid runs -> segment B
    max_k = []
    for ki in range(K):
        mx = jax.ops.segment_max(
            counts[ki], seg_read, num_segments=B + 1, indices_are_sorted=True
        )[:B]
        max_k.append(jnp.maximum(mx, 0))

    # ---- forall-k fractional threshold + score -----------------------
    p, q = _fraction_compare_params(chain_fraction)
    meets = run_valid
    score = jnp.zeros(F, jnp.int32)
    read_clip = jnp.clip(run_read, 0, B - 1)
    for ki in range(K):
        mx_run = max_k[ki][read_clip]
        if q > 0:
            ok = counts[ki] * q >= mx_run * p
        else:
            ok = counts[ki].astype(jnp.float32) >= jnp.float32(chain_fraction) * mx_run.astype(
                jnp.float32
            )
        meets = meets & ok
        score = score + counts[ki]

    # ---- per-read top-C candidate tables -----------------------------
    cand_read = jnp.where(meets, run_read, B)
    neg_score = -score
    c_read, c_negscore, c_tid = jax.lax.sort((cand_read, neg_score, run_tid), num_keys=3)
    first_of_read = jnp.searchsorted(c_read, c_read, side="left").astype(jnp.int32)
    rank = jnp.arange(F, dtype=jnp.int32) - first_of_read
    ok = (c_read < B) & (rank < C)
    rows = jnp.where(ok, c_read, B)
    cols = jnp.where(ok, rank, 0)
    tbl_tid = jnp.zeros((B, C), jnp.int32).at[rows, cols].set(c_tid, mode="drop")
    tbl_score = jnp.zeros((B, C), jnp.int32).at[rows, cols].set(-c_negscore, mode="drop")
    tbl_mask = jnp.zeros((B, C), jnp.bool_).at[rows, cols].set(True, mode="drop")

    cand_per_read = jax.ops.segment_sum(
        (c_read < B).astype(jnp.int32),
        jnp.minimum(c_read, B),
        num_segments=B + 1,
        indices_are_sorted=True,
    )[:B]
    stats = {
        "candidate_spilled": jnp.sum(jnp.maximum(cand_per_read - C, 0)),
    }
    return MatchResult(tid=tbl_tid, score=tbl_score, mask=tbl_mask, stats=stats)


def match_batch(
    sketch_hashes: Sequence[jnp.ndarray],
    sketch_masks: Sequence[jnp.ndarray],
    index_keys: Sequence[jnp.ndarray],
    index_row_ptr: Sequence[jnp.ndarray],
    index_postings: Sequence[jnp.ndarray],
    *,
    chain_fraction: float,
    expand_per_read: int,
    candidate_capacity: int,
) -> MatchResult:
    """Match one read batch against a fully local (replicated) index.

    sketch_hashes/masks: per-k [B, S_k] sketches (sketch/fracminhash.py).
    index_*: per-k CSR arrays (index/artifact.py), keys padded non-empty.
    """
    read_e, tid_e, valid_e, kid_e, drops = expand_events(
        sketch_hashes,
        sketch_masks,
        index_keys,
        index_row_ptr,
        index_postings,
        expand_per_read=expand_per_read,
    )
    result = events_to_candidates(
        read_e,
        tid_e,
        valid_e,
        kid_e,
        num_reads=sketch_hashes[0].shape[0],
        num_k=len(sketch_hashes),
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
    )
    result.stats["expand_dropped"] = jnp.stack(drops)
    return result
