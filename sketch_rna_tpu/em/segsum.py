"""Scatter-free posterior accumulation for the EM inner loop.

The per-iteration posterior sum `ps[t] = Σ post[lane] over lanes with
tid==t` is the EM hot op (reference: the read->transcript accumulation
loop in src/isoform_assignment.cpp:31-52), a duplicate-index
`scatter-add` that some backends lower to a serialized update loop.

This module replaces it with a layout trick: the lane->transcript keys
are IDENTICAL across all EM iterations, so we sort the lanes by tid ONCE
(build_segsum_plan) and each iteration reduces contiguous segments with
dense vector work only (segsum_apply):

  1. gather the iteration's values into the sorted order          [n]
  2. reshape to [nblk, 512] blocks; a SEGMENTED inclusive scan
     (associative (value, new-run-flag) combiner) yields every run's
     partial sum at its last lane — log-depth vector work, no gathers
  3. ps[t] = Q[seg_end[t]]   — one [T] gather at STATIC positions —
     plus a carry scatter of ONE partial per block boundary a segment
     spans (nblk = n/512 updates, three orders smaller than n)

Numerical safety: the segmented scan only ever ADDS lanes of the same
run, so float32 error stays relative to each segment's own sum exactly
like the scatter path.  (Two rejected alternatives: a full-length
cumsum + boundary diff carries absolute error ~ eps * GLOBAL prefix —
corrupts small counts at 1M reads; a block-prefix diff `wc - base`
carries eps * block sum, which class weights can blow up.)

The plan depends only on the candidate tables (static across the EM
while_loop AND the final assignment pass), costs one [n] sort + one
searchsorted, and is built inside the same jit program — no extra host
syncs and no dynamic shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

BLOCK = 512  # vector-friendly width; bounds within-block f32 error


class SegsumPlan(NamedTuple):
    """All-array pytree (jit-traversable as a plain argument)."""

    perm: jnp.ndarray      # [n_pad] int32: sorted-lane -> flat-lane source
    is_start: jnp.ndarray  # [nblk, BLOCK] bool: within-block run starts
    seg_end: jnp.ndarray   # [T] int32: last sorted lane of t's segment (clamped)
    seg_live: jnp.ndarray  # [T] bool: transcript has >= 1 lane
    carry_tid: jnp.ndarray # [nblk] int32: tid of each block's last lane (0 if dead)
    carry_on: jnp.ndarray  # [nblk] bool: that segment continues into block b+1


def build_segsum_plan(
    flat_tid: jnp.ndarray, num_transcripts: int
) -> SegsumPlan:
    """One-time plan over the concatenated [n] lane tids (flat row-major
    table order).  Pad lanes carry tid 0 with value 0 (the candidate
    tables' convention) — they fold into transcript 0's segment as exact
    zeros, just as the scatter path adds 0 there.
    """
    n = int(flat_tid.shape[0])
    nblk = -(-n // BLOCK)
    n_pad = nblk * BLOCK
    T = num_transcripts

    tid = flat_tid.reshape(-1).astype(jnp.int32)
    if n_pad > n:
        # Sentinel T sorts after every real transcript: pad lanes form a
        # trailing dead segment past pos[T].
        tid = jnp.concatenate([tid, jnp.full(n_pad - n, T, jnp.int32)])
    sorted_tid, perm = jax.lax.sort(
        (tid, jnp.arange(n_pad, dtype=jnp.int32)), num_keys=1
    )
    # pos[t] = first sorted lane with tid >= t (binary search, one-time).
    pos = jnp.searchsorted(
        sorted_tid, jnp.arange(T + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    seg_len = pos[1:] - pos[:-1]
    seg_end = jnp.clip(pos[1:] - 1, 0, n_pad - 1)

    st2 = sorted_tid.reshape(nblk, BLOCK)
    is_start = jnp.concatenate(
        [jnp.ones((nblk, 1), bool), st2[:, 1:] != st2[:, :-1]], axis=1
    )
    carry_tid = st2[:, -1]
    if nblk > 1:
        cont = jnp.concatenate(
            [st2[1:, 0] == st2[:-1, -1], jnp.zeros(1, bool)]
        )
    else:
        cont = jnp.zeros(nblk, bool)
    carry_on = cont & (carry_tid < T)
    return SegsumPlan(
        perm=perm,
        is_start=is_start,
        seg_end=seg_end,
        seg_live=seg_len > 0,
        carry_tid=jnp.where(carry_on, carry_tid, 0),
        carry_on=carry_on,
    )


def plan_from_tables(tables: Sequence[Tuple], num_transcripts: int) -> SegsumPlan:
    """Plan over the partitioned EM tables' concatenated flat tid lanes
    (the order segsum_apply's callers flatten values in)."""
    flat = jnp.concatenate([t[0].reshape(-1) for t in tables])
    return build_segsum_plan(flat, num_transcripts)


def segsum_apply(plan: SegsumPlan, flat_vals: jnp.ndarray) -> jnp.ndarray:
    """ps[t] = Σ flat_vals[lane] over lanes with tid == t, no scatter.

    flat_vals: [n] (>= 0) in the SAME flat order the plan was built
    from.  Returns [T] in flat_vals' dtype.
    """
    n_pad = plan.perm.shape[0]
    nblk = n_pad // BLOCK
    dt = flat_vals.dtype
    v = flat_vals.reshape(-1)
    if n_pad > v.shape[0]:
        v = jnp.concatenate([v, jnp.zeros(n_pad - v.shape[0], dt)])
    sp = v[plan.perm].reshape(nblk, BLOCK)

    # Segmented inclusive scan (Blelloch): carry (sum, started) pairs;
    # a lane that starts a run discards the left partial.  The operator
    # is associative, so lax.associative_scan applies — and every
    # addition combines lanes of ONE run (f32 error stays run-local).
    def seg_combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av + bv), af | bf

    q, _ = jax.lax.associative_scan(
        seg_combine, (sp, plan.is_start), axis=1
    )  # q[lane] = sum of its run up to and including it

    qf = q.reshape(-1)
    ps = jnp.where(plan.seg_live, qf[plan.seg_end], jnp.zeros((), dt))
    # Segments spanning a block boundary: each non-final block they touch
    # ends at that block's last lane; add those partials (tiny scatter).
    carry = jnp.where(plan.carry_on, q[:, -1], jnp.zeros((), dt))
    return ps.at[plan.carry_tid].add(carry)
