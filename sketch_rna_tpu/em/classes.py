"""Equivalence-class reduction for the EM.

Reads with identical candidate profiles (same transcripts, same match
counts) receive identical E-step posteriors, so the EM can iterate over
DISTINCT profiles weighted by multiplicity instead of over reads — the
classic equivalence-class trick.  This preserves the reference's
per-read math: summing m identical posterior vectors equals m times one
of them, and the per-read denominators don't change.  EM cost then
scales with the number of distinct classes (bounded by the
transcriptome's ambiguity structure), not the read count.

Two-phase, sync-light layout (the phase split keeps every [N, W]-sized
gather/scatter OFF the hot path — grouping cost is one 4-key sort of N
lanes plus O(N) vector work):

  phase 1 (group_candidate_rows_meta): 128-bit row hashes -> sort ->
    run boundaries -> per-class weight, representative row index, and
    the (n_classes, n_wide) scalars, all [N]-shaped.
  phase 2 (build_class_tables, static sizes from the one host sync):
    gather the [M_pad, W] class tables from the ORIGINAL rows via the
    representative indices and split them into narrow/wide partitions.

Rows are merged when their 128-bit hashes collide across all four
lanes; for distinct rows that requires a 128-bit collision between
adjacent sort neighbors (probability < N^2 / 2^128 ~ 1e-28 at N=10^6 —
dozens of orders of magnitude below hardware soft-error rates).
Identical rows always hash equal, so classes are never split.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# golden-ratio mixing constants — np scalars so importing this module
# never initializes the XLA backend (breaks jax.distributed.initialize)
_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)
_M3 = np.uint32(0xC2B2AE3D)
_M4 = np.uint32(0x27D4EB2F)


def _mix(h: jnp.ndarray, v: jnp.ndarray, mult: jnp.ndarray) -> jnp.ndarray:
    h = (h ^ v) * mult
    return h ^ (h >> jnp.uint32(15))


@partial(jax.jit, static_argnames=("narrow_width", "mid_width"))
def group_candidate_rows_meta(
    tbl_tid: jnp.ndarray,
    tbl_score: jnp.ndarray,
    narrow_width: int = 8,
    row_weight: jnp.ndarray = None,
    mid_width: int = 0,
):
    """Phase 1: grouping metadata for identical (tid-row, score-row)
    pairs — no [N, W] data movement.

    Args:
      tbl_tid, tbl_score: [N, W] int32 candidate tables (rank-ordered,
        zero-padded) — identical reads produce identical rows.
      narrow_width: class profiles with more than this many candidates
        count into n_wide (for the caller's narrow/wide partition).
      row_weight: optional [N] int32 per-row multiplicities (rows that
        are themselves compacted classes, streaming path); default 1.
      mid_width: optional middle tier bound (> narrow_width): classes
        with narrow_width < n_cand <= mid_width count into n_mid.

    Returns:
      rep_orig: [N] int32 — ORIGINAL row index of class c's
                representative at position c (arbitrary past n_classes).
      weight:   [N] int32 multiplicities (0 past n_classes).
      scalars:  [5] int32 (n_classes, n_wide, n_tail1, n_mid, n_pair)
                where n_tail1 counts classes with <= 1 candidates
                (foldable: their per-iteration EM contribution is
                constant), n_mid the middle-tier classes (0 when
                mid_width unset), and n_pair the classes with EXACTLY 2
                candidates (eligible for the width-2 tier — ~31% of
                non-singleton classes on measured transcriptomes).
    """
    N, W = tbl_tid.shape
    h1 = jnp.full(N, 0x811C9DC5, jnp.uint32)
    h2 = jnp.full(N, 0x01000193, jnp.uint32)
    h3 = jnp.full(N, 0xDEADBEEF, jnp.uint32)
    h4 = jnp.full(N, 0x9E3779B9, jnp.uint32)
    for c in range(W):
        tv = jax.lax.bitcast_convert_type(tbl_tid[:, c], jnp.uint32)
        sv = jax.lax.bitcast_convert_type(tbl_score[:, c], jnp.uint32)
        h1 = _mix(_mix(h1, tv, _M1), sv, _M2)
        h2 = _mix(_mix(h2, sv, _M3), tv, _M1)
        h3 = _mix(_mix(h3, tv, _M4), sv, _M3)
        h4 = _mix(_mix(h4, sv, _M2), tv, _M4)

    s_h1, s_h2, s_h3, s_h4, s_idx = jax.lax.sort(
        (h1, h2, h3, h4, jnp.arange(N, dtype=jnp.int32)), num_keys=4
    )

    def _prev(x, fill):
        return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

    same = (
        (s_h1 == _prev(s_h1, 0))
        & (s_h2 == _prev(s_h2, 0))
        & (s_h3 == _prev(s_h3, 1))  # differing fills: row 0 is never "same"
        & (s_h4 == _prev(s_h4, 0))
    )
    new_class = jnp.logical_not(same)
    class_id = jnp.cumsum(new_class.astype(jnp.int32)) - 1  # [N] ascending
    n_classes = class_id[-1] + 1

    rw = (
        jnp.ones(N, jnp.int32)
        if row_weight is None
        else row_weight.astype(jnp.int32)[s_idx]
    )
    weight = jax.ops.segment_sum(
        rw, class_id, num_segments=N, indices_are_sorted=True
    )
    # Any member's original row represents the class (rows identical);
    # last-write-wins scatter of 1-D indices is cheap.
    rep_orig = jnp.zeros(N, jnp.int32).at[class_id].set(s_idx)

    n_cand = jnp.sum(tbl_score > 0, axis=1)  # [N] on original rows
    nc_rep = n_cand[rep_orig]
    live = weight > 0
    is_wide = (nc_rep > narrow_width) & live
    n_wide = jnp.sum(is_wide.astype(jnp.int32))
    n_tail1 = jnp.sum(((nc_rep <= 1) & live).astype(jnp.int32))
    if mid_width > narrow_width:
        n_mid = jnp.sum(
            ((nc_rep > narrow_width) & (nc_rep <= mid_width) & live).astype(jnp.int32)
        )
    else:
        n_mid = jnp.int32(0)
    n_pair = jnp.sum(((nc_rep == 2) & live).astype(jnp.int32))
    # jnp.sum/cumsum promote to the default int width under x64; pin the
    # scalars to int32 so carries stay dtype-stable.
    return (
        rep_orig,
        weight,
        jnp.stack([n_classes, n_wide, n_tail1, n_mid, n_pair]).astype(jnp.int32),
    )


def _round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_class_tables(
    scalars_host,
    *,
    width: int,
    n_pad: int,
    narrow_width: int,
    mid_width: int = 0,
    fold_singletons: bool = True,
    pair_width: int = 0,
):
    """Host-side static plan for build_class_tables from the one sync.

    scalars_host: the first 4-5 ints from group_candidate_rows_meta
    (the 5th, n_pair, may be absent for callers on the 4-scalar layout —
    the pair tier then stays off).
    width: the (already narrowed) table width W.
    n_pad: the padded row count of the source tables (upper bound m_pad).
    pair_width: 2 enables the width-2 tier for exactly-2-candidate
    classes (~31% of non-singleton classes measured; halves their EM
    lanes vs the narrow tier).

    Returns a dict of STATIC sizes/flags to splat into
    build_class_tables; pads are quantized (2048/512 multiples) so the
    compiled-program family stays small.
    """
    vals = [int(x) for x in scalars_host]
    n_classes, n_wide, n_tail1, n_mid = vals[:4]
    n_pair = vals[4] if len(vals) > 4 else 0
    m_pad = min(max(_round_to(n_classes, 2048), 1024), n_pad)
    split = width > narrow_width and n_wide > 0 and m_pad >= 1024
    fold = bool(fold_singletons) and n_tail1 > 0 and m_pad >= 1024
    mid_active = (
        split and mid_width > narrow_width and width > mid_width and n_mid > 0
    )
    pair_active = (
        pair_width == 2 and narrow_width > 2 and n_pair > 0 and m_pad >= 1024
    )
    nw2 = n_wide - (n_mid if mid_active else 0)
    wide_active = split and nw2 > 0
    n_multi = (
        n_classes
        - (n_wide if split else 0)
        - (n_tail1 if fold else 0)
        - (n_pair if pair_active else 0)
    )
    nm_pad = min(max(_round_to(max(n_multi, 1), 2048), 1024), m_pad)
    np_pad = min(_round_to(n_pair, 2048), m_pad) if pair_active else 0
    nmid_pad = min(_round_to(n_mid, 512), m_pad) if mid_active else 0
    nw_pad = min(_round_to(max(nw2, 1), 512), m_pad) if wide_active else 0
    # With no wide class anywhere, every profile fits narrow_width lanes
    # even when the raw table is wider (rank-ordered rows: the dropped
    # columns are all zero).
    out_width = narrow_width if (width > narrow_width and n_wide == 0) else width
    return dict(
        m_pad=m_pad,
        nm_pad=nm_pad,
        nmid_pad=nmid_pad,
        nw_pad=nw_pad,
        np_pad=np_pad,
        narrow_width=narrow_width,
        mid_width=mid_width if mid_active else 0,
        out_width=out_width,
        split=split,
        fold=fold,
    )


@partial(
    jax.jit,
    static_argnames=(
        "m_pad",
        "nm_pad",
        "nmid_pad",
        "nw_pad",
        "np_pad",
        "narrow_width",
        "mid_width",
        "out_width",
        "split",
        "fold",
        "num_transcripts",
    ),
)
def build_class_tables(
    tbl_tid: jnp.ndarray,
    tbl_score: jnp.ndarray,
    rep_orig: jnp.ndarray,
    weight: jnp.ndarray,
    *,
    m_pad: int,
    nm_pad: int,
    nmid_pad: int,
    nw_pad: int,
    narrow_width: int,
    mid_width: int,
    out_width: int,
    split: bool,
    fold: bool,
    np_pad: int = 0,
    num_transcripts: int = 0,
):
    """Phase 2: materialize width-tiered class tables at static sizes.

    Gathers the [m_pad, W] class profiles from the ORIGINAL tables via
    rep_orig (classes past n_classes carry weight 0 and are inert) and
    partitions them by candidate count into up to three loop tables —
    narrow [nm_pad, narrow_width], mid [nmid_pad, mid_width], wide
    [nw_pad, out_width] — so per-iteration EM lanes track the true pair
    count.  Tier truncation only ever drops all-zero lanes (profiles
    are rank-ordered).

    With fold=True, classes with EXACTLY one candidate leave the loop
    entirely: their E-step posterior is identically 1 (the denominator
    pi[t]*count is bounded below by pseudocount*1 >> epsilon, and the
    reference computes num/denom = x/x = 1 exactly,
    src/isoform_assignment.cpp:38-47), so their per-iteration posterior
    contribution is the CONSTANT weight vector.  That constant is
    scattered ONCE here into static_base [T] (int32 — exact), with
    static_has [T] marking their has-entry bits for the CSV row filter.

    Returns (tables, static_base, static_has); the static pair is
    (None, None) unless fold.
    """
    sel = jax.lax.slice_in_dim(rep_orig, 0, m_pad)
    tid_c = tbl_tid[sel]  # [m_pad, W]
    score_c = tbl_score[sel]
    w_c = jax.lax.slice_in_dim(weight, 0, m_pad)
    return tier_partition(
        tid_c,
        score_c,
        w_c,
        nm_pad=nm_pad,
        nmid_pad=nmid_pad,
        nw_pad=nw_pad,
        np_pad=np_pad,
        narrow_width=narrow_width,
        mid_width=mid_width,
        out_width=out_width,
        split=split,
        fold=fold,
        num_transcripts=num_transcripts,
    )


def tier_partition(
    tid_c: jnp.ndarray,  # [m_pad, W] class profiles (rank-ordered)
    score_c: jnp.ndarray,
    w_c: jnp.ndarray,  # [m_pad] multiplicities (0 = dead row)
    *,
    nm_pad: int,
    nmid_pad: int,
    nw_pad: int,
    narrow_width: int,
    mid_width: int,
    out_width: int,
    split: bool,
    fold: bool,
    np_pad: int = 0,
    num_transcripts: int = 0,
):
    """Width-tier an ALREADY-materialized class table (the partition half
    of build_class_tables; also called per-shard inside the sharded EM,
    dist/quant_stream.em_assign_sharded, where each device tiers its
    local buffer at mesh-max static sizes).

    Per-tier counts are recomputed locally from (score_c, w_c) — exact,
    and self-contained so shards with differing fills share one program.
    np_pad > 0 adds a width-2 tier for exactly-2-candidate classes
    (halves their EM lanes vs the narrow tier; ~31% of non-singleton
    classes on the bench transcriptome).
    Returns (tables, static_base, static_has) as build_class_tables.
    """
    m_pad = tid_c.shape[0]
    if not split and not fold and not np_pad:
        ow = out_width or tid_c.shape[1]
        return ((tid_c[:, :ow], score_c[:, :ow], w_c),), None, None

    n_cand = jnp.sum(score_c > 0, axis=1)
    live = w_c > 0

    static_base = static_has = None
    if fold:
        is_single = (n_cand == 1) & live
        sw = jnp.where(is_single, w_c, 0)
        tid0 = tid_c[:, 0]
        static_base = jnp.zeros(num_transcripts, jnp.int32).at[tid0].add(sw)
        static_has = (
            jnp.zeros(num_transcripts, jnp.int32)
            .at[tid0]
            .add(is_single.astype(jnp.int32))
            > 0
        )

    mid_active = mid_width > narrow_width and nmid_pad > 0
    wide_active = nw_pad > 0
    pair_active = np_pad > 0
    if split and mid_active:
        tier = jnp.where(
            n_cand > mid_width, 0, jnp.where(n_cand > narrow_width, 1, 2)
        )
    elif split:
        tier = jnp.where(n_cand > narrow_width, 0, 2)
    else:
        tier = jnp.full(m_pad, 2, jnp.int32)
    if pair_active:
        tier = jnp.where(n_cand == 2, 3, tier)
    if fold:
        tier = jnp.where(n_cand <= 1, 4, tier)
    tier = jnp.where(live, tier, 5).astype(jnp.int32)
    order = jnp.argsort(tier, stable=True).astype(jnp.int32)
    ext = max(nm_pad, nmid_pad, np_pad)
    order_ext = jnp.concatenate([order, jnp.zeros(ext, jnp.int32)])

    cnt_wide = jnp.sum((tier == 0).astype(jnp.int32))
    cnt_mid = jnp.sum((tier == 1).astype(jnp.int32))
    cnt_multi = jnp.sum((tier == 2).astype(jnp.int32))
    cnt_pair = jnp.sum((tier == 3).astype(jnp.int32))
    start_mid = cnt_wide
    start_multi = cnt_wide + cnt_mid
    start_pair = cnt_wide + cnt_mid + cnt_multi

    def _tier_table(idx, count, w_lanes, size):
        t = tid_c[idx][:, :w_lanes]
        s = score_c[idx][:, :w_lanes]
        w = jnp.where(jnp.arange(size) < count, w_c[idx], 0)
        return (t, s, w)

    tables = []
    if wide_active:
        tables.append(
            _tier_table(
                jax.lax.slice_in_dim(order, 0, nw_pad), cnt_wide, out_width, nw_pad
            )
        )
    if mid_active:
        idx_m = jax.lax.dynamic_slice_in_dim(order_ext, start_mid, nmid_pad)
        tables.append(_tier_table(idx_m, cnt_mid, mid_width, nmid_pad))
    narrow_w = narrow_width if split else out_width
    idx_n = jax.lax.dynamic_slice_in_dim(order_ext, start_multi, nm_pad)
    tables.append(_tier_table(idx_n, cnt_multi, narrow_w, nm_pad))
    if pair_active:
        idx_p = jax.lax.dynamic_slice_in_dim(order_ext, start_pair, np_pad)
        tables.append(_tier_table(idx_p, cnt_pair, min(2, narrow_w), np_pad))
    return tuple(tables), static_base, static_has


@jax.jit
def group_candidate_rows(tbl_tid: jnp.ndarray, tbl_score: jnp.ndarray):
    """Single-call grouping (compatibility/reference form over the
    two-phase API): returns (cls_tid [N, W], cls_score, weight [N],
    n_classes) with class c's profile at row c."""
    rep_orig, weight, scalars = group_candidate_rows_meta(tbl_tid, tbl_score)
    cls_tid = tbl_tid[rep_orig]
    cls_score = tbl_score[rep_orig]
    return cls_tid, cls_score, weight, scalars[0]
