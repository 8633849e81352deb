"""Row-parallel candidate matching — the production match path.

Semantically identical to match/candidates.py (the reference's
sparse_chain, src/sparse_chaining.cpp:29-115; equality asserted in
tests/test_rowmatch.py) but shaped for wide elementwise units:

  - posting expansion is PER-READ into a fixed [B, Epr] event window;
    the owning sketch-slot per lane comes from a compare-accumulate
    sweep over the S (static, small) per-read cumsum columns — zero
    gathers, no global searchsorted,
  - (read, transcript, k) grouping is a ROW sort of packed int32 keys
    (tid*K + k) — 256-lane independent row sorts instead of one global
    multi-operand sort: far fewer comparator passes and no cross-row
    data movement,
  - per-(tid,k) counts, per-read per-k maxima, per-tid forall-k
    threshold and score all reduce along rows with cummax/cumsum —
    zero scatters,
  - the per-read top-C candidate table is one more row sort (single
    packed key when the transcript count permits) + slice.

The only capacity difference vs candidates.py: the expansion budget is
per read per k (events_per_read) rather than a batch-global pool; spills
are counted per batch, never silent.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sketch_rna_tpu.match.candidates import MatchResult, _fraction_compare_params
from sketch_rna_tpu.match.lookup import lookup_postings

_I32_MAX = np.int32(2**31 - 1)  # np scalar: import must not init the backend


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def row_expand_events(
    hashes: jnp.ndarray,
    mask: jnp.ndarray,
    keys: jnp.ndarray,
    row_ptr: jnp.ndarray,
    postings: jnp.ndarray,
    *,
    events_per_read: int,
    k_index: int,
    num_k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Expand one k's posting events into per-read lanes (sorted-array
    probe variant; see row_expand_from_runs for the core)."""
    start, length = lookup_postings(hashes, mask, keys, row_ptr)
    return row_expand_from_runs(
        start,
        length,
        postings,
        events_per_read=events_per_read,
        k_index=k_index,
        num_k=num_k,
    )


def row_expand_from_runs(
    start: jnp.ndarray,
    length: jnp.ndarray,
    postings: jnp.ndarray,
    *,
    events_per_read: int,
    k_index: int,
    num_k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Expand posting runs [B, S] into per-read event lanes.

    Returns (key [B, Epr] int32 packed tid*K + k_index, sentinel-filled;
             n_dropped [] int32 events past the per-read budget).
    """
    B, S = start.shape
    Epr = events_per_read
    P = postings.shape[0]

    cum = jnp.cumsum(length, axis=1)  # [B, S] inclusive
    total = cum[:, -1:]  # [B, 1]

    j = jnp.arange(Epr, dtype=jnp.int32)[None, :]  # [1, Epr]
    # Find the owning sketch slot for each event lane by scanning the S
    # (small, static) per-read cumsum columns with pure compares — no
    # gathers at all.  slot = first s with cum[s] > j; run_begin =
    # cum[slot-1]; sel_start = start[slot].
    run_begin = jnp.zeros((B, Epr), jnp.int32)
    sel_start = jnp.broadcast_to(start[:, 0:1], (B, Epr))
    for s in range(1, S):
        le = cum[:, s - 1 : s] <= j  # slot >= s
        run_begin = jnp.where(le, cum[:, s - 1 : s], run_begin)
        sel_start = jnp.where(le, start[:, s : s + 1], sel_start)
    valid = j < total
    # Invalid (padding) lanes all fetch postings[0] — one hot element —
    # instead of scattered clipped addresses: the window is sized for the
    # ambiguous tail, so most lanes are padding and their gather traffic
    # is otherwise real.  Output-identical (invalid keys are overwritten
    # with the sentinel below).
    p_idx = jnp.where(
        valid, jnp.clip(sel_start + (j - run_begin), 0, P - 1), 0
    )
    tid_ev = postings[p_idx]  # [B, Epr] — the one unavoidable gather
    key = jnp.where(valid, tid_ev * num_k + k_index, _I32_MAX)
    n_dropped = jnp.sum(jnp.maximum(total[:, 0] - Epr, 0))
    return key, n_dropped


def _bitonic_merge_pair(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Merge two row-wise ASCENDING-sorted [B, w] int32 arrays into one
    sorted [B, 2w] row: reverse b (making each row bitonic) then run the
    log2(2w) compare-exchange stages of a bitonic merge.  Requires w to
    be a power of two (callers check).

    Why: XLA's row sort is super-linear in width (w*log^2 w comparator
    passes), so sorting K per-k event windows separately and MERGING
    (log-linear) beats one K-times-wider sort — the DESIGN known-gap 8
    fix for the multi-k grouping stage.
    """
    B, w = a.shape
    x = jnp.concatenate([a, b[:, ::-1]], axis=1)
    n = 2 * w
    d = n // 2
    while d >= 1:
        y = x.reshape(B, n // (2 * d), 2, d)
        lo = jnp.minimum(y[:, :, 0, :], y[:, :, 1, :])
        hi = jnp.maximum(y[:, :, 0, :], y[:, :, 1, :])
        x = jnp.stack((lo, hi), axis=2).reshape(B, n)
        d //= 2
    return x


def sort_event_parts(parts: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Row-sort per-k event-key parts and combine into one sorted row.

    When every part has the same power-of-two width and the part count
    is a power of two, each [B, w] part sorts independently and a
    bitonic merge tree combines them — identical output to sorting the
    concatenation (same value multiset per row, fully sorted); it was
    faster at multi-k GENCODE shapes on the accelerator the design was
    first tuned on (scripts/profile_multik_merge.py).
    Otherwise falls back to the full-width sort.
    """
    if len(parts) == 1:
        return jnp.sort(parts[0], axis=-1)
    widths = {int(p.shape[1]) for p in parts}
    w = parts[0].shape[1]
    kp = len(parts)
    if len(widths) == 1 and w & (w - 1) == 0 and kp & (kp - 1) == 0:
        level = [jnp.sort(p, axis=-1) for p in parts]
        while len(level) > 1:
            level = [
                _bitonic_merge_pair(level[i], level[i + 1])
                for i in range(0, len(level), 2)
            ]
        return level[0]
    return jnp.sort(jnp.concatenate(parts, axis=1), axis=-1)


def _merge_sorted_pair_payload(ka, pa, kb, pb):
    """Bitonic-merge two row-wise key-sorted [B, w] pairs (key, payload)
    into sorted [B, 2w]; payload rides the compare-exchanges."""
    B, w = ka.shape
    k = jnp.concatenate([ka, kb[:, ::-1]], axis=1)
    p = jnp.concatenate([pa, pb[:, ::-1]], axis=1)
    n = 2 * w
    d = n // 2
    while d >= 1:
        kr = k.reshape(B, n // (2 * d), 2, d)
        pr = p.reshape(B, n // (2 * d), 2, d)
        a_k, b_k = kr[:, :, 0, :], kr[:, :, 1, :]
        a_p, b_p = pr[:, :, 0, :], pr[:, :, 1, :]
        sw = a_k > b_k
        k = jnp.stack(
            (jnp.where(sw, b_k, a_k), jnp.where(sw, a_k, b_k)), axis=2
        ).reshape(B, n)
        p = jnp.stack(
            (jnp.where(sw, b_p, a_p), jnp.where(sw, a_p, b_p)), axis=2
        ).reshape(B, n)
        d //= 2
    return k, p


def _top_c_select(meets, tid, score, *, score_bound, candidate_capacity, num_transcripts):
    """Select the top-C candidate lanes by (score desc, tid asc).

    Shared tail of row_events_to_candidates and combine_k_tables.
    score_bound: static upper bound on any score value (rank packing).
    """
    B, W = tid.shape
    C = candidate_capacity
    big = jnp.int32(score_bound + 2)
    prim = jnp.where(meets, (score_bound + 1) - score, big)
    prim_bits = int(score_bound + 2).bit_length()
    tid_bits = 31 - prim_bits
    if 0 < num_transcripts <= (1 << tid_bits):
        # Pack (rank, tid) into one int32: single-operand selection.
        # Non-candidate lanes carry arbitrary tids; zero them (their
        # rank byte already sorts them last).
        tid_c = jnp.where(meets, tid, 0)
        packed = (prim << tid_bits) | tid_c
        if C < W:
            # Smallest C of W via top_k on the negation.
            vals, _ = jax.lax.top_k(-packed, C)
            s_packed = -vals
        else:
            s_packed = jnp.sort(packed, axis=-1)[:, :C]
        s_prim_c = s_packed >> tid_bits
        tbl_mask = s_prim_c < big
        tbl_tid = jnp.where(tbl_mask, s_packed & ((1 << tid_bits) - 1), 0)
        tbl_score = jnp.where(tbl_mask, (score_bound + 1) - s_prim_c, 0)
    else:
        s_prim, s_tid, s_score = jax.lax.sort((prim, tid, score), num_keys=2)
        tbl_mask = s_prim[:, :C] < big
        tbl_tid = jnp.where(tbl_mask, s_tid[:, :C], 0)
        tbl_score = jnp.where(tbl_mask, s_score[:, :C], 0)

    n_cand = jnp.sum(meets.astype(jnp.int32), axis=1)
    stats = {"candidate_spilled": jnp.sum(jnp.maximum(n_cand - C, 0))}
    return MatchResult(tid=tbl_tid, score=tbl_score, mask=tbl_mask, stats=stats)


def combine_k_tables(
    tid_parts: Sequence[jnp.ndarray],
    score_parts: Sequence[jnp.ndarray],
    mask_parts: Sequence[jnp.ndarray],
    *,
    candidate_capacity: int,
    score_bound: int,
    num_transcripts: int = 0,
) -> MatchResult:
    """Combine K per-k top-C candidate tables into the forall-k result.

    Reference semantics (/root/reference/src/sparse_chaining.cpp:83-105):
    a transcript is a candidate iff it passes the per-k fraction
    threshold for EVERY k — vacuously for a k where the read has no
    events at all (max count 0) — and its score is the sum of its per-k
    counts.  Each per-k K=1 table has already applied its own threshold
    (and a k with no events yields an empty table), so the combine is a
    pure set intersection + score addition over K*C lanes:

      - per-k tables sort by tid (invalid lanes -> sentinel),
      - a bitonic merge tree (payload = score) produces one tid-sorted
        row per read,
      - a tid meets iff its run length equals the read's number of
        NON-VACUOUS ks; its score is the run's score sum,
      - top-C selection as in row_events_to_candidates.

    This replaces the K-wide event grouping for K > 1 on single-device
    paths, whose K-coupling cost time per batch on the accelerator the
    design was first tuned on (scripts/profile_multik_stages.py) —
    intersecting C-wide pre-grouped tables does the same work over ~4x
    fewer lanes with the cheap K=1 grouping branch.  The only capacity difference:
    per-k passing sets truncate at the per-k table capacity BEFORE the
    intersection (the old path truncated after); spills are counted
    per k, never silent, and callers size the per-k capacity at 2*C.
    """
    K = len(tid_parts)
    B = tid_parts[0].shape[0]
    # Per-k tier windows give per-k tables different capacities; pad to
    # a common pow2 width (sentinel keys / zero scores are inert).
    Ck = _next_pow2(max(t.shape[1] for t in tid_parts))
    pad = lambda x, fill: (
        x
        if x.shape[1] == Ck
        else jnp.concatenate(
            [x, jnp.full((B, Ck - x.shape[1]), fill, x.dtype)], axis=1
        )
    )
    tid_parts = [pad(t, 0) for t in tid_parts]
    score_parts = [pad(s, 0) for s in score_parts]
    mask_parts = [pad(m, False) for m in mask_parts]
    keys = [
        jnp.where(m, t, _I32_MAX) for t, m in zip(tid_parts, mask_parts)
    ]
    scores = [jnp.where(m, s, 0) for s, m in zip(score_parts, mask_parts)]
    level = [jax.lax.sort((k_, s), num_keys=1) for k_, s in zip(keys, scores)]
    if K & (K - 1) == 0 and Ck & (Ck - 1) == 0 and K > 1:
        while len(level) > 1:
            level = [
                _merge_sorted_pair_payload(*level[i], *level[i + 1])
                for i in range(0, len(level), 2)
            ]
        key, sc = level[0]
    elif K > 1:
        key, sc = jax.lax.sort(
            (jnp.concatenate(keys, axis=1), jnp.concatenate(scores, axis=1)),
            num_keys=1,
        )
    else:
        key, sc = level[0]
    W = key.shape[1]
    valid = key != _I32_MAX
    i_idx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    prev = _shift_right(key, jnp.int32(-1))
    nxt = _shift_left(key, _I32_MAX - 1)
    is_start = valid & (key != prev)
    is_end = valid & (key != nxt)
    start_pos = jax.lax.cummax(jnp.where(is_start, i_idx, -1), axis=1)
    run_len = i_idx - start_pos + 1
    # Scores are >= 0, so the cumsum is nondecreasing and a cummax
    # propagates each run's base (same trick as the event grouping).
    c_sc = jnp.cumsum(sc, axis=1)
    base = jax.lax.cummax(jnp.where(is_start, _shift_right(c_sc, jnp.int32(0)), 0), axis=1)
    run_score = c_sc - base
    k_req = sum(jnp.any(m, axis=1).astype(jnp.int32) for m in mask_parts)
    meets = is_end & (run_len == k_req[:, None])
    return _top_c_select(
        meets,
        jnp.where(valid, key, 0),
        run_score,
        score_bound=score_bound,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
    )


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    return jnp.concatenate([jnp.full((x.shape[0], 1), fill, x.dtype), x[:, :-1]], axis=1)


def _shift_left(x: jnp.ndarray, fill) -> jnp.ndarray:
    return jnp.concatenate([x[:, 1:], jnp.full((x.shape[0], 1), fill, x.dtype)], axis=1)


def row_events_to_candidates(
    keym: jnp.ndarray,
    *,
    num_k: int,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int = 0,
) -> MatchResult:
    """Group packed event keys row-wise into per-read top-C candidates.

    keym: [B, W] int32 packed keys tid*K + k (sentinel INT32_MAX), any
    lane order (sorted here) — or a sequence of per-k [B, w] parts,
    which sort independently and bitonic-merge (sort_event_parts):
    identical grouping input, fewer comparator passes at K > 1.

    num_transcripts (optional): when the transcript count is small enough
    that (rank, tid) packs into 31 bits, the top-C selection runs as a
    single-operand row sort instead of a 3-operand lexicographic sort.
    """
    if isinstance(keym, (list, tuple)):
        keym = sort_event_parts(keym)
    else:
        keym = jnp.sort(keym, axis=-1)
    B, W = keym.shape
    K = num_k
    C = candidate_capacity
    i_idx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    valid = keym != _I32_MAX
    prev = _shift_right(keym, jnp.int32(-1))
    nxt = _shift_left(keym, _I32_MAX - 1)
    is_start = valid & (keym != prev)
    is_end = valid & (keym != nxt)

    # Count of each (tid, k) run, available at its END lane.
    start_pos = jax.lax.cummax(jnp.where(is_start, i_idx, -1), axis=1)
    cnt_end = i_idx - start_pos + 1

    tid = keym // K

    p, q = _fraction_compare_params(chain_fraction)
    if K == 1:
        # Every run IS a tid group: the count is live at the run's end
        # lane; no cumsum/base machinery needed at all.
        ck = jnp.where(is_end, cnt_end, 0)
        maxc = jnp.max(ck, axis=1)  # [B]
        if q > 0:
            ok = ck * q >= maxc[:, None] * p
        else:
            ok = ck.astype(jnp.float32) >= jnp.float32(chain_fraction) * maxc[
                :, None
            ].astype(jnp.float32)
        meets = is_end & ok
        score = ck
    else:
        # Multi-k grouping in a FIXED number of row passes (the previous
        # form ran 3 passes PER k over the K-times-wider rows — O(K^2)
        # lane work).  A tid's <= K runs are adjacent after the
        # sort, so the forall-k rule becomes group-level run accounting:
        #   - per-run threshold verdict at its END lane, with each k's
        #     global max selected in (not cumsum'd): ok_run,
        #   - group passes iff (every run in it passes) AND (it has a
        #     run for every k whose global max is nonzero) — a k with
        #     max 0 passes vacuously (0 >= f*0, reference semantics:
        #     src/sparse_chaining.cpp:83-105), and no run for it can
        #     exist anyway,
        # computed with THREE shared cumsums (runs, passing runs, score)
        # + cummax-propagated group bases.
        kid = keym - tid * K
        maxk = [
            jnp.max(jnp.where(is_end & (kid == ki), cnt_end, 0), axis=1)
            for ki in range(K)
        ]  # [B] per k
        mk = jnp.broadcast_to(maxk[0][:, None], (B, W))
        for ki in range(1, K):
            mk = jnp.where(kid == ki, maxk[ki][:, None], mk)
        if q > 0:
            ok_run = is_end & (cnt_end * q >= mk * p)
        else:
            ok_run = is_end & (
                cnt_end.astype(jnp.float32)
                >= jnp.float32(chain_fraction) * mk.astype(jnp.float32)
            )
        # Number of ks a read must cover: those with nonzero global max.
        k_required = sum((m > 0).astype(jnp.int32) for m in maxk)  # [B]

        tprev = _shift_right(tid, jnp.int32(-1))
        tnxt = _shift_left(tid, _I32_MAX)
        is_tstart = valid & (tid != tprev)
        is_tend = valid & (tid != tnxt)

        c_runs = jnp.cumsum(is_end.astype(jnp.int32), axis=1)
        c_ok = jnp.cumsum(ok_run.astype(jnp.int32), axis=1)
        c_cnt = jnp.cumsum(jnp.where(is_end, cnt_end, 0), axis=1)

        def _group_base(c):
            # Base = cumulative value just before the group's first lane;
            # cumulative rows are nondecreasing, so a cummax over
            # (is_tstart ? shifted c : 0) propagates each group's base to
            # all its lanes with no gather.
            pre = _shift_right(c, jnp.int32(0))
            return jax.lax.cummax(jnp.where(is_tstart, pre, 0), axis=1)

        n_runs = c_runs - _group_base(c_runs)
        n_ok = c_ok - _group_base(c_ok)
        score = c_cnt - _group_base(c_cnt)
        meets = (
            is_tend
            & (n_ok == n_runs)
            & (n_runs == k_required[:, None])
        )

    # Top-C by (score desc, tid asc): one more row sort (scores count
    # window lanes, so W bounds them).
    return _top_c_select(
        meets,
        tid,
        score,
        score_bound=W,
        candidate_capacity=C,
        num_transcripts=num_transcripts,
    )


def group_parts_per_k(
    parts: Sequence[jnp.ndarray],
    *,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int = 0,
) -> MatchResult:
    """Group K > 1 per-k event windows via per-k K=1 grouping + table
    intersection (combine_k_tables).

    parts: per-k [B, w] PURE-TID event keys (expansion with k_index=0,
    num_k=1).  Each part groups with the cheap K=1 branch into a per-k
    top-Ck table (Ck = min(2*C, w): a window of w lanes holds at most w
    distinct tids, and 2*C headroom keeps pre-intersection truncation
    out of range of the final C); the tables then intersect with score
    addition.  Replaces the K-wide event grouping and its K-coupling
    (scripts/profile_multik_stages.py).
    """
    res_ks = [
        row_events_to_candidates(
            p,
            num_k=1,
            chain_fraction=chain_fraction,
            candidate_capacity=min(2 * candidate_capacity, _next_pow2(p.shape[1])),
            num_transcripts=num_transcripts,
        )
        for p in parts
    ]
    res = combine_k_tables(
        [r.tid for r in res_ks],
        [r.score for r in res_ks],
        [r.mask for r in res_ks],
        candidate_capacity=candidate_capacity,
        score_bound=sum(p.shape[1] for p in parts),
        num_transcripts=num_transcripts,
    )
    res.stats["candidate_spilled"] = res.stats["candidate_spilled"] + sum(
        r.stats["candidate_spilled"] for r in res_ks
    )
    return res


def _group_tier_parts(
    parts: Sequence[jnp.ndarray],
    *,
    num_k: int,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int = 0,
    per_k_tables: bool = True,
) -> MatchResult:
    """Dispatch: K=1 -> direct grouping; K>1 -> per-k + intersection, or
    (per_k_tables=False) the merged K-wide event grouping, which only
    truncates the FINAL candidate set — the engines' exact fallback when
    a per-k table spills pre-intersection (PARITY.md deviation 7).

    parts carry PURE-TID keys; the merged mode packs them (tid*K + k)
    the way the K-wide grouping expects."""
    if num_k == 1:
        return row_events_to_candidates(
            parts[0],
            num_k=1,
            chain_fraction=chain_fraction,
            candidate_capacity=candidate_capacity,
            num_transcripts=num_transcripts,
        )
    if not per_k_tables:
        packed = [
            jnp.where(p != _I32_MAX, p * num_k + ki, _I32_MAX)
            for ki, p in enumerate(parts)
        ]
        return row_events_to_candidates(
            packed,
            num_k=num_k,
            chain_fraction=chain_fraction,
            candidate_capacity=candidate_capacity,
            num_transcripts=num_transcripts,
        )
    return group_parts_per_k(
        parts,
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
    )


# Sixteenths of the batch per tier (rows sorted ascending by event
# count).  Round 3 refined the old (12, 3, 1) plan to five rank tiers:
# the median read produces ~7 events while high-rank reads need
# hundreds of lanes, so finer rank quantiles cut total padded lanes
# 88.7M -> 58.4M at GENCODE scale (match scan 1.13 -> 0.90 s; a sixth
# tier measured no further gain — the calibrated widths merge).
TIER_FRACS16 = (6, 4, 3, 2, 1)


def pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def tier_plan(
    B: int,
    events_per_read: int,
    tier_widths: Tuple[int, ...] = (8, 16, 64),
) -> Tuple[Tuple[int, int], ...]:
    """Static event-window tiers: ((rows, window), ...) covering B batch
    rows, assuming rows are sorted ascending by per-read event count.

    The median read produces ~6-12 posting events per k while the window
    must be sized for the ambiguous tail (hundreds on isoform families);
    rank-sized windows over TIER_FRACS16 cut the expanded lanes ~6-10x
    vs a flat events_per_read window.  tier_widths supplies the
    len(TIER_FRACS16)-1 non-tail windows — use calibrate_tier_widths so
    they cover the dataset's actual per-rank event counts (then spills
    can only occur in the full-budget tail tier, exactly like a flat
    window).  Adjacent tiers with equal widths merge; the tail tier
    always gets the full budget.
    """
    if B < 1024:
        return ((B, events_per_read),)
    widths = [min(w, events_per_read) for w in tier_widths]
    widths = widths[: len(TIER_FRACS16) - 1]
    while len(widths) < len(TIER_FRACS16) - 1:
        widths.append(widths[-1] if widths else events_per_read)
    widths.append(events_per_read)
    rows = [(B * f) // 16 for f in TIER_FRACS16[:-1]]
    rows.append(B - sum(rows))
    plan: List[Tuple[int, int]] = []
    for r, w in zip(rows, widths):
        if plan and plan[-1][1] >= w:
            plan[-1] = (plan[-1][0] + r, max(plan[-1][1], w))
        else:
            plan.append((r, w))
    return tuple(plan)


def calibrate_tier_widths(
    sorted_totals: "np.ndarray",
    B: int,
    events_per_read: int,
    margin: float = 1.5,
) -> Tuple[int, ...]:
    """Pick the non-tail tier windows from a sample of per-read event
    totals so each tier covers its rank range with headroom.

    sorted_totals: ascending per-read max-per-k event counts from a
    sample batch (host array).  The window for tier t is
    pow2ceil(margin * totals[rank of tier t's upper boundary]) — the
    pow2 rounding plus margin absorbs batch-to-batch quantile noise, and
    any residual spill is counted and triggers the caller's exact
    flat-window fallback.
    """
    n = int(sorted_totals.shape[0])
    if n == 0:
        return (8, 16, 64)[: len(TIER_FRACS16) - 1]
    widths: List[int] = []
    cum = 0
    floor = 8
    for f in TIER_FRACS16[:-1]:
        cum += f
        q = int(sorted_totals[max((n * cum) // 16 - 1, 0)])
        w = min(max(pow2ceil(int(q * margin)), floor), events_per_read)
        widths.append(w)
        floor = w
    return tuple(widths)


def tier_rows(B: int) -> Tuple[int, ...]:
    """The fixed TIER_FRACS16 row partition (no width-based merging —
    used by the per-k width mode, where merges would differ per k)."""
    rows = [(B * f) // 16 for f in TIER_FRACS16[:-1]]
    rows.append(B - sum(rows))
    return tuple(rows)


def calibrate_tier_widths_per_k(
    totals_sorted_per_k: "np.ndarray",
    B: int,
    events_per_read: int,
    margin: float = 1.5,
) -> Tuple[Tuple[int, ...], ...]:
    """Per-k tier windows from a sample batch.

    totals_sorted_per_k: [K, n] per-k posting-event totals, EACH ROW
    independently ascending (each k's tier pipeline sorts batch rows by
    its OWN totals, so its rank quantiles calibrate exactly like a
    single-k run).

    Why per-k: the shared-width calibration sizes every k's window to
    the max over ks, so one ambiguous k (k=21 at GENCODE) inflates every
    other k's expansion lanes, and a shared-permutation variant couldn't
    shrink them (max-in-range over the shared order reproduced the
    max-over-k widths; scripts/profile_match_ablate.py).  The tail tier keeps the
    FULL per-read budget: a calibrated tail turns every rare heavy read
    outside the sample batch into a pretail spill -> whole-dataset flat
    rerun; tail drops instead mean the budget
    itself is too small, which the expansion-doubling retry handles.
    """
    eprs = _epr_per_k(events_per_read, totals_sorted_per_k.shape[0])
    return tuple(
        calibrate_tier_widths(totals_sorted_per_k[ki], B, eprs[ki], margin)
        + (eprs[ki],)
        for ki in range(totals_sorted_per_k.shape[0])
    )


def _is_per_k_widths(tier_widths) -> bool:
    return bool(tier_widths) and isinstance(tier_widths[0], (tuple, list))


def _epr_per_k(events_per_read, K: int) -> Tuple[int, ...]:
    """Normalize an int-or-per-k expansion budget to a K-tuple."""
    if isinstance(events_per_read, (tuple, list)):
        return tuple(events_per_read)
    return (events_per_read,) * K


def shared_tier_widths(tier_widths):
    """Collapse per-k widths (incl. tail) to the shared no-tail form
    (max over ks per tier) for consumers that require equal per-k
    windows: the sharded engines (shard-merged event grouping) and any
    flat-tuple API."""
    if not _is_per_k_widths(tier_widths):
        return tier_widths
    n = len(tier_widths[0])
    return tuple(max(w[t] for w in tier_widths) for t in range(n - 1))


def _row_match_per_k_tiered(
    starts: Sequence[jnp.ndarray],
    lens: Sequence[jnp.ndarray],
    postings: Sequence[jnp.ndarray],
    *,
    num_k: int,
    events_per_read: int,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int,
    tier_widths: Tuple[Tuple[int, ...], ...],
) -> Tuple[MatchResult, jnp.ndarray]:
    """K > 1 tiered match as K INDEPENDENT single-k pipelines + one
    table intersection.

    Each k sorts batch rows by its OWN event totals, expands with its
    OWN calibrated tier windows, and groups with the cheap K=1 branch
    into a [B, Ck] top-candidate table; the per-k permutations then
    invert on those small tables (K gathers) and combine_k_tables
    intersects them in original row order.  This makes per-k work
    genuinely linear in K — a shared permutation provably can't (its
    rank ranges mix the ks, so every window re-inflates to the
    max-over-k; scripts/profile_match_ablate.py round 5).

    Returns (result IN ORIGINAL ROW ORDER, identity perm).
    """
    B = starts[0].shape[0]
    K = num_k
    C = candidate_capacity
    eprs = _epr_per_k(events_per_read, K)
    Ck = min(2 * C, _next_pow2(max(eprs)))
    tbl_t, tbl_s, tbl_m = [], [], []
    drops = []
    pretail = jnp.zeros((), jnp.int32)
    spilled = jnp.zeros((), jnp.int32)
    for ki in range(K):
        plan = tier_plan(B, eprs[ki], tier_widths[ki])
        totals = jnp.sum(lens[ki], axis=1)
        perm_k = jnp.argsort(totals).astype(jnp.int32)
        s_p = jnp.take(starts[ki], perm_k, axis=0)
        l_p = jnp.take(lens[ki], perm_k, axis=0)
        row0 = 0
        dk = jnp.zeros((), jnp.int32)
        tp, sp_, mp = [], [], []
        for t_i, (rows, w) in enumerate(plan):
            s_t = jax.lax.slice_in_dim(s_p, row0, row0 + rows, axis=0)
            l_t = jax.lax.slice_in_dim(l_p, row0, row0 + rows, axis=0)
            key, d = row_expand_from_runs(
                s_t, l_t, postings[ki], events_per_read=w, k_index=0, num_k=1
            )
            dk = dk + d
            if t_i < len(plan) - 1:
                pretail = pretail + d
            res = row_events_to_candidates(
                key,
                num_k=1,
                chain_fraction=chain_fraction,
                candidate_capacity=min(Ck, _next_pow2(w)),
                num_transcripts=num_transcripts,
            )
            t, s, m = res.tid, res.score, res.mask
            if t.shape[1] < Ck:
                padw = Ck - t.shape[1]
                t = jnp.pad(t, ((0, 0), (0, padw)))
                s = jnp.pad(s, ((0, 0), (0, padw)))
                m = jnp.pad(m, ((0, 0), (0, padw)))
            tp.append(t)
            sp_.append(s)
            mp.append(m)
            spilled = spilled + res.stats["candidate_spilled"]
            row0 += rows
        inv = jnp.argsort(perm_k).astype(jnp.int32)
        tbl_t.append(jnp.take(jnp.concatenate(tp), inv, axis=0))
        tbl_s.append(jnp.take(jnp.concatenate(sp_), inv, axis=0))
        tbl_m.append(jnp.take(jnp.concatenate(mp), inv, axis=0))
        drops.append(dk)
    result = combine_k_tables(
        tbl_t,
        tbl_s,
        tbl_m,
        candidate_capacity=C,
        score_bound=sum(eprs),
        num_transcripts=num_transcripts,
    )
    result.stats["candidate_spilled"] = (
        result.stats["candidate_spilled"] + spilled
    )
    result.stats["expand_dropped"] = jnp.stack(drops)
    result.stats["expand_dropped_pretail"] = pretail
    return result, jnp.arange(B, dtype=jnp.int32)


def row_match_runs_tiered(
    starts: Sequence[jnp.ndarray],
    lens: Sequence[jnp.ndarray],
    postings: Sequence[jnp.ndarray],
    *,
    num_k: int,
    events_per_read: int,
    chain_fraction: float,
    candidate_capacity: int,
    num_transcripts: int = 0,
    tier_widths: Tuple[int, ...] = (8, 16, 64),
    per_k_tables: bool = True,
) -> Tuple[MatchResult, jnp.ndarray]:
    """Tiered expand+group: sort batch rows by their max per-k event
    count, then give each tier a window sized to its rank (tier_plan).

    starts/lens: per-k [B, S] posting-run arrays from the index probe.
    Returns (MatchResult with ROWS PERMUTED by ascending event count,
    perm) — callers that need original read order apply argsort(perm);
    the EM/assignment paths treat reads as an unordered bag and skip it.

    stats carry "expand_dropped" per k (as the flat path does) plus
    "expand_dropped_pretail": drops in any tier EXCEPT the full-budget
    tail.  Pretail drops mean the calibrated widths under-covered this
    dataset — the caller falls back to the flat window for exactness;
    tail drops would occur identically under a flat window.
    """
    B = starts[0].shape[0]
    K = num_k
    C = candidate_capacity
    per_k = _is_per_k_widths(tier_widths)
    if per_k and B >= 1024 and K > 1 and per_k_tables:
        return _row_match_per_k_tiered(
            starts,
            lens,
            postings,
            num_k=K,
            events_per_read=events_per_read,
            chain_fraction=chain_fraction,
            candidate_capacity=C,
            num_transcripts=num_transcripts,
            tier_widths=tier_widths,
        )
    if per_k:
        tier_widths = shared_tier_widths(tier_widths)
    eprs = _epr_per_k(events_per_read, K)
    events_per_read = max(eprs)
    plan = tier_plan(B, events_per_read, tier_widths)

    if len(plan) == 1:
        # Expansion emits PURE-TID keys (k_index=0, num_k=1): K=1 needs
        # no packing, and K>1 groups per k + intersects (_group_tier_parts).
        parts, drops = [], []
        for ki in range(K):
            key, d = row_expand_from_runs(
                starts[ki],
                lens[ki],
                postings[ki],
                events_per_read=eprs[ki],
                k_index=0,
                num_k=1,
            )
            parts.append(key)
            drops.append(d)
        result = _group_tier_parts(
            parts,
            num_k=K,
            chain_fraction=chain_fraction,
            candidate_capacity=C,
            num_transcripts=num_transcripts,
            per_k_tables=per_k_tables,
        )
        result.stats["expand_dropped"] = jnp.stack(drops)
        result.stats["expand_dropped_pretail"] = jnp.zeros((), jnp.int32)
        return result, jnp.arange(B, dtype=jnp.int32)

    totals = [jnp.sum(l, axis=1) for l in lens]
    tier_key = totals[0]
    for t in totals[1:]:
        tier_key = jnp.maximum(tier_key, t)
    perm = jnp.argsort(tier_key).astype(jnp.int32)
    starts_p = [jnp.take(s, perm, axis=0) for s in starts]
    lens_p = [jnp.take(l, perm, axis=0) for l in lens]

    tid_parts, score_parts, mask_parts = [], [], []
    drops = [jnp.zeros((), jnp.int32) for _ in range(K)]
    pretail = jnp.zeros((), jnp.int32)
    spilled = jnp.zeros((), jnp.int32)
    row0 = 0
    for t_i, (rows, w) in enumerate(plan):
        parts = []
        for ki in range(K):
            s_t = jax.lax.slice_in_dim(starts_p[ki], row0, row0 + rows, axis=0)
            l_t = jax.lax.slice_in_dim(lens_p[ki], row0, row0 + rows, axis=0)
            key, d = row_expand_from_runs(
                s_t, l_t, postings[ki], events_per_read=w, k_index=0, num_k=1
            )
            parts.append(key)
            drops[ki] = drops[ki] + d
            if t_i < len(plan) - 1:
                pretail = pretail + d
        res = _group_tier_parts(
            parts,
            num_k=K,
            chain_fraction=chain_fraction,
            candidate_capacity=C,
            num_transcripts=num_transcripts,
            per_k_tables=per_k_tables,
        )
        t, s, m = res.tid, res.score, res.mask
        if t.shape[1] < C:
            padw = C - t.shape[1]
            t = jnp.pad(t, ((0, 0), (0, padw)))
            s = jnp.pad(s, ((0, 0), (0, padw)))
            m = jnp.pad(m, ((0, 0), (0, padw)))
        tid_parts.append(t)
        score_parts.append(s)
        mask_parts.append(m)
        spilled = spilled + res.stats["candidate_spilled"]
        row0 += rows

    result = MatchResult(
        tid=jnp.concatenate(tid_parts),
        score=jnp.concatenate(score_parts),
        mask=jnp.concatenate(mask_parts),
        stats={
            "candidate_spilled": spilled,
            "expand_dropped": jnp.stack(drops),
            "expand_dropped_pretail": pretail,
        },
    )
    return result, perm


def row_match(
    sketch_hashes: Sequence[jnp.ndarray],
    sketch_masks: Sequence[jnp.ndarray],
    index_keys: Sequence[jnp.ndarray],
    index_row_ptr: Sequence[jnp.ndarray],
    index_postings: Sequence[jnp.ndarray],
    *,
    chain_fraction: float,
    events_per_read: int,
    candidate_capacity: int,
    num_transcripts: int = 0,
    per_k_tables: bool = True,
) -> MatchResult:
    """Full row-parallel match against a local (replicated) index."""
    K = len(sketch_hashes)
    eprs = _epr_per_k(events_per_read, K)
    parts, drops = [], []
    for ki in range(K):
        key, d = row_expand_events(
            sketch_hashes[ki],
            sketch_masks[ki],
            index_keys[ki],
            index_row_ptr[ki],
            index_postings[ki],
            events_per_read=eprs[ki],
            k_index=0,
            num_k=1,
        )
        parts.append(key)
        drops.append(d)
    result = _group_tier_parts(
        parts,
        num_k=K,
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        per_k_tables=per_k_tables,
    )
    result.stats["expand_dropped"] = jnp.stack(drops)
    return result
