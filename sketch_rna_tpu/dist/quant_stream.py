"""Streaming multi-chip quant: scan-chunked shard_map with a bounded
per-device class buffer.

The original sharded step (quant_sharded.py, kept as the correctness
reference) holds the ENTIRE read set as one [B, L] sharded array — at
50M x 150bp that alone blows HBM.  This engine
feeds [nb, B, L] chunk stacks instead and keeps device memory flat:

  program 1 (stream_sharded_scan):  per device-shard, a lax.scan over
    read chunks — sketch, probe the LOCAL hash-range index shard,
    tier-windowed expansion (tier keys are GLOBAL event totals, psum'd
    over the index axis, so every index replica sorts reads
    identically), all_gather of event lanes across the index axis,
    grouping into candidate tables, and append-with-compaction into a
    fixed [m_cap, C] equivalence-class buffer (exact, as in stream.py).
    Ends with a final compaction; emits the buffer plus replicated
    scalar stats (pmax/psum over the mesh).

  host: ONE scalar sync -> static narrow width W and class-row bound
    M_pad for program 2.

  program 2 (em_assign_sharded): per device, slice the buffer to
    [M_pad, W] and run the EM while_loop + soft assignment with
    per-iteration psum over the data axis.  Outputs fully replicated.

Memory: O(chunk + m_cap) per device at any read count.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sketch_rna_tpu.em.classes import group_candidate_rows_meta, tier_partition
from sketch_rna_tpu.em.em import run_em_assign_partitioned
from sketch_rna_tpu.match.lookup import lookup_postings
from sketch_rna_tpu.match.rowmatch import (
    row_events_to_candidates,
    row_expand_from_runs,
    tier_plan,
)
from sketch_rna_tpu.sketch.dispatch import sketch_all_k


def _match_chunk_sharded(
    codes,
    lengths,
    lkeys,
    lrp,
    lpost,
    *,
    kmer_lengths,
    sketch_fraction,
    sketch_caps,
    chain_fraction,
    expand_per_read,
    candidate_capacity,
    num_transcripts,
    match_tiers,
    tier_widths,
):
    """One chunk on one (data, index) device: local-shard matching with
    the cross-shard event merge.  Returns (tid, score, mask, drops[K],
    spilled, sk_ov[K], pretail)."""
    Bl = codes.shape[0]
    K = len(kmer_lengths)
    C = candidate_capacity

    starts, lens, sk_ovs = [], [], []
    for ki, (h, m, ov) in enumerate(
        sketch_all_k(
            codes, lengths, kmer_lengths, sketch_fraction, sketch_caps,
        )
    ):
        sk_ovs.append(ov)
        st, ln = lookup_postings(h, m, lkeys[ki], lrp[ki])
        starts.append(st)
        lens.append(ln)

    plan = (
        tier_plan(Bl, expand_per_read, tier_widths)
        if match_tiers
        else ((Bl, expand_per_read),)
    )
    if len(plan) > 1:
        # Tier key = GLOBAL per-read event totals (psum over the index
        # axis): argsort of an identical key is identical on every index
        # replica, so the per-tier row slices stay read-aligned across
        # shards for the lane all_gather below.
        tier_key = None
        for ln in lens:
            t = jax.lax.psum(jnp.sum(ln, axis=1), "index")
            tier_key = t if tier_key is None else jnp.maximum(tier_key, t)
        perm = jnp.argsort(tier_key).astype(jnp.int32)
        starts = [jnp.take(s, perm, axis=0) for s in starts]
        lens = [jnp.take(l, perm, axis=0) for l in lens]

    tid_parts, score_parts, mask_parts = [], [], []
    drops = [jnp.zeros((), jnp.int32) for _ in range(K)]
    pretail = jnp.zeros((), jnp.int32)
    spilled = jnp.zeros((), jnp.int32)
    row0 = 0
    for t_i, (rows, w) in enumerate(plan):
        parts = []
        for ki in range(K):
            s_t = jax.lax.slice_in_dim(starts[ki], row0, row0 + rows, axis=0)
            l_t = jax.lax.slice_in_dim(lens[ki], row0, row0 + rows, axis=0)
            key, d = row_expand_from_runs(
                s_t, l_t, lpost[ki], events_per_read=w, k_index=ki, num_k=K
            )
            parts.append(key)
            drops[ki] = drops[ki] + d
            if t_i < len(plan) - 1:
                pretail = pretail + d
        keym = jnp.concatenate(parts, axis=1) if K > 1 else parts[0]
        # Merge partial events across index shards along the lane axis.
        keym = jax.lax.all_gather(keym, "index", axis=1, tiled=True)
        # Re-split into the (shard, k) parts so grouping can use per-part
        # sorts + bitonic merges (identical row multiset either way).
        n_parts = keym.shape[1] // parts[0].shape[1]
        res = row_events_to_candidates(
            jnp.split(keym, n_parts, axis=1) if n_parts > 1 else keym,
            num_k=K,
            chain_fraction=chain_fraction,
            candidate_capacity=C,
            num_transcripts=num_transcripts,
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

    if len(tid_parts) == 1:
        tid, score, mask = tid_parts[0], score_parts[0], mask_parts[0]
    else:
        tid = jnp.concatenate(tid_parts)
        score = jnp.concatenate(score_parts)
        mask = jnp.concatenate(mask_parts)
    return tid, score, mask, drops, spilled, sk_ovs, pretail


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "kmer_lengths",
        "sketch_fraction",
        "sketch_caps",
        "chain_fraction",
        "expand_per_read",
        "candidate_capacity",
        "num_transcripts",
        "match_tiers",
        "tier_widths",
        "m_cap",
        "narrow_width",
        "mid_width",
    ),
)
def stream_sharded_scan(
    codes_all: jnp.ndarray,  # [nb, B, L] uint8, B divisible by data axis
    lengths_all: jnp.ndarray,  # [nb, B] int32
    keys: Tuple[jnp.ndarray, ...],  # per-k [n_index, U_pad] uint32
    row_ptr: Tuple[jnp.ndarray, ...],
    postings: Tuple[jnp.ndarray, ...],
    *,
    mesh: Mesh,
    kmer_lengths: Tuple[int, ...],
    sketch_fraction: float,
    sketch_caps: Tuple[int, ...],
    chain_fraction: float,
    expand_per_read: int,
    candidate_capacity: int,
    num_transcripts: int,
    match_tiers: bool = True,
    tier_widths: Tuple[int, ...] = (8, 16, 64),
    m_cap: int = 1 << 17,
    narrow_width: int = 4,
    mid_width: int = 8,
):
    """Program 1: chunked match into per-device class buffers.

    Returns (buf_tid [dp*m_cap, C] data-sharded, buf_score, buf_weight,
    scalars [11] replicated, dropped [K], sk_ov [K]).  scalars =
    (ncm, fill_max, pretail, spilled, class_ov) plus the mesh-max tier
    counts of the final compacted buffers — (wide_all, wide_excl_mid,
    mid, tail1, multi_fold, multi_nofold) with tiers bounded by
    narrow_width/mid_width — from which the host sizes program 2's
    static per-shard tier partition (pipeline.quantify_sharded).
    """
    K = len(kmer_lengths)
    C = candidate_capacity

    def body(codes_nb, lengths_nb, keys_s, rp_s, post_s):
        Bl = codes_nb.shape[1]
        lkeys = [a[0] for a in keys_s]
        lrp = [a[0] for a in rp_s]
        lpost = [a[0] for a in post_s]

        def compact(bt, bs, bw):
            rep, w, scal = group_candidate_rows_meta(bt, bs, row_weight=bw)
            return bt[rep], bs[rep], w, scal[0]

        def chunk_step(carry, batch):
            bt, bs, bw, fl, dropped, spilled, sk_ov, pretail, ncm, class_ov = carry
            codes, lengths = batch
            tid, score, mask, drops, spill, sk_ovs, ptail = _match_chunk_sharded(
                codes,
                lengths,
                lkeys,
                lrp,
                lpost,
                kmer_lengths=kmer_lengths,
                sketch_fraction=sketch_fraction,
                sketch_caps=sketch_caps,
                chain_fraction=chain_fraction,
                expand_per_read=expand_per_read,
                candidate_capacity=C,
                num_transcripts=num_transcripts,
                match_tiers=match_tiers,
                tier_widths=tier_widths,
            )
            score = jnp.where(mask, score, 0)
            bt, bs, bw, fl = jax.lax.cond(
                fl + Bl > m_cap,
                lambda a: compact(a[0], a[1], a[2]),
                lambda a: a,
                (bt, bs, bw, fl),
            )
            can_fit = fl + Bl <= m_cap
            start = jnp.minimum(fl, m_cap - Bl)

            def append(a):
                bt, bs, bw, fl = a
                bt = jax.lax.dynamic_update_slice(bt, tid, (start, jnp.int32(0)))
                bs = jax.lax.dynamic_update_slice(bs, score, (start, jnp.int32(0)))
                bw = jax.lax.dynamic_update_slice(bw, jnp.ones(Bl, jnp.int32), (start,))
                return bt, bs, bw, fl + Bl

            bt, bs, bw, fl = jax.lax.cond(
                can_fit, append, lambda a: a, (bt, bs, bw, fl)
            )
            n_cand = jnp.max(jnp.sum(mask.astype(jnp.int32), axis=1))
            carry = (
                bt,
                bs,
                bw,
                fl,
                dropped + jnp.stack(drops).astype(jnp.int32),
                spilled + spill.astype(jnp.int32),
                sk_ov + jnp.stack(sk_ovs).astype(jnp.int32),
                pretail + ptail.astype(jnp.int32),
                jnp.maximum(ncm, n_cand).astype(jnp.int32),
                class_ov
                + jnp.where(
                    can_fit, jnp.int32(0), jnp.sum(lengths > 0, dtype=jnp.int32)
                ),
            )
            return carry, None

        zero = (
            jnp.zeros((m_cap, C), jnp.int32),
            jnp.zeros((m_cap, C), jnp.int32),
            jnp.zeros(m_cap, jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros(K, jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros(K, jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
        )
        (bt, bs, bw, fl, dropped, spilled, sk_ov, pretail, ncm, class_ov), _ = (
            jax.lax.scan(chunk_step, zero, (codes_nb, lengths_nb))
        )
        # Final compaction bounds program 2's class-row count.
        bt, bs, bw, fl = compact(bt, bs, bw)

        # Replicated scalar reductions (index replicas agree on
        # everything except index-local drop counters).
        def _psum2(x):
            return jax.lax.psum(jax.lax.psum(x, "index"), "data")

        def _pmax2(x):
            return jax.lax.pmax(jax.lax.pmax(x, "index"), "data")

        # Per-shard tier counts of the compacted classes (n_cand is
        # width-independent: columns past every real candidate are 0).
        # Each derived count is computed per shard THEN maxed, so the
        # host's static pads bound every shard's true tier size.
        n_cand = jnp.sum(bs > 0, axis=1)
        live = bw > 0

        def _cnt(m):
            return jnp.sum(m & live, dtype=jnp.int32)

        n_cls = _cnt(jnp.ones_like(live))
        wide_all = _cnt(n_cand > narrow_width)
        midc = _cnt((n_cand > narrow_width) & (n_cand <= mid_width))
        tail1 = _cnt(n_cand <= 1)
        multi_nofold = n_cls - wide_all
        scalars = jnp.stack(
            [
                _pmax2(ncm),
                _pmax2(fl),
                _psum2(pretail),
                # Spill/class counters are index-replicated: max over
                # index (identical), sum over data.
                jax.lax.psum(jax.lax.pmax(spilled, "index"), "data"),
                jax.lax.psum(jax.lax.pmax(class_ov, "index"), "data"),
                _pmax2(wide_all),
                _pmax2(wide_all - midc),
                _pmax2(midc),
                _pmax2(tail1),
                _pmax2(multi_nofold - tail1),
                _pmax2(multi_nofold),
            ]
        )
        dropped = _psum2(dropped)
        sk_ov = jax.lax.psum(jax.lax.pmax(sk_ov, "index"), "data")
        return bt, bs, bw, scalars, dropped, sk_ov

    in_specs = (
        P(None, "data", None),
        P(None, "data"),
        tuple(P("index", None) for _ in range(K)),
        tuple(P("index", None) for _ in range(K)),
        tuple(P("index", None) for _ in range(K)),
    )
    out_specs = (
        P("data", None),
        P("data", None),
        P("data"),
        P(),
        P(),
        P(),
    )
    return jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )(codes_all, lengths_all, keys, row_ptr, postings)


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "num_transcripts",
        "m_pad",
        "width",
        "em_max_iterations",
        "em_convergence",
        "pseudocount",
        "em_epsilon",
        "em_dtype",
        "use_segsum",
        "nm_pad",
        "nmid_pad",
        "nw_pad",
        "narrow_width",
        "mid_width",
        "split",
        "fold",
    ),
)
def em_assign_sharded(
    buf_tid: jnp.ndarray,  # [dp*m_cap, C] data-sharded class buffers
    buf_score: jnp.ndarray,
    buf_weight: jnp.ndarray,
    num_reads: jnp.ndarray,
    *,
    mesh: Mesh,
    num_transcripts: int,
    m_pad: int,
    width: int,
    em_max_iterations: int = 20,
    em_convergence: float = 0.01,
    pseudocount: float = 0.01,
    em_epsilon: float = 1e-10,
    em_dtype: str = "float32",
    use_segsum: bool = False,
    nm_pad: int = 0,
    nmid_pad: int = 0,
    nw_pad: int = 0,
    narrow_width: int = 4,
    mid_width: int = 8,
    split: bool = False,
    fold: bool = False,
):
    """Program 2: EM + assignment over the compacted class buffers.

    m_pad/width and the tier pads come from the one host sync of
    program 1's scalars (mesh-max counts, so every shard's tiers fit);
    each device tiers ITS OWN [m_pad, width] buffer with
    em.classes.tier_partition — narrow/mid/wide loop tables plus the
    folded-singleton static base — then the EM/assignment psum over the
    data axis totals the per-shard bases exactly once.  With
    split=fold=False (nm_pad=0) this degrades to the single flat table.
    Weight-0 rows are inert throughout."""

    def body(bt, bs, bw, R):
        t = jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(bt, 0, m_pad, axis=0), 0, width, axis=1
        )
        sc = jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(bs, 0, m_pad, axis=0), 0, width, axis=1
        )
        w = jax.lax.slice_in_dim(bw, 0, m_pad)
        if split or fold:
            tables, static_base, static_has = tier_partition(
                t,
                sc,
                w,
                nm_pad=nm_pad,
                nmid_pad=nmid_pad,
                nw_pad=nw_pad,
                narrow_width=narrow_width,
                mid_width=mid_width,
                out_width=width,
                split=split,
                fold=fold,
                num_transcripts=num_transcripts,
            )
        else:
            tables, static_base, static_has = ((t, sc, w),), None, None
        pi, iters, weighted, has_entry = run_em_assign_partitioned(
            tables,
            R,
            num_transcripts=num_transcripts,
            max_iterations=em_max_iterations,
            convergence_threshold=em_convergence,
            pseudocount=pseudocount,
            epsilon=em_epsilon,
            dtype=em_dtype,
            axis_name="data",
            use_segsum=use_segsum,
            static_base=static_base,
            static_has=static_has,
        )
        return pi, iters, weighted, has_entry

    in_specs = (P("data", None), P("data", None), P("data"), P())
    out_specs = (P(), P(), P(), P())
    return jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )(buf_tid, buf_score, buf_weight, num_reads)
