"""Bounded-memory streaming quantification.

The fused path retains every read's [N, C] candidate table on device,
which caps datasets at a few million reads.  This
module streams arbitrarily many reads through a FIXED [m_cap, C] class
buffer instead, mirroring the reference's single-pass streaming intent
(process_fastq_single_pass, /root/reference/src/main.cpp:107-151) at
device batch granularity:

  - a lax.scan matches each super-chunk's batches, then the SAME
    program groups the chunk's rows into weighted equivalence classes
    (chunk pre-dedup: identical candidate profiles collapse, exact
    because EM posteriors of identical profiles are identical), so only
    the chunk's DISTINCT profiles append to the class buffer;
  - when a block wouldn't fit, the buffer is COMPACTED device-side
    inside the append program (em/classes.py group metadata +
    representative gather — no host syncs on the per-chunk path);
  - EM + assignment then run over the final compacted classes, so
    device memory is O(m_cap) and host memory is one chunk, regardless
    of read count.

The buffer capacity bounds DISTINCT candidate profiles held on device
at once, a property of transcriptome ambiguity, not dataset size
(measured: 131k-read bench collapses to ~3k classes; GENCODE-scale
multi-k stays < 100k).  When a dataset's class count approaches the
buffer anyway, the host DRAINS the compacted classes between
super-chunks (config.stream_drain, default on) and the drained
segments re-merge into global weighted classes before the EM — exact
at any distinct-class count.  Only a single super-chunk whose own
distinct classes exceed the buffer can still drop, per-class, counted
in stats["class_overflow"] — never silent.  (The sharded multi-device
engine, dist/quant_stream.py, keeps per-device buffers inside one
shard_map program and does not drain.)
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Iterable, Iterator, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.em.classes import group_candidate_rows_meta
from sketch_rna_tpu.index.artifact import IndexArtifact
from sketch_rna_tpu.io.packing import Packed2Reads, PackedReads, unpack_codes2

log = logging.getLogger(__name__)


@partial(jax.jit, static_argnames=("L",))
def _unpack2(codes2: jnp.ndarray, L: int) -> jnp.ndarray:
    return unpack_codes2(codes2, L)


def stream_retry_config(config: QuantConfig, stats: dict):
    """Pick the exactness-recovery config for nonzero overflow stats.

    Returns (new_config, reason) or (None, "").  Shared by
    quantify_streamed (replayable PackedReads feeds rerun internally)
    and the CLI (which re-scans iterator feeds and retries).  Ordering:
    pretail drops first (the flat rerun also re-evaluates the others),
    then full-budget expansion drops (doubled window, bounded by
    pipeline.EXPAND_RETRY_MAX), then wide-class spill (single
    full-width buffer — no wide side buffer, so no spill possible).
    """
    import dataclasses

    from sketch_rna_tpu.pipeline import EXPAND_RETRY_MAX

    if config.match_tiers and stats.get("expand_dropped_pretail", 0) > 0:
        return (
            dataclasses.replace(config, match_tiers=False),
            "dropped %d pretail events -> flat windows"
            % stats["expand_dropped_pretail"],
        )
    epr_max = max(config.expand_per_read_k or (config.expand_per_read,))
    if stats.get("expand_dropped", 0) > 0 and epr_max < EXPAND_RETRY_MAX:
        # Streaming stats sum drops over ks, so the retry doubles the
        # global budget (the fused engine's early sync keeps per-k drops
        # and doubles per k instead).
        epr = min(2 * max(epr_max, config.expand_per_read), EXPAND_RETRY_MAX)
        return (
            dataclasses.replace(
                config, expand_per_read=epr, expand_per_read_k=None
            ),
            "expansion budget dropped %d events -> expand_per_read=%d"
            % (stats["expand_dropped"], epr),
        )
    if (
        stats.get("candidate_spilled", 0) > 0
        and config.match_per_k_tables
        and len(config.kmer_lengths) > 1
    ):
        return (
            dataclasses.replace(config, match_per_k_tables=False),
            "candidate table spilled %d lanes under per-k grouping -> "
            "merged K-wide grouping" % stats["candidate_spilled"],
        )
    if stats.get("wide_spilled", 0) > 0 and config.stream_narrow_width > 0:
        return (
            dataclasses.replace(config, stream_narrow_width=0),
            "wide class buffer spilled %d reads -> single full-width buffer"
            % stats["wide_spilled"],
        )
    return None, ""


def _tier_widths_dev(
    codes_dev, lengths_dev, config, bpacked, bucket_meta, caps, ks, L, packed_len,
    n_real=None,
):
    """Tier/probe calibration from an already-uploaded first batch
    (device-resident variant of pipeline._tier_widths_for — the sample
    fetch here is deliberately the process's first D2H).

    n_real: the chunk's real (unpadded) read count; with fewer than
    1024 real reads the sample rows are mostly zero-length padding and
    would calibrate skewed-small widths, so return the defaults
    (matching pipeline._tier_widths_for's guard)."""
    from sketch_rna_tpu.pipeline import (
        _event_totals_sorted,
        _probe_width_from,
        _widths_from_sample,
    )

    default = ((8, 16, 64), None)
    B = codes_dev.shape[0]
    if not config.match_tiers or B < 1024:
        return default
    if n_real is not None and min(n_real, B) < 1024:
        return default
    codes = codes_dev if packed_len is None else _unpack2(codes_dev, packed_len)
    sample = np.asarray(
        _event_totals_sorted(
            codes,
            lengths_dev,
            bpacked,
            kmer_lengths=ks,
            sketch_fraction=config.sketch_fraction,
            sketch_caps=caps,
            bucket_meta=bucket_meta,
        )
    )
    widths, sc = _widths_from_sample(sample, len(ks), config)
    probe_w = _probe_width_from(sc, caps)
    log.info("calibrated tier widths %s probe width %s", widths, probe_w)
    return widths, probe_w


@partial(
    jax.jit,
    static_argnames=(
        "kmer_lengths",
        "sketch_fraction",
        "sketch_caps",
        "chain_fraction",
        "expand_per_read",
        "candidate_capacity",
        "bucket_meta",
        "num_transcripts",
        "match_tiers",
        "tier_widths",
        "probe_width",
        "match_per_k_tables",
        "narrow_width",
        "wide_capacity",
    ),
)
def chunk_match_classes(
    codes_all: jnp.ndarray,  # [nb, B, L] uint8
    lengths_all: jnp.ndarray,  # [nb, B] int32
    index_packed: Tuple[jnp.ndarray, ...],
    index_postings: Tuple[jnp.ndarray, ...],
    *,
    kmer_lengths: Tuple[int, ...],
    sketch_fraction: float,
    sketch_caps: Tuple[int, ...],
    chain_fraction: float,
    expand_per_read: int,
    candidate_capacity: int,
    bucket_meta: Tuple[Tuple[int, int], ...],
    num_transcripts: int = 0,
    match_tiers: bool = True,
    tier_widths: Tuple[int, ...] = (8, 16, 64),
    probe_width: Optional[int] = None,
    match_per_k_tables: bool = True,
    narrow_width: int = 0,
    wide_capacity: int = 0,
):
    """Match one super-chunk and PRE-DEDUP it into weighted classes.

    Full-buffer compaction per chunk, and the host fill syncs that gated
    it, once dominated the 32M-read run.  Grouping each chunk's own
    rows here (one [nb*B]-row sort, async, inside the same program as
    the matching) collapses the appended rows to the chunk's DISTINCT
    profiles, so the shared buffer fills several times slower and its
    compactions move off the per-chunk path entirely (they now run
    device-side inside _append_chunk, no host sync).  Grouping composes
    with row weights, so chunk-level pre-dedup is exact (same argument
    as the drain re-merge below).

    With narrow_width == 0, returns (blk_tid [nb*B, C], blk_score,
    blk_weight, n_cls, n_cand_max, stats) where rows past n_cls are
    zeroed with weight 0 (inert: they join the all-zero class, adding
    zero weight).

    With narrow_width > 0 (the dual-buffer layout), classes split by
    candidate count so the big running buffer stays narrow_width lanes
    wide (4x less HBM and compaction work at C=64; class rows are
    rank-ordered, so slicing a <=narrow_width class is lossless):
      - narrow block [nb*B, narrow_width]: classes with <= narrow_width
        candidates at their original rows; wide classes' rows zeroed
        with weight 0 (inert, reclaimed by the next compact),
      - wide block [wide_capacity, C]: the (rare) wider classes gathered
        to the front; spill past wide_capacity is counted
        (stats["wide_spilled"], reads) — never silent.
    Returns (nb_tid, nb_score, nb_weight, n_cls, bw_tid, bw_score,
    bw_weight, n_wide, n_cand_max, stats).
    """
    from sketch_rna_tpu.pipeline import sketch_match_step

    nb, B, L = codes_all.shape
    K = len(kmer_lengths)

    def body(carry, batch):
        dropped, spilled, sk_ov, pretail, ncm = carry
        codes, lengths = batch
        tid, score, mask, stats = sketch_match_step(
            codes,
            lengths,
            index_packed,
            index_postings,
            kmer_lengths=kmer_lengths,
            sketch_fraction=sketch_fraction,
            sketch_caps=sketch_caps,
            chain_fraction=chain_fraction,
            expand_per_read=expand_per_read,
            candidate_capacity=candidate_capacity,
            bucket_meta=bucket_meta,
            num_transcripts=num_transcripts,
            match_tiers=match_tiers,
            tier_widths=tier_widths,
            probe_width=probe_width,
            match_per_k_tables=match_per_k_tables,
        )
        score = jnp.where(mask, score, 0)
        n_cand = jnp.max(jnp.sum(mask.astype(jnp.int32), axis=1))
        carry = (
            dropped + stats["expand_dropped"].astype(jnp.int32),
            spilled + stats["candidate_spilled"].astype(jnp.int32),
            sk_ov + stats["sketch_overflow"].astype(jnp.int32),
            pretail + stats["expand_dropped_pretail"].astype(jnp.int32),
            jnp.maximum(ncm, n_cand).astype(jnp.int32),
        )
        return carry, (tid, score)

    zero = (
        jnp.zeros(K, jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros(K, jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
    )
    (dropped, spilled, sk_ov, pretail, ncm), (tids, scores) = jax.lax.scan(
        body, zero, (codes_all, lengths_all)
    )
    C = tids.shape[-1]
    blk_tid = tids.reshape(nb * B, C)
    blk_score = scores.reshape(nb * B, C)
    rep, w, scal = group_candidate_rows_meta(blk_tid, blk_score)
    n_cls = scal[0]
    live = jnp.arange(nb * B, dtype=jnp.int32) < n_cls
    blk_tid = jnp.where(live[:, None], blk_tid[rep], 0)
    blk_score = jnp.where(live[:, None], blk_score[rep], 0)
    blk_weight = jnp.where(live, w, 0)
    stats = {
        "expand_dropped": dropped,
        "candidate_spilled": spilled,
        "sketch_overflow": sk_ov,
        "expand_dropped_pretail": pretail,
    }
    if narrow_width <= 0 or narrow_width >= C:
        return blk_tid, blk_score, blk_weight, n_cls, ncm, stats

    n_cand = jnp.sum(blk_score > 0, axis=1)
    is_live = blk_weight > 0
    wide = is_live & (n_cand > narrow_width)
    keep_n = is_live & jnp.logical_not(wide)
    nb_tid = jnp.where(keep_n[:, None], blk_tid[:, :narrow_width], 0)
    nb_score = jnp.where(keep_n[:, None], blk_score[:, :narrow_width], 0)
    nb_weight = jnp.where(keep_n, blk_weight, 0)
    # Wide classes to the front (stable: False sorts first, wide = not).
    wide_capacity = min(wide_capacity, nb * B)
    wperm = jnp.argsort(jnp.logical_not(wide), stable=True).astype(jnp.int32)
    wsel = jax.lax.slice_in_dim(wperm, 0, wide_capacity)
    wlive = wide[wsel]
    bw_tid = jnp.where(wlive[:, None], blk_tid[wsel], 0)
    bw_score = jnp.where(wlive[:, None], blk_score[wsel], 0)
    bw_weight = jnp.where(wlive, blk_weight[wsel], 0)
    n_wide_all = jnp.sum(wide.astype(jnp.int32)).astype(jnp.int32)
    n_wide = jnp.minimum(n_wide_all, wide_capacity).astype(jnp.int32)
    stats["wide_spilled"] = (
        jnp.sum(jnp.where(wide, blk_weight, 0)) - jnp.sum(bw_weight)
    ).astype(jnp.int32)
    return (
        nb_tid, nb_score, nb_weight, n_cls,
        bw_tid, bw_score, bw_weight, n_wide,
        ncm, stats,
    )


@partial(jax.jit, static_argnames=("m_cap",), donate_argnums=(0, 1, 2))
def _append_chunk(
    buf_tid: jnp.ndarray,  # [m_cap, C] int32 (donated)
    buf_score: jnp.ndarray,  # [m_cap, C] int32 (donated)
    buf_weight: jnp.ndarray,  # [m_cap] int32 (donated)
    fill: jnp.ndarray,  # [] int32
    blk_tid: jnp.ndarray,  # [cap_c, C] pre-deduped chunk classes
    blk_score: jnp.ndarray,
    blk_weight: jnp.ndarray,
    n_cls: jnp.ndarray,  # [] int32 live rows in the block
    *,
    m_cap: int,
):
    """Append a pre-deduped chunk block into the running class buffer.

    Compacts the buffer device-side first if the block wouldn't fit —
    no host sync on this path.  When even the compacted buffer cannot
    hold the block's padded rows wholly, the block's LIVE classes append
    individually via a masked row scatter: only the classes past the
    buffer's end are dropped, their read weight counted (class_overflow,
    never silent).  With stream_drain on (default), the caller's drain
    logic keeps this branch unreachable; with it off, drops are
    per-class, finer than the raw per-batch granularity the pre-dedup
    replaced.  Returns (buf..., fill, class_ov).
    """
    cap_c = blk_tid.shape[0]

    bt, bs, bw, fl = jax.lax.cond(
        fill + cap_c > m_cap,
        lambda a: _compact_classes(a[0], a[1], a[2]),
        lambda a: a,
        (buf_tid, buf_score, buf_weight, fill),
    )

    can_fit = fl + cap_c <= m_cap
    start = jnp.minimum(fl, m_cap - cap_c)

    def append(a):
        bt, bs, bw, fl = a
        bt = jax.lax.dynamic_update_slice(bt, blk_tid, (start, jnp.int32(0)))
        bs = jax.lax.dynamic_update_slice(bs, blk_score, (start, jnp.int32(0)))
        bw = jax.lax.dynamic_update_slice(bw, blk_weight, (start,))
        return bt, bs, bw, fl + n_cls, jnp.int32(0)

    def append_partial(a):
        # Live rows sit at block rows [0, n_cls); scatter those that fit
        # to buffer rows [fl, m_cap) and drop the rest (weight counted).
        bt, bs, bw, fl = a
        lane = jnp.arange(cap_c, dtype=jnp.int32)
        idx = fl + lane
        ok = (lane < n_cls) & (idx < m_cap)
        idxc = jnp.where(ok, idx, m_cap)  # out-of-range -> dropped
        bt = bt.at[idxc].set(blk_tid, mode="drop")
        bs = bs.at[idxc].set(blk_score, mode="drop")
        bw = bw.at[idxc].set(blk_weight, mode="drop")
        dropped_w = jnp.sum(
            jnp.where((lane < n_cls) & (idx >= m_cap), blk_weight, 0)
        ).astype(jnp.int32)
        return bt, bs, bw, jnp.minimum(fl + n_cls, m_cap).astype(jnp.int32), dropped_w

    bt, bs, bw, fl, class_ov = jax.lax.cond(
        can_fit, append, append_partial, (bt, bs, bw, fl)
    )
    return bt, bs, bw, fl, class_ov


@partial(jax.jit, donate_argnums=(0, 1, 2))
def _compact_classes(buf_tid, buf_score, buf_weight):
    """Compact the class buffer: identical candidate profiles collapse
    into weighted classes occupying rows [0, n_classes); rows past
    n_classes duplicate row content with weight 0 (inert).  Shared by
    the in-scan compaction and the host-drain precheck.  Returns
    (tid, score, weight, n_classes)."""
    rep, w, scalars = group_candidate_rows_meta(
        buf_tid, buf_score, row_weight=buf_weight
    )
    return buf_tid[rep], buf_score[rep], w, scalars[0]


class _ClassBuffer:
    """A running device class buffer with lazy fill accounting + drains.

    Holds [m_cap, width] tid/score tables and [m_cap] weights.  The host
    tracks an upper bound on the fill in two parts: fill_base (synced
    class counts) + pending (appended blocks whose true class count
    hasn't been read — each bounded by its padded block rows until its
    old device scalar is read, which rarely stalls since the host runs
    ahead of the device).  The bound therefore grows at the
    DISTINCT-profile rate, and the exact-fill sync (which drains the
    dispatch queue) runs only when distinct classes genuinely crowd the
    buffer.  When even a compacted buffer can't host an incoming block,
    the compacted classes drain to the host and re-merge before the EM
    (exact; weight-composing grouping).
    """

    def __init__(self, m_cap: int, width: int, drain: bool):
        self.m_cap = m_cap
        self.width = width
        self.drain = drain
        self.tid = jnp.zeros((m_cap, width), jnp.int32)
        self.score = jnp.zeros((m_cap, width), jnp.int32)
        self.weight = jnp.zeros(m_cap, jnp.int32)
        self.fill = jnp.zeros((), jnp.int32)
        self.fill_base = 0
        self.pending = []  # [(n_cls device scalar, block rows)]
        self.drained = []  # host (tid, score, weight) compacted segments

    def ensure_room(self, incoming: int, tag: str) -> None:
        if not self.drain:
            return
        if self.fill_base + sum(c for _, c in self.pending) + incoming <= self.m_cap:
            return
        self.fill_base += sum(int(np.asarray(nc)) for nc, _ in self.pending)
        self.pending.clear()
        log.info("%s bound trip: fill_base=%d (+%d incoming)",
                 tag, self.fill_base, incoming)
        if self.fill_base + incoming <= self.m_cap:
            return
        # fill_base over-counts whatever in-append device compaction
        # already reclaimed; sync the exact fill before compact/drain.
        fill_h = int(np.asarray(self.fill))
        if fill_h + incoming > self.m_cap:
            self.tid, self.score, self.weight, self.fill = _compact_classes(
                self.tid, self.score, self.weight
            )
            fill_h = int(np.asarray(self.fill))
            log.info("%s compact -> fill=%d", tag, fill_h)
        if fill_h + incoming > self.m_cap and fill_h > 0:
            log.info("%s drain: %d rows to host", tag, fill_h)
            self.drained.append(
                (
                    np.asarray(self.tid[:fill_h]),
                    np.asarray(self.score[:fill_h]),
                    np.asarray(self.weight[:fill_h]),
                )
            )
            self.tid = jnp.zeros((self.m_cap, self.width), jnp.int32)
            self.score = jnp.zeros((self.m_cap, self.width), jnp.int32)
            self.weight = jnp.zeros(self.m_cap, jnp.int32)
            self.fill = jnp.zeros((), jnp.int32)
            self.fill_base = 0
        else:
            self.fill_base = fill_h

    def append(self, blk_tid, blk_score, blk_weight, n_cls):
        """Returns the class_overflow scalar (device)."""
        self.tid, self.score, self.weight, self.fill, ov = _append_chunk(
            self.tid, self.score, self.weight, self.fill,
            blk_tid, blk_score, blk_weight, n_cls, m_cap=self.m_cap,
        )
        self.pending.append((n_cls, blk_tid.shape[0]))
        return ov

    def merged(self, W: int):
        """Final (tid [:, :W'], score, weight) with drained segments
        re-merged incrementally (W' = min(W, width)); exact at any
        distinct-class count (grouping composes with row weights)."""
        W = min(W, self.width)
        if not self.drained:
            # Slice to a pow2 row bound over the true fill: grouping the
            # full m_cap rows costs real sort/hash work on dead zeros
            # (the sync here is free — the caller just synced stats).
            fill_h = int(np.asarray(self.fill))
            rows = min(self.m_cap, max(1 << max(fill_h - 1, 0).bit_length(), 1024))
            return (
                self.tid[:rows, :W],
                self.score[:rows, :W],
                self.weight[:rows],
            )
        # Concatenating every segment at full width first OOMs HBM at
        # 32M-read scale; merge the running result with ONE segment at a
        # time (host-narrowed to W columns), regroup, compact.  Peak
        # device memory is |merged| + |segment| rows at width W.
        fill_h = int(np.asarray(self.fill))
        log.info(
            "stream drain re-merge: %d segments (%d classes) + %d live rows",
            len(self.drained),
            sum(d[0].shape[0] for d in self.drained),
            fill_h,
        )
        m_t = jax.lax.slice_in_dim(self.tid[:fill_h], 0, W, axis=1)
        m_s = jax.lax.slice_in_dim(self.score[:fill_h], 0, W, axis=1)
        m_w = self.weight[:fill_h]
        n_live = fill_h
        for d_t, d_s, d_w in self.drained:
            d_t = np.asarray(d_t)[:, :W]
            d_s = np.asarray(d_s)[:, :W]
            n_tot = n_live + d_t.shape[0]
            n_pad = 1 << max(n_tot - 1, 0).bit_length()
            t = jnp.concatenate([m_t, jnp.asarray(d_t)])
            s = jnp.concatenate([m_s, jnp.asarray(d_s)])
            w = jnp.concatenate([m_w, jnp.asarray(np.asarray(d_w))])
            if n_pad > n_tot:
                # pad rows join the all-zero class, weight 0 (inert)
                t = jnp.pad(t, ((0, n_pad - n_tot), (0, 0)))
                s = jnp.pad(s, ((0, n_pad - n_tot), (0, 0)))
                w = jnp.pad(w, (0, n_pad - n_tot))
            rep, wgt, scal = group_candidate_rows_meta(t, s, row_weight=w)
            n_cls = int(np.asarray(scal)[0])
            sel = jax.lax.slice_in_dim(rep, 0, n_cls)
            m_t = t[sel]
            m_s = s[sel]
            m_w = jax.lax.slice_in_dim(wgt, 0, n_cls)
            n_live = n_cls
        log.info("stream drain merged to %d global classes", n_live)
        return m_t, m_s, m_w


def _chunks_of(
    packed_or_iter: Union[PackedReads, Iterable[PackedReads]],
    chunk_reads: int,
) -> Iterator[PackedReads]:
    """Slice the input into super-chunks of at most chunk_reads reads.
    Iterator feeds are re-sliced too, so the device-side chunk size is
    decoupled from the parser's packing granularity (the drain logic
    relies on one chunk never exceeding the class buffer)."""

    def slices(p) -> Iterator[PackedReads]:
        if p.num_reads <= chunk_reads:
            yield p
            return
        for r0 in range(0, p.num_reads, chunk_reads):
            r1 = min(r0 + chunk_reads, p.num_reads)
            if isinstance(p, Packed2Reads):
                yield Packed2Reads(p.codes2[r0:r1], p.lengths[r0:r1], p.pad_len)
            else:
                yield PackedReads(p.codes[r0:r1], p.lengths[r0:r1], [])

    if isinstance(packed_or_iter, PackedReads):
        yield from slices(packed_or_iter)
    else:
        for p in packed_or_iter:
            yield from slices(p)


def quantify_streamed(
    index: IndexArtifact,
    reads: Union[PackedReads, Iterable[PackedReads]],
    config: Optional[QuantConfig] = None,
    num_reads_hint: Optional[int] = None,
):
    """Full quant over a read stream with O(m_cap) device memory.

    reads: a PackedReads (sliced into super-chunks internally) or an
    iterator of PackedReads chunks (the chunked-parser feed — host packs
    chunk c+1 while the device matches chunk c, since dispatch is
    async).  num_reads_hint (iterator feeds) lets the class buffer stay
    no larger than the dataset.  Returns the same QuantResult as
    pipeline.quantify.
    """
    from sketch_rna_tpu.pipeline import (
        QuantResult,
        _device_index,
        _em_tables,
        _empty_result,
        _run_em,
    )
    from sketch_rna_tpu.em.em import (
        assign_reads_partitioned,
        resolve_em_segsum,
        run_em_assign_partitioned,
    )
    from sketch_rna_tpu.utils.timing import PhaseTimer

    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    timer = PhaseTimer()
    ks = tuple(index.kmer_lengths)
    B = config.batch_size
    C = config.candidate_capacity

    def _feed_plan():
        """(known_R, m_cap, eff_chunk) — deterministic host arithmetic.

        Resolving known_R may JOIN a LazyScanFeed's background record
        scan, so this is called lazily (from the prefetch worker and
        after index_prep) rather than up front: the scan then overlaps
        the index upload instead of serializing before it.
        """
        if isinstance(reads, PackedReads):
            known_R = reads.num_reads
        elif num_reads_hint is not None:
            known_R = num_reads_hint
        elif hasattr(reads, "num_reads"):
            known_R = reads.num_reads
        else:
            known_R = None
        m_cap = max(config.stream_class_capacity, 2 * B)
        if known_R is not None:
            # Known row count: the buffer never needs many more rows
            # than reads.  +1024 headroom covers the extra classes chunk
            # padding rows can form (an all-zero profile per partial
            # chunk).
            m_cap = min(
                m_cap, max(((known_R + 1023) // 1024) * 1024 + 1024, 2 * B)
            )
        eff_chunk = min(config.stream_chunk_reads, (m_cap // B) * B)
        if config.stream_drain:
            eff_chunk = min(eff_chunk, max(((m_cap - B) // B) * B, B))
        return known_R, m_cap, eff_chunk

    # Prefetch the feed's first chunk on a worker: the host-side record
    # scan + first pack overlap the index upload below.
    from concurrent.futures import ThreadPoolExecutor

    _prefetch_state = {}

    def _prefetch_first():
        _, _, eff_chunk = _feed_plan()
        it = _chunks_of(reads, eff_chunk)
        _prefetch_state["iter"] = it
        return next(it, None)

    _prefetch_ex = ThreadPoolExecutor(max_workers=1)
    first_fut = _prefetch_ex.submit(_prefetch_first)
    _prefetch_ex.shutdown(wait=False)

    with timer.phase("index_prep"):
        bpacked, postings, bucket_meta = _device_index(index, ks)
    with timer.phase("feed_plan"):
        # May block on the tail of a LazyScanFeed's record scan (the
        # part the index upload didn't cover).
        known_R, m_cap, eff_chunk = _feed_plan()
    T = index.num_transcripts

    # Dual-buffer layout (stream_narrow_width > 0 and < C): the big
    # running buffer holds classes at narrow_width lanes (4x less HBM
    # and compaction work than C=64; lossless — class rows are
    # rank-ordered, so a <=narrow_width class has only zero lanes past
    # it), while the rare wider classes land in a small full-width side
    # buffer.  Their class populations are disjoint by construction
    # (candidate count), so grouping/EM-table building runs per buffer
    # and the tier tables simply concatenate.
    nw = int(config.stream_narrow_width)
    dual = 0 < nw < C
    wcap = min(1 << 16, m_cap) if dual else 0  # per-chunk wide-class rows
    buf = _ClassBuffer(m_cap, nw if dual else C, config.stream_drain)
    # The wide side buffer is bounded by the known row count like the
    # narrow one (wide classes are a subset of all classes, so m_cap is
    # a valid bound) — tiny streamed runs otherwise paid a fixed
    # [2^18, C] footprint (~134 MB at C=64).
    buf_w = (
        _ClassBuffer(min(max(1 << 18, 4 * wcap), m_cap), C, config.stream_drain)
        if dual
        else None
    )

    R = 0
    ncm_parts = []
    stats_parts = []
    widths = None
    probe_w = None
    # eff_chunk (computed in _feed_plan): with draining, the super-chunk
    # is capped so a single chunk's raw rows always fit the buffer next
    # to one in-flight batch — after a drain the in-scan append can then
    # never drop, making the streaming path exact for ANY capacity
    # >= 2*B.  A chunk's pre-deduped block has nbc*B rows and must fit
    # the buffer whole (the fast-path append is whole-block).

    def _feed_chunks():
        c = first_fut.result()
        it = _prefetch_state.get("iter")
        while c is not None:
            yield c
            c = next(it, None) if it is not None else None

    def _host_rows(chunk, cap_c):
        """Host-side [cap_c, lane] codes + [cap_c] lengths for a chunk,
        plus (logical read length L, packed_len static arg).  Packed2Reads
        ships 2-bit rows (a quarter of the transfer bytes); PackedReads
        ships raw base codes."""
        n = chunk.num_reads
        if isinstance(chunk, Packed2Reads):
            L = int(chunk.pad_len)
            codes = chunk.codes2
            pl = L
        else:
            L = int(chunk.padded_len)
            codes = chunk.codes
            pl = None
        if codes.shape[0] != cap_c:
            padded = np.zeros((cap_c, codes.shape[1]), np.uint8)
            padded[:n] = codes[:n]
            codes = padded
        lengths = np.zeros(cap_c, np.int32)
        lengths[:n] = np.asarray(chunk.lengths[:n], np.int32)
        return codes, lengths, L, pl

    def _process(codes_dev, lengths_dev, n, nbc, L, caps, pl):
        """Drain-bound accounting + match + append for one device chunk."""
        cap_c = nbc * B
        buf.ensure_room(cap_c, "stream")
        if buf_w is not None:
            buf_w.ensure_room(wcap, "stream-wide")
        if pl is not None:
            # 2-bit feed: unpack to base codes in a tiny standalone jit
            # (the [nbc, B, L] expansion is a transient freed right after
            # the match consumes it; keeping the big match program
            # unchanged preserves its compilation cache entry).
            codes_dev = _unpack2(codes_dev, pl)
        out = chunk_match_classes(
            codes_dev,
            lengths_dev,
            bpacked,
            postings,
            kmer_lengths=ks,
            sketch_fraction=config.sketch_fraction,
            sketch_caps=caps,
            chain_fraction=config.chain_fraction,
            expand_per_read=config.expand_per_read_k or config.expand_per_read,
            candidate_capacity=C,
            bucket_meta=bucket_meta,
            num_transcripts=T,
            match_tiers=config.match_tiers,
            tier_widths=widths,
            probe_width=probe_w if config.match_tiers else None,
            match_per_k_tables=config.match_per_k_tables,
            narrow_width=nw if dual else 0,
            wide_capacity=wcap,
        )
        if dual:
            (nb_tid, nb_score, nb_weight, n_cls,
             bw_tid, bw_score, bw_weight, n_wide, ncm, st) = out
            class_ov = buf.append(nb_tid, nb_score, nb_weight, n_cls)
            class_ov = class_ov + buf_w.append(bw_tid, bw_score, bw_weight, n_wide)
        else:
            blk_tid, blk_score, blk_weight, n_cls, ncm, st = out
            class_ov = buf.append(blk_tid, blk_score, blk_weight, n_cls)
        st = dict(st)
        st["class_overflow"] = class_ov
        ncm_parts.append(ncm)
        stats_parts.append(st)
        log.info("chunk %d dispatched (%d reads)", len(stats_parts) - 1, n)

    # Interleaved upload + match: each chunk's 2-bit-packed transfer is
    # enqueued right before its match, so the copy of chunk c+1 rides
    # under chunk c's match compute; the host-side pack of chunk c+1
    # overlaps too (chunks_from_scan2's background thread).
    with timer.phase("stream_match"):
        for chunk in _feed_chunks():
            n = chunk.num_reads
            if n == 0:
                continue
            R += n
            nbc = (n + B - 1) // B
            cap_c = nbc * B
            codes_h, lengths_h, L, pl = _host_rows(chunk, cap_c)
            lane = codes_h.shape[1]
            codes_dev = jax.device_put(codes_h.reshape(nbc, B, lane))
            lengths_dev = jax.device_put(lengths_h.reshape(nbc, B))
            caps = tuple(config.sketch_capacity_for(k, L) for k in ks)
            if widths is None:
                with timer.phase("calibrate"):
                    widths, probe_w = _tier_widths_dev(
                        codes_dev[0], lengths_dev[0], config, bpacked,
                        bucket_meta, caps, ks, L, pl, n_real=n,
                    )
            _process(codes_dev, lengths_dev, n, nbc, L, caps, pl)
        # The dispatch loop runs far ahead of the device; block here so
        # the phase report attributes the match queue's drain to
        # stream_match rather than to whichever sync happens next.
        jax.block_until_ready(buf.weight)

    if R == 0:
        return _empty_result(index)

    # One bulk sync for every per-chunk scalar.
    ncm_all = np.asarray(jnp.stack(ncm_parts))
    stats = {
        k: int(np.asarray(jnp.stack([s[k] for s in stats_parts]).sum(axis=0)).sum())
        for k in stats_parts[0]
    }
    retry_cfg, reason = stream_retry_config(config, stats)
    if retry_cfg is not None:
        # Exactness recoveries (mirroring the fused and sharded paths):
        # pretail drops -> flat windows; full-budget expansion drops ->
        # doubled window; wide-class spill -> single full-width buffer.
        # Iterator feeds cannot be replayed here — the CLI rebuilds the
        # feed and retries (cli.run_quant); other callers see the
        # warning + stat.
        if isinstance(reads, PackedReads):
            log.warning("streaming match %s; rerunning", reason)
            return quantify_streamed(
                index, reads, retry_cfg, num_reads_hint=num_reads_hint
            )
        log.warning(
            "streaming match %s on a non-replayable feed; the CLI "
            "re-scans and retries, other callers should rerun with the "
            "adjusted config for exact results",
            reason,
        )
    for key, v in stats.items():
        if v:
            log.warning("capacity overflow during streaming match: %s=%d", key, v)
    stats["stream_drains"] = len(buf.drained) + (
        len(buf_w.drained) if buf_w is not None else 0
    )

    W = max(int(ncm_all.max()), 1)
    W = min(1 << (W - 1).bit_length(), C)
    with timer.phase("classes"):
        all_tid, all_score, all_weight = buf.merged(W)
        tables, static_base, static_has = _em_tables(
            all_tid,
            all_score,
            config,
            row_weight=all_weight,
            num_transcripts=T,
        )
        if buf_w is not None:
            # The wide side buffer's classes are disjoint from the
            # narrow buffer's (candidate count > narrow_width), so its
            # tier tables simply concatenate onto the EM working set.
            w_tid, w_score, w_weight = buf_w.merged(W)
            tables_w, sb_w, sh_w = _em_tables(
                w_tid, w_score, config, row_weight=w_weight, num_transcripts=T
            )
            tables = tables + tables_w
            # A wide class has > narrow_width >= 1 candidates, so the
            # wide fold can never activate; merge defensively anyway.
            if sb_w is not None:
                static_base = sb_w if static_base is None else static_base + sb_w
                static_has = sh_w if static_has is None else static_has | sh_w
        jax.block_until_ready(tables[0][0])

    use_segsum = resolve_em_segsum(config.em_segsum)
    with timer.phase("em_assign"):
        if config.em_checkpoint:
            pi, iters = _run_em(tables, R, T, config, static_base=static_base)
            weighted, has_entry = assign_reads_partitioned(
                tables,
                pi,
                num_transcripts=T,
                dtype=config.em_dtype,
                use_segsum=use_segsum,
                static_base=static_base,
                static_has=static_has,
            )
        else:
            # One program for the whole tail (EM loop + assignment),
            # sharing the segsum plan between the two.
            pi, iters, weighted, has_entry = run_em_assign_partitioned(
                tables,
                jnp.asarray(R, jnp.int32),
                num_transcripts=T,
                max_iterations=config.em_max_iterations,
                convergence_threshold=config.em_convergence,
                pseudocount=config.pseudocount,
                epsilon=config.em_epsilon,
                dtype=config.em_dtype,
                use_segsum=use_segsum,
                static_base=static_base,
                static_has=static_has,
            )
        jax.block_until_ready(weighted)
    return QuantResult(
        names=list(index.names),
        pi=np.asarray(pi),
        weighted_counts=np.asarray(weighted),
        has_entry=np.asarray(has_entry),
        em_iterations=int(iters),
        num_reads=R,
        stats=stats,
        timing=timer.report(),
        lengths=np.asarray(index.lengths),
    )
