"""End-to-end orchestration: index build and quantification.

Mirrors the reference drivers (build_and_save_index src/main.cpp:56-92,
quantification src/main.cpp:165-197) with an accelerator execution shape:

  - fused path: one lax.scan device program sketches and matches every
    read batch, producing stacked [N, C] candidate tables;
  - streaming path (datasets beyond the fused HBM budget): per-batch
    programs with tables kept on device and narrowed per batch;
  - either way, identical candidate profiles collapse into weighted
    equivalence classes, the class tables split into narrow/wide
    partitions, and the EM + assignment run as jitted programs over
    those partitions (exact per-read reference math throughout).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.em.em import (
    assign_reads_partitioned,
    assign_reads_tables,
    resolve_em_segsum,
    run_em_assign_partitioned,
    run_em_partitioned,
    run_em_tables,
)
from sketch_rna_tpu.index.artifact import IndexArtifact
from sketch_rna_tpu.io.packing import PackedReads
from sketch_rna_tpu.match.bucket_lookup import (
    bucket_lookup,
    bucket_table_shape,
    build_bucket_table,
    build_bucket_table_device,
)
from sketch_rna_tpu.match.rowmatch import (
    _group_tier_parts,
    calibrate_tier_widths,
    row_events_to_candidates,
    row_expand_from_runs,
    row_match_runs_tiered,
    tier_plan,
)
from sketch_rna_tpu.em.classes import (
    build_class_tables,
    group_candidate_rows_meta,
    plan_class_tables,
)
from sketch_rna_tpu.sketch.dispatch import sketch_all_k

# NOTE: modules used inside jitted function bodies MUST be imported at
# module scope.  A lazy `import` inside a traced function initializes
# the target module's jnp-level constants DURING TRACING, which corrupts
# jit dispatch (observed as "Execution supplied N buffers but compiled
# program expected N+2" on the next differently-shaped call).

log = logging.getLogger(__name__)


def _padded_index_arrays(idx: IndexArtifact, ks: Sequence[int]):
    """Per-k (keys, row_ptr, postings) with empty indexes padded to one
    never-matching sentinel key so shapes stay non-degenerate."""
    keys, row_ptr, postings = [], [], []
    for k in ks:
        ki = idx.per_k[k]
        if ki.num_keys == 0:
            keys.append(np.array([0xFFFFFFFF], dtype=np.uint32))
            row_ptr.append(np.zeros(2, dtype=np.int32))
            postings.append(np.zeros(1, dtype=np.int32))
        else:
            keys.append(ki.keys)
            row_ptr.append(ki.row_ptr)
            postings.append(ki.postings)
    return keys, row_ptr, postings


def _device_index(idx: IndexArtifact, ks: Sequence[int]):
    """Per-k bucketed lookup tables + postings for the quant hot path.

    Returns (packed_tuple, postings_tuple, meta_tuple) where meta is the
    static per-k (shift, mb) pair for bucket_lookup.  Cached on the
    artifact instance (table construction over millions of keys is not
    free, and quantify runs warm-up + timed passes, multiple samples,
    etc. against one loaded index).
    """
    cache_key = tuple(ks)
    cache = getattr(idx, "_device_index_cache", None)
    if cache is not None and cache_key in cache:
        return cache[cache_key]

    keys, row_ptr, postings = _padded_index_arrays(idx, ks)
    packed, metas = [], []
    for i in range(len(ks)):
        # Ship the CSR arrays and build the packed probe table ON
        # DEVICE (~2.6x fewer wire bytes than the packed table at
        # GENCODE scale; bucket_lookup.build_bucket_table_device is
        # pinned equal to the host builder).  The shape decision
        # (histogram + pair-merge) stays on host — it's cheap and the
        # result is three static ints.
        nb, mb, shift = bucket_table_shape(keys[i])
        packed.append(
            build_bucket_table_device(
                jnp.asarray(keys[i]),
                jnp.asarray(np.asarray(row_ptr[i], np.int32)),
                nb=nb,
                mb=mb,
                shift=shift,
            )
        )
        metas.append((shift, mb))
    # Cache DEVICE arrays: bucket tables reach hundreds of MB at GENCODE
    # scale, so repeated quantify calls upload them once.
    result = (
        tuple(packed),
        tuple(jnp.asarray(np.asarray(p)) for p in postings),
        tuple(metas),
    )
    if cache is None:
        cache = {}
        object.__setattr__(idx, "_device_index_cache", cache)
    cache[cache_key] = result
    return result




@partial(
    jax.jit,
    static_argnames=(
        "kmer_lengths",
        "sketch_fraction",
        "sketch_caps",
        "bucket_meta",
    ),
)
def _event_totals_sorted(
    codes,
    lengths,
    index_packed,
    *,
    kmer_lengths,
    sketch_fraction,
    sketch_caps,
    bucket_meta,
):
    """Calibration sample (sketch + probe only, no expansion), one flat
    vector of (K + 1) * B entries:

      [0 .. K*B):   PER-K posting-event totals, EACH k's block
                    independently ascending — each k's tier pipeline
                    sorts rows by its own totals, so its windows
                    calibrate from its own rank quantiles
                    (rowmatch.calibrate_tier_widths_per_k).
      [K*B .. end): per-read max-per-k kept-hash counts, ascending —
                    sizes the tiered PROBE width."""
    sketches = sketch_all_k(
        codes, lengths, kmer_lengths, sketch_fraction, sketch_caps
    )
    per_k = []
    tk = None
    nk = None
    for ki, (h, m, _) in enumerate(sketches):
        shift, mb = bucket_meta[ki]
        _start, length = bucket_lookup(h, m, index_packed[ki], shift=shift, mb=mb)
        t = jnp.sum(length, axis=1)
        per_k.append(t)
        tk = t if tk is None else jnp.maximum(tk, t)
        n = jnp.sum(m.astype(jnp.int32), axis=1)
        nk = n if nk is None else jnp.maximum(nk, n)
    return jnp.concatenate([jnp.sort(t) for t in per_k] + [jnp.sort(nk)])


def _widths_from_sample(sample: np.ndarray, K: int, config):
    """Split a _event_totals_sorted vector into calibrated expansion
    widths + the probe-count sample.  K=1 keeps the shared-width
    calibration (identical behavior/shapes to previous rounds); K>1
    calibrates per-k windows including the tail
    (rowmatch.calibrate_tier_widths_per_k)."""
    from sketch_rna_tpu.match.rowmatch import calibrate_tier_widths_per_k

    B = len(sample) // (K + 1)
    sc = sample[K * B :]
    if K == 1:
        widths = calibrate_tier_widths(
            sample[:B], config.batch_size, config.expand_per_read
        )
    else:
        widths = calibrate_tier_widths_per_k(
            sample[: K * B].reshape(K, B),
            config.batch_size,
            config.expand_per_read_k or config.expand_per_read,
        )
    return widths, sc


def _probe_width_from(sorted_counts: np.ndarray, caps, margin: float = 1.25):
    """Tiered-probe window from an ascending per-read max-k kept-hash
    sample: the 15/16-rank count with margin, rounded to a lane-friendly
    multiple of 8.  None when the window wouldn't beat the flat probe.
    A single width covers every k (any per-k count <= the max-over-k
    sort key); margin absorbs batch drift, and residual spills trigger
    the exact flat fallback via expand_dropped_pretail."""
    n = int(sorted_counts.shape[0])
    if n == 0:
        return None
    q = int(sorted_counts[n - n // 16 - 1])
    w = ((int(q * margin) + 8) // 8) * 8
    if w >= max(caps):
        return None
    return w


def _tier_widths_for(index, packed, config, bpacked, bucket_meta, caps, ks, L):
    """Calibrated (small, medium) expansion tier windows plus the tiered
    probe width for this dataset.

    Samples the first batch's event totals and sizes the tier windows to
    its rank quantiles with margin (rowmatch.calibrate_tier_widths), so
    pretail spills are rare; any that still occur trigger the callers'
    exact flat-window fallback.  Cached per (packed, index, L) — repeat
    quantify calls (multi-sample, warm-up+timed benches) skip the probe.

    Returns (tier_widths, probe_width).
    """
    default = ((8, 16, 64), None)
    if not config.match_tiers or config.batch_size < 1024:
        return default
    n = min(config.batch_size, packed.num_reads)
    if n < 1024:
        return default
    ck = (
        id(index),
        L,
        tuple(ks),
        config.expand_per_read,
        config.expand_per_read_k,
        config.batch_size,
    )
    cache = getattr(packed, "_tier_width_cache", None)
    if cache is not None and ck in cache:
        return cache[ck]
    codes = jnp.asarray(packed.codes[: config.batch_size, :L])
    lengths = jnp.asarray(packed.lengths[: config.batch_size], jnp.int32)
    sample = np.asarray(
        _event_totals_sorted(
            codes,
            lengths,
            bpacked,
            kmer_lengths=ks,
            sketch_fraction=config.sketch_fraction,
            sketch_caps=caps,
            bucket_meta=bucket_meta,
        )
    )
    widths, sc = _widths_from_sample(sample, len(ks), config)
    probe_w = _probe_width_from(sc, caps)
    result = (widths, probe_w)
    if cache is None:
        cache = {}
        object.__setattr__(packed, "_tier_width_cache", cache)
    cache[ck] = result
    log.info("calibrated tier widths %s probe width %s", widths, probe_w)
    return result


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
        "restore_order",
        "tier_widths",
        "probe_width",
        "match_per_k_tables",
    ),
)
def sketch_match_step(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
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
    restore_order: bool = False,
    tier_widths: Tuple[int, ...] = (8, 16, 64),
    probe_width: Optional[int] = None,
    match_per_k_tables: bool = True,
):
    """One device batch: per-k sketching + candidate matching.

    This is the quant hot path (reference hot loops #3 and #4,
    SURVEY.md §3.2) as a single XLA program: windowed-XOR hashing, two
    short row sorts (sketch dedup), one bucket-table gather per k
    (lookup), comparison-based posting expansion, row-local grouping.

    match_tiers sorts batch rows by event count and sizes each tier's
    expansion window to its rank (rowmatch.tier_plan) — ~6x fewer
    expanded lanes.  The returned tables are then in event-count order,
    which EM/assignment (an unordered bag of reads) never notice;
    restore_order=True inverts the permutation for callers that map
    rows back to read ids.

    probe_width tiers the BUCKET PROBE the same way: sketch rows are
    sorted by their per-read kept-hash count (valid lanes are a row
    prefix, ascending-sorted sentinel-padded), the bottom 15/16 of the
    batch probes only its first probe_width sketch lanes, and the tail
    probes the full capacity.  The probe's [B, S, 3*mb] bucket-row
    gather is the single largest HBM cost at large-index scale; most
    reads use ~1/4 of the capacity lanes.  A single width covers every
    k because any read's per-k kept count is bounded by the max-over-k
    key the rows were sorted by.  Reads whose sketch outgrows the window
    (calibration drift) are counted into expand_dropped_pretail, which
    triggers the callers' exact flat fallback — never silent.
    """
    K = len(kmer_lengths)
    B = codes.shape[0]
    probe_tiered = (
        match_tiers
        and probe_width is not None
        and B >= 1024
        and probe_width < max(sketch_caps)
    )
    overflows, hs, ms = [], [], []
    for h, m, ov in sketch_all_k(
        codes, lengths, kmer_lengths, sketch_fraction, sketch_caps
    ):
        overflows.append(ov)
        hs.append(h)
        ms.append(m)

    pperm = None
    probe_spill = jnp.zeros((), jnp.int32)
    if probe_tiered:
        nval = [jnp.sum(m.astype(jnp.int32), axis=1) for m in ms]
        pkey = nval[0]
        for v in nval[1:]:
            pkey = jnp.maximum(pkey, v)
        pperm = jnp.argsort(pkey).astype(jnp.int32)
        hs = [jnp.take(h, pperm, axis=0) for h in hs]
        ms = [jnp.take(m, pperm, axis=0) for m in ms]
        B0 = B - B // 16

    starts, lens = [], []
    for ki, cap in enumerate(sketch_caps):
        shift, mb = bucket_meta[ki]
        if probe_tiered and probe_width < cap:
            w0 = probe_width
            s0, l0 = bucket_lookup(
                hs[ki][:B0, :w0], ms[ki][:B0, :w0],
                index_packed[ki], shift=shift, mb=mb,
            )
            s1, l1 = bucket_lookup(
                hs[ki][B0:, :], ms[ki][B0:, :],
                index_packed[ki], shift=shift, mb=mb,
            )
            pad = ((0, 0), (0, cap - w0))
            start = jnp.concatenate([jnp.pad(s0, pad), s1], axis=0)
            length = jnp.concatenate([jnp.pad(l0, pad), l1], axis=0)
            # Valid sketch lanes past the window: events this probe never
            # saw.  Counted into the pretail spill -> exact flat rerun.
            nv0 = jnp.sum(ms[ki][:B0].astype(jnp.int32), axis=1)
            probe_spill = probe_spill + jnp.sum(jnp.maximum(nv0 - w0, 0))
        else:
            start, length = bucket_lookup(
                hs[ki], ms[ki], index_packed[ki], shift=shift, mb=mb
            )
        starts.append(start)
        lens.append(length)

    if match_tiers:
        result, perm = row_match_runs_tiered(
            starts,
            lens,
            index_postings,
            num_k=K,
            events_per_read=expand_per_read,
            chain_fraction=chain_fraction,
            candidate_capacity=candidate_capacity,
            num_transcripts=num_transcripts,
            tier_widths=tier_widths,
            per_k_tables=match_per_k_tables,
        )
        tid, score, mask = result.tid, result.score, result.mask
        if pperm is not None:
            # Output row i came from probe-permuted row perm[i], i.e.
            # original row pperm[perm[i]].
            perm = jnp.take(pperm, perm)
        if restore_order:
            inv = jnp.argsort(perm)
            tid = jnp.take(tid, inv, axis=0)
            score = jnp.take(score, inv, axis=0)
            mask = jnp.take(mask, inv, axis=0)
        stats = dict(result.stats)
        stats["expand_dropped_pretail"] = (
            stats["expand_dropped_pretail"] + probe_spill
        )
    else:
        from sketch_rna_tpu.match.rowmatch import _epr_per_k

        eprs = _epr_per_k(expand_per_read, K)
        parts, drops = [], []
        for ki in range(K):
            key, d = row_expand_from_runs(
                starts[ki],
                lens[ki],
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
            per_k_tables=match_per_k_tables,
        )
        tid, score, mask = result.tid, result.score, result.mask
        stats = dict(result.stats)
        stats["expand_dropped"] = jnp.stack(drops)
        stats["expand_dropped_pretail"] = jnp.zeros((), jnp.int32)
    stats["sketch_overflow"] = jnp.stack(overflows)
    return tid, score, mask, stats


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
    ),
)
def match_scan(
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
):
    """Sketch + match over all batches in ONE device program (lax.scan)
    — no host roundtrips between batches.  Returns stacked candidate
    tables, the max per-read candidate count (so the caller can narrow
    the EM working width losslessly: tables are rank-ordered, row r's
    candidates occupy its first n_r lanes), and overflow stats.
    """
    K = len(kmer_lengths)

    def body(carry, batch):
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
        dropped, spilled, sk_ov, ncm, pretail = carry
        n_cand = jnp.max(jnp.sum(mask.astype(jnp.int32), axis=1))
        # jnp.sum promotes ints to the default int width (int64 under
        # x64); pin the carry to int32 either way.
        carry = (
            dropped + stats["expand_dropped"].astype(jnp.int32),
            spilled + stats["candidate_spilled"].astype(jnp.int32),
            sk_ov + stats["sketch_overflow"].astype(jnp.int32),
            jnp.maximum(ncm, n_cand).astype(jnp.int32),
            pretail + stats["expand_dropped_pretail"].astype(jnp.int32),
        )
        return carry, (tid, jnp.where(mask, score, 0))

    zero = (
        jnp.zeros(K, jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros(K, jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
    )
    (dropped, spilled, sk_ov, n_cand_max, pretail), (tids, scores) = jax.lax.scan(
        body, zero, (codes_all, lengths_all)
    )
    nb, B, C = tids.shape
    N = nb * B
    stats = {
        "expand_dropped": dropped,
        "candidate_spilled": spilled,
        "sketch_overflow": sk_ov,
        "expand_dropped_pretail": pretail,
    }
    return tids.reshape(N, C), scores.reshape(N, C), n_cand_max, stats


# Fused path engages when the padded read count stays under this bound
# (candidate tables [N, C] + pair arrays [N*C] must fit in device
# memory).  Sized for a 16 GiB device and kept, because it picks the
# route; re-deriving it from the device's memory is ROADMAP Speed item 7.
FUSED_MAX_PADDED_READS = 1 << 21

# Exactness retry bound for expansion-window overflow: on nonzero
# expand_dropped every engine doubles expand_per_read and reruns (the
# reference counts every posting of every sketch hash and never drops,
# /root/reference/src/sparse_chaining.cpp:48-73).  16384 events per
# read per k means an average posting-run length > 2000 over a read's
# ~6 sketch probes — beyond any real transcriptome; past this the drop
# is warned instead (capacity overflow log + stats).
EXPAND_RETRY_MAX = 1 << 14


@dataclasses.dataclass
class QuantResult:
    names: List[str]
    pi: np.ndarray  # [T] final EM abundances
    weighted_counts: np.ndarray  # [T] soft-assigned read counts
    has_entry: np.ndarray  # [T] bool: gets a CSV row
    em_iterations: int
    num_reads: int  # R (valid reads, incl. candidate-less)
    stats: Dict[str, int]
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    lengths: Optional[np.ndarray] = None  # [T] true transcript lengths
    # Static size accounting of the shapes the device actually processed
    # (hash windows, probe gather bytes, expansion/sort lanes, EM lanes)
    # — the inputs to bench.py's roofline model.  Host-computed from the
    # static plans; no device syncs.
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tpm(self) -> np.ndarray:
        """True TPM from the soft-assigned counts and real transcript
        lengths — the normalization the reference README promises but
        never computes (quirk Q3, SURVEY.md §7.1).  Optional extra; the
        reference-compatible columns are unchanged."""
        assert self.lengths is not None
        lens = np.maximum(self.lengths.astype(np.float64), 1.0)
        rate = self.weighted_counts / lens
        total = rate.sum()
        return rate / total * 1e6 if total > 0 else rate

    def csv_rows(self) -> List[Tuple[str, float, float]]:
        """(name, NumReads, EM_Abundance) rows in deterministic index
        order; the reference emits unordered_map order (quirk Q4)."""
        return [
            (self.names[t], float(self.weighted_counts[t]), float(self.pi[t]))
            for t in range(len(self.names))
            if self.has_entry[t]
        ]


def collect_pairs(
    index: IndexArtifact,
    packed: PackedReads,
    config: QuantConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, int]]:
    """Run sketch+match over all batches; return flat candidate pairs
    (read_row, tid, score) on the host, plus overflow stats."""
    ks = tuple(index.kmer_lengths)
    caps = tuple(config.sketch_capacity_for(k) for k in ks)
    bpacked, postings, bucket_meta = _device_index(index, ks)
    bpacked = tuple(jnp.asarray(a) for a in bpacked)
    postings = tuple(jnp.asarray(a) for a in postings)

    p_read: List[np.ndarray] = []
    p_tid: List[np.ndarray] = []
    p_score: List[np.ndarray] = []
    stats = {"expand_dropped": 0, "candidate_spilled": 0, "sketch_overflow": 0}
    B = config.batch_size
    widths, probe_w = _tier_widths_for(
        index, packed, config, bpacked, bucket_meta, caps, ks, packed.padded_len
    )
    # Dispatch all device batches first (JAX dispatch is async), then sync
    # results — overlaps device compute with host-side pair collection.
    pending = []
    for codes, lengths, row0 in packed.batches(B):
        out = sketch_match_step(
            jnp.asarray(codes),
            jnp.asarray(lengths),
            bpacked,
            postings,
            kmer_lengths=ks,
            sketch_fraction=config.sketch_fraction,
            sketch_caps=caps,
            chain_fraction=config.chain_fraction,
            expand_per_read=config.expand_per_read_k or config.expand_per_read,
            candidate_capacity=config.candidate_capacity,
            bucket_meta=bucket_meta,
            match_tiers=config.match_tiers,
            restore_order=True,
            tier_widths=widths,
            probe_width=probe_w if config.match_tiers else None,
            match_per_k_tables=config.match_per_k_tables,
        )
        pending.append((out, row0))
    if config.match_tiers:
        pretail = int(
            np.asarray(
                jnp.stack(
                    [s["expand_dropped_pretail"] for (_, _, _, s), _ in pending]
                )
            ).sum()
        )
        if pretail > 0:
            log.warning(
                "tiered match dropped %d pretail events; rerunning flat", pretail
            )
            return collect_pairs(
                index, packed, dataclasses.replace(config, match_tiers=False)
            )
    for (tid, score, mask, s), row0 in pending:
        tid = np.asarray(tid)
        score = np.asarray(score)
        mask = np.asarray(mask)
        # Padded batch rows beyond the true read count have length 0 and
        # produce no sketches hence no candidates; mask handles them.
        rows, cols = np.nonzero(mask)
        global_rows = rows + row0
        keep = global_rows < packed.num_reads
        p_read.append(global_rows[keep].astype(np.int32))
        p_tid.append(tid[rows[keep], cols[keep]])
        p_score.append(score[rows[keep], cols[keep]])
        stats["expand_dropped"] += int(np.asarray(s["expand_dropped"]).sum())
        stats["candidate_spilled"] += int(np.asarray(s["candidate_spilled"]))
        stats["sketch_overflow"] += int(np.asarray(s["sketch_overflow"]).sum())

    pr = np.concatenate(p_read) if p_read else np.zeros(0, np.int32)
    pt = np.concatenate(p_tid) if p_tid else np.zeros(0, np.int32)
    ps = np.concatenate(p_score) if p_score else np.zeros(0, np.int32)
    for key, v in stats.items():
        if v:
            log.warning("capacity overflow during matching: %s=%d", key, v)
    return pr, pt, ps, stats


def _pad_pairs(pr, pt, ps, read_capacity: int, multiple: int = 1024):
    n = pr.shape[0]
    padded = max(((n + multiple - 1) // multiple) * multiple, multiple)
    out_r = np.full(padded, read_capacity, np.int32)
    out_t = np.zeros(padded, np.int32)
    out_s = np.zeros(padded, np.int32)
    out_r[:n] = pr
    out_t[:n] = pt
    out_s[:n] = ps
    return out_r, out_t, out_s


def _empty_result(index: IndexArtifact) -> QuantResult:
    """Zero-valid-reads result, shared by every quant entry point: the
    reference would run EM over zero reads (pseudocount/0 -> inf pi) and
    emit a header-only CSV; produce the same empty output without the
    inf detour."""
    T = index.num_transcripts
    return QuantResult(
        names=list(index.names),
        pi=np.full(T, 1.0 / max(T, 1)),
        weighted_counts=np.zeros(T),
        has_entry=np.zeros(T, dtype=bool),
        em_iterations=0,
        num_reads=0,
        stats={},
        lengths=np.asarray(index.lengths),
    )


def quantify(
    index: IndexArtifact,
    packed: PackedReads,
    config: Optional[QuantConfig] = None,
) -> QuantResult:
    """Full quant: sketch -> match -> EM -> assignment (src/main.cpp:165-197).

    Uses the fused single-program device path when the dataset fits;
    falls back to streaming batches + host pair collection otherwise.
    """
    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    T = index.num_transcripts
    R = packed.num_reads

    from sketch_rna_tpu.utils.profiling import maybe_trace
    from sketch_rna_tpu.utils.timing import PhaseTimer

    if R == 0:
        return _empty_result(index)

    timer = PhaseTimer()
    B = config.batch_size
    nb = (R + B - 1) // B
    if 0 < nb * B <= FUSED_MAX_PADDED_READS:
        with maybe_trace("quant_fused"), timer.phase("quant_fused", items=R):
            result = _quantify_fused(index, packed, config, nb)
        result.timing = {**result.timing, **timer.report()}
        return result

    # Beyond the fused HBM budget: stream through the fixed class buffer
    # (stream.quantify_streamed) — O(buffer) device memory at any R.
    from sketch_rna_tpu.stream import quantify_streamed

    with maybe_trace("quant_streamed"):
        return quantify_streamed(index, packed, config)


# Classes narrower than this many candidates go to the "narrow" EM table
# (4 covers the typical unique-or-small-family read; wider profiles are
# rare enough that the wide table stays small — measured on the bench
# transcriptome: 19k classes, ~1% wider than 4).
_EM_NARROW_WIDTH = 4
# Middle tier bound: classes with 5-8 candidates get their own [*, 8]
# table instead of riding the full-width wide table (measured on the
# GENCODE-scale multi-k config: 89% of >4-candidate classes fit 8 lanes,
# cutting wide-table EM lanes ~4x).
_EM_MID_WIDTH = 8
# Width-2 tier: classes with exactly two candidates (the most common
# multi-candidate profile — ~31% of non-singleton classes measured) get
# a [*, 2] table, halving their EM lanes vs the narrow tier.
_EM_PAIR_WIDTH = 2


def _fold_ok(config: QuantConfig, num_transcripts: int) -> bool:
    """Is folding single-candidate classes out of the EM loop exact here?

    A folded singleton assumes its E-step denominator pi[t]*count always
    exceeds em_epsilon (posterior exactly 1, src/isoform_assignment.cpp:
    38-47).  Iteration 1 sees pi0 = 1/T, so denom >= 1/T — covered by
    T * epsilon < 1.  Every later pi[t] >= pseudocount (> epsilon when
    epsilon < pseudocount), or, with pseudocount == 0, >= the folded
    base itself (>= 1, since the base seeds the posterior sum).
    """
    if not config.em_fold_singletons or num_transcripts <= 0:
        return False
    eps = config.em_epsilon
    if num_transcripts * eps >= 1.0:
        return False
    return eps < config.pseudocount or config.pseudocount == 0.0


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _round_up(n: int, mult: int) -> int:
    return ((int(n) + mult - 1) // mult) * mult


def _em_tables(
    tbl_tid, tbl_score, config: QuantConfig, row_weight=None, num_transcripts: int = 0
):
    """Prepare the EM working set: equivalence classes (default) with a
    narrow/mid/wide width partition and the singleton fold.

    Most classes have a handful of candidates while the table width W is
    forced by the most ambiguous read; tiering into [*, 4] narrow,
    [*, 8] mid and [*, W] wide tables keeps the per-iteration scatter
    lanes near the true pair count.  Exact: every class carries weight in
    exactly one partition (weight 0 rows are inert), and tier rows
    truncate only all-zero lanes (class rows are rank-ordered).
    Single-candidate classes leave the loop entirely when _fold_ok
    (their posterior is identically 1; em/classes.py).

    The class path runs as two device programs with ONE host sync
    between them (em/classes.py two-phase API): metadata (sort of [N]
    row hashes) -> sync of the 4 class scalars -> class-table gather +
    tier partition at static sizes.  No [N, W] gather or scatter ever
    materializes.

    Returns (tables, static_base, static_has); the static pair is
    (None, None) unless the fold is active.
    """
    N, W = tbl_tid.shape
    if config.em_equivalence_classes and N >= 1024:
        # Pad rows to a power of two so the grouping program's shape
        # family stays small (padding rows join the all-zero class and
        # its weight is inert in EM and assignment).
        N_pad = 1 << (N - 1).bit_length()
        if N_pad > N:
            tbl_tid = jnp.pad(tbl_tid, ((0, N_pad - N), (0, 0)))
            tbl_score = jnp.pad(tbl_score, ((0, N_pad - N), (0, 0)))
            if row_weight is not None:
                row_weight = jnp.pad(row_weight, (0, N_pad - N))
        rep, weight, scalars = group_candidate_rows_meta(
            tbl_tid,
            tbl_score,
            narrow_width=_EM_NARROW_WIDTH,
            row_weight=row_weight,
            mid_width=_EM_MID_WIDTH,
        )
        sc = np.asarray(scalars)  # the one host sync
        plan = plan_class_tables(
            sc,
            width=W,
            n_pad=N_pad,
            narrow_width=_EM_NARROW_WIDTH,
            mid_width=_EM_MID_WIDTH,
            fold_singletons=_fold_ok(config, num_transcripts),
            pair_width=_EM_PAIR_WIDTH,
        )
        tables, static_base, static_has = build_class_tables(
            tbl_tid,
            tbl_score,
            rep,
            weight,
            num_transcripts=num_transcripts,
            **plan,
        )
        log.info(
            "equivalence classes: %d reads -> %d classes "
            "(%d wide, %d mid, %d folded singletons)",
            N,
            int(sc[0]),
            int(sc[1]) - (int(sc[3]) if plan["mid_width"] else 0),
            int(sc[3]) if plan["mid_width"] else 0,
            int(sc[2]) if plan["fold"] else 0,
        )
        return tables, static_base, static_has

    tid, score, weight = tbl_tid, tbl_score, row_weight
    M, W = tid.shape
    if W <= _EM_NARROW_WIDTH or M < 1024:
        return ((tid, score, weight),), None, None
    if weight is None:
        weight = jnp.ones(M, jnp.int32)
    n_cand = jnp.sum(score > 0, axis=1)
    is_wide = n_cand > _EM_NARROW_WIDTH
    n_wide = int(jnp.sum(is_wide))
    if n_wide == 0:
        return (
            (
                jax.lax.slice_in_dim(tid, 0, _EM_NARROW_WIDTH, axis=1),
                jax.lax.slice_in_dim(score, 0, _EM_NARROW_WIDTH, axis=1),
                weight,
            ),
        ), None, None
    order = jnp.argsort(jnp.logical_not(is_wide), stable=True)  # wide rows first
    t_s = tid[order]
    s_s = score[order]
    w_s = weight[order]
    Nw = min(1 << max(n_wide - 1, 0).bit_length(), M)
    wide = (
        jax.lax.slice_in_dim(t_s, 0, Nw, axis=0),
        jax.lax.slice_in_dim(s_s, 0, Nw, axis=0),
        jnp.where(jnp.arange(Nw) < n_wide, jax.lax.slice_in_dim(w_s, 0, Nw), 0),
    )
    narrow = (
        t_s[:, :_EM_NARROW_WIDTH],
        s_s[:, :_EM_NARROW_WIDTH],
        jnp.where(jnp.arange(M) < n_wide, 0, w_s),
    )
    log.info("EM width partition: %d wide classes of %d (W=%d)", n_wide, M, W)
    return (narrow, wide), None, None


def _match_tables(index: IndexArtifact, packed: PackedReads, config: QuantConfig, timer):
    """Run the fused match scan, bucketing reads by power-of-two padded
    length.  Fully asynchronous: returns (tbl_tid [N,C], tbl_score,
    n_cand_max DEVICE scalar, stats dict of device arrays) with no host
    sync — the caller combines every needed scalar into one transfer
    and handles the flat-window fallback when pretail drops are
    nonzero."""
    ks = tuple(index.kmer_lengths)
    bpacked, postings, bucket_meta = _device_index(index, ks)
    bpacked = tuple(jnp.asarray(a) for a in bpacked)
    postings = tuple(jnp.asarray(a) for a in postings)
    B = config.batch_size
    R = packed.num_reads

    lengths_np = np.asarray(packed.lengths)
    pad_of = np.maximum(
        256, 1 << np.ceil(np.log2(np.maximum(lengths_np, 1))).astype(np.int64)
    )
    pads = np.minimum(pad_of, max(int(packed.padded_len), 256))
    unique_pads = sorted(set(pads.tolist()))

    codes_dev = jnp.asarray(packed.codes)
    lengths_dev = jnp.asarray(packed.lengths, dtype=jnp.int32)

    tbl_parts = []
    ncm = 0  # device scalar after the first bucket
    stats_parts = []
    sizes = {
        "reads_padded": 0,
        "hash_windows": 0,  # k-mer windows hashed (Σ_k rows x (L_eff-k+1))
        "hash_ops": 0,  # 32-bit seed-XOR ops (k per window, low-32 path)
        "probe_bytes": 0,  # bucket-table row-gather bytes (the probe's HBM cost)
        "group_lanes": 0,  # expansion-window lanes row-sorted for grouping
    }
    for pad in unique_pads:
        if len(unique_pads) == 1:
            codes_b = codes_dev[:, : min(pad, packed.padded_len)]
            lengths_b = lengths_dev
            n_b = R
            l_max = int(lengths_np.max()) if R else 0
        else:
            rows = np.flatnonzero(pads == pad)
            n_b = rows.size
            rows_dev = jnp.asarray(rows.astype(np.int32))
            codes_b = codes_dev[rows_dev][:, : min(pad, packed.padded_len)]
            lengths_b = lengths_dev[rows_dev]
            l_max = int(lengths_np[rows].max()) if n_b else 0
        # Slice the code lanes to the bucket's TRUE max length (rounded
        # to 8 to bound recompiles): the hash/sort lane count follows
        # the array width, and e.g. 150 bp reads in the min-256 bucket
        # otherwise pay 226 hash windows + 226-lane dedup sorts where
        # 122 (one 128-lane tile) suffice.
        l_eff = min(codes_b.shape[1], _round_up(max(l_max, max(ks)), 8))
        codes_b = codes_b[:, :l_eff]
        nb_b = max((n_b + B - 1) // B, 1)
        Nb = nb_b * B
        L = codes_b.shape[1]
        codes_all = jnp.pad(codes_b, ((0, Nb - n_b), (0, 0))).reshape(nb_b, B, L)
        lengths_all = jnp.pad(lengths_b, (0, Nb - n_b)).reshape(nb_b, B)
        caps = tuple(config.sketch_capacity_for(k, L) for k in ks)
        widths, probe_w = _tier_widths_for(
            index, packed, config, bpacked, bucket_meta, caps, ks, L
        )

        def run_scan(tiers: bool):
            return match_scan(
                codes_all,
                lengths_all,
                bpacked,
                postings,
                kmer_lengths=ks,
                sketch_fraction=config.sketch_fraction,
                sketch_caps=caps,
                chain_fraction=config.chain_fraction,
                expand_per_read=config.expand_per_read_k or config.expand_per_read,
                candidate_capacity=config.candidate_capacity,
                bucket_meta=bucket_meta,
                num_transcripts=index.num_transcripts,
                match_tiers=tiers,
                tier_widths=widths,
                probe_width=probe_w if tiers else None,
                match_per_k_tables=config.match_per_k_tables,
            )

        t, s, nc, st = run_scan(config.match_tiers)
        tbl_parts.append((t, s))
        ncm = nc if isinstance(ncm, int) else jnp.maximum(ncm, nc)
        stats_parts.append(st)

        # Static size accounting for the roofline model (exact: these are
        # the shapes the scan's programs actually process).
        K = len(ks)
        sizes["reads_padded"] += Nb
        for ki, k in enumerate(ks):
            nw = max(L - k + 1, 0)
            sizes["hash_windows"] += Nb * nw
            sizes["hash_ops"] += Nb * nw * k
            _, mb = bucket_meta[ki]
            cap = caps[ki]
            tiered = (
                config.match_tiers
                and probe_w is not None
                and B >= 1024
                and probe_w < max(caps)
            )
            if tiered and probe_w < cap:
                B0 = B - B // 16
                rows_probed = B0 * probe_w + (B - B0) * cap
            else:
                rows_probed = B * cap
            sizes["probe_bytes"] += nb_b * rows_probed * 3 * mb * 4
        from sketch_rna_tpu.match.rowmatch import _epr_per_k, _is_per_k_widths

        eprs_acc = _epr_per_k(
            config.expand_per_read_k or config.expand_per_read, K
        )
        if config.match_tiers and _is_per_k_widths(widths) and B >= 1024:
            lanes = sum(
                r * w
                for ki, wk in enumerate(widths)
                for r, w in tier_plan(B, eprs_acc[ki], wk)
            )
        elif config.match_tiers:
            plan = tier_plan(B, max(eprs_acc), widths)
            lanes = sum(r * w for r, w in plan) * K
        else:
            lanes = B * sum(eprs_acc)
        sizes["group_lanes"] += nb_b * lanes
    if len(tbl_parts) == 1:
        tbl_tid, tbl_score = tbl_parts[0]
    else:
        tbl_tid = jnp.concatenate([t for t, _ in tbl_parts])
        tbl_score = jnp.concatenate([s for _, s in tbl_parts])
    # Device-side stat accumulation — NO host syncs here; the caller
    # bundles ncm/pretail/class scalars into one transfer.
    stats = {}
    for k in stats_parts[0]:
        acc = stats_parts[0][k]
        for st in stats_parts[1:]:
            acc = acc + st[k]
        stats[k] = acc
    return tbl_tid, tbl_score, ncm, stats, sizes


def _run_em(
    tables,
    num_reads: int,
    num_transcripts: int,
    config: QuantConfig,
    static_base=None,
):
    """Run the partitioned EM, with optional mid-run checkpoint/resume.

    With config.em_checkpoint set, the iteration budget is split into
    segments of em_checkpoint_every; state saves after each segment and
    a fresh call resumes from the saved (pi, iteration).  Segmenting is
    exact: the loop re-enters with the same pi/iteration it would have
    had uninterrupted, and the returned `converged` flag stops a
    resumed run from ever taking an extra E-step.
    """
    kw = dict(
        num_transcripts=num_transcripts,
        convergence_threshold=config.em_convergence,
        pseudocount=config.pseudocount,
        epsilon=config.em_epsilon,
        dtype=config.em_dtype,
        static_base=static_base,
        use_segsum=resolve_em_segsum(config.em_segsum),
    )
    if kw["use_segsum"]:
        # ONE lane sort shared by every checkpoint segment (each
        # run_em_partitioned call would otherwise rebuild it).
        from sketch_rna_tpu.em.segsum import plan_from_tables

        kw["segsum_plan"] = plan_from_tables(tables, num_transcripts)
    R_dev = jnp.asarray(num_reads, jnp.int32)
    if not config.em_checkpoint:
        pi, iters, _ = run_em_partitioned(
            tables, R_dev, max_iterations=config.em_max_iterations, **kw
        )
        # iters stays a DEVICE scalar: syncing here would serialize EM
        # completion before the assignment dispatch; callers bundle it
        # into their one fetch transfer.
        return pi, iters

    import os

    from sketch_rna_tpu.em.checkpoint import (
        EMState,
        check_resumable,
        fingerprint_of,
        load_em_state,
        save_em_state,
    )

    path = config.em_checkpoint
    fp = fingerprint_of(num_transcripts, num_reads, config)
    pi, it = None, 0
    if os.path.exists(path):
        st = load_em_state(path)
        check_resumable(st, fp)
        pi, it = st.pi, st.iterations_done
        log.info("resuming EM from %s at iteration %d", path, it)
    every = max(config.em_checkpoint_every, 1)
    while it < config.em_max_iterations:
        bound = min(it + every, config.em_max_iterations)
        pi, iters, done = run_em_partitioned(
            tables,
            R_dev,
            max_iterations=bound,
            init_pi=pi,
            start_iteration=it,
            **kw,
        )
        it = int(iters)
        save_em_state(path, EMState(np.asarray(pi), it, num_reads, fp))
        if bool(done):
            break
    return pi, it


def _quantify_fused(
    index: IndexArtifact, packed: PackedReads, config: QuantConfig, nb: int
) -> QuantResult:
    from sketch_rna_tpu.utils.timing import PhaseTimer

    # Per-k expansion budgets discovered by a previous call's overflow
    # retry are cached on the packed reads (same pattern as the
    # tier-width cache): repeat quantify calls over the same reads
    # (bench repeats, multi-sample warm-up) skip the re-discovery pass.
    _epr_key = (id(index), tuple(index.kmer_lengths), config.expand_per_read)
    if config.expand_per_read_k is None:
        _epr_cache = getattr(packed, "_epr_k_cache", None)
        if _epr_cache and _epr_key in _epr_cache:
            config = dataclasses.replace(
                config, expand_per_read_k=_epr_cache[_epr_key]
            )

    timer = PhaseTimer()
    with timer.phase("match_dispatch"):
        tbl_tid, tbl_score, n_cand_max, stats, sizes = _match_tables(
            index, packed, config, timer
        )

    N = tbl_tid.shape[0]
    use_classes = config.em_equivalence_classes and N >= 1024
    with timer.phase("match_scan", items=packed.num_reads):
        if use_classes:
            # Class metadata runs on the FULL-width tables (identical
            # rows at full width are identical after narrowing: columns
            # past every real candidate are zero), so its dispatch needs
            # no ncm sync — ONE combined transfer then carries ncm,
            # pretail and the class scalars together.
            N_pad = 1 << (N - 1).bit_length()
            if N_pad > N:
                tbl_tid = jnp.pad(tbl_tid, ((0, N_pad - N), (0, 0)))
                tbl_score = jnp.pad(tbl_score, ((0, N_pad - N), (0, 0)))
            rep, weight, scalars = group_candidate_rows_meta(
                tbl_tid,
                tbl_score,
                narrow_width=_EM_NARROW_WIDTH,
                mid_width=_EM_MID_WIDTH,
            )
            sync = np.asarray(
                jnp.concatenate(
                    [
                        jnp.reshape(n_cand_max, (1,)),
                        jnp.reshape(stats["expand_dropped_pretail"], (1,)),
                        scalars,
                        jnp.reshape(stats["candidate_spilled"], (1,)),
                        jnp.ravel(stats["expand_dropped"]),
                    ]
                )
            )
        else:
            sync = np.asarray(
                jnp.concatenate(
                    [
                        jnp.reshape(n_cand_max, (1,)),
                        jnp.reshape(stats["expand_dropped_pretail"], (1,)),
                        jnp.reshape(stats["candidate_spilled"], (1,)),
                        jnp.ravel(stats["expand_dropped"]),
                    ]
                )
            )

    if config.match_tiers and int(sync[1]) > 0:
        # Calibrated tier windows under-covered this dataset: rerun the
        # whole match with the flat full-budget window — exactness over
        # speed, never silent.
        log.warning(
            "tiered match dropped %d pretail events; rerunning flat",
            int(sync[1]),
        )
        return _quantify_fused(
            index, packed, dataclasses.replace(config, match_tiers=False), nb
        )
    K_ret = len(index.kmer_lengths)
    dropped_k = sync[-K_ret:]
    if (
        config.match_per_k_tables
        and K_ret > 1
        and int(sync[-K_ret - 1]) > 0
    ):
        # A per-k candidate table spilled pre-intersection (or the final
        # set overflowed C): rerun with the merged K-wide grouping,
        # which truncates only the FINAL set — the earlier semantics
        # (PARITY.md deviation 7).  Exactness over speed, never silent.
        log.warning(
            "candidate table spilled %d lanes under per-k grouping; "
            "rerunning with merged K-wide grouping",
            int(sync[-K_ret - 1]),
        )
        return _quantify_fused(
            index,
            packed,
            dataclasses.replace(config, match_per_k_tables=False),
            nb,
        )
    eprs_now = config.expand_per_read_k or (config.expand_per_read,) * K_ret
    if any(
        int(d) > 0 and e < EXPAND_RETRY_MAX
        for e, d in zip(eprs_now, dropped_k)
    ):
        # The FULL expansion budget (flat window or tail tier) dropped
        # posting events — the reference never drops any
        # (/root/reference/src/sparse_chaining.cpp:48-73), so rerun with
        # a doubled window for the k(s) that actually dropped (same
        # exactness-over-speed pattern as the pretail flat rerun and the
        # sharded class-overflow rerun; per-k so one ambiguous k doesn't
        # double every k's tail tier).  EXPAND_RETRY_MAX bounds the
        # doubling; past it the drop is warned (final-stats path below).
        new_eprs = tuple(
            min(2 * e, EXPAND_RETRY_MAX) if int(d) > 0 else e
            for e, d in zip(eprs_now, dropped_k)
        )
        log.warning(
            "expansion budget dropped %s events per k; rerunning with "
            "expand_per_read_k=%s",
            dropped_k.tolist(),
            new_eprs,
        )
        _epr_cache = getattr(packed, "_epr_k_cache", None)
        if _epr_cache is None:
            _epr_cache = {}
            object.__setattr__(packed, "_epr_k_cache", _epr_cache)
        _epr_cache[_epr_key] = new_eprs
        return _quantify_fused(
            index,
            packed,
            dataclasses.replace(config, expand_per_read_k=new_eprs),
            nb,
        )

    # Tables are rank-ordered per read, so narrowing to the max per-read
    # candidate count is lossless and shrinks the EM working set (the
    # dominant EM cost is the posterior scatter over rows x width lanes).
    W = max(int(sync[0]), 1)
    W = 1 << (W - 1).bit_length()  # pow2 to bound recompiles
    W = min(W, config.candidate_capacity)
    tbl_tid = jax.lax.slice_in_dim(tbl_tid, 0, W, axis=1)
    tbl_score = jax.lax.slice_in_dim(tbl_score, 0, W, axis=1)

    # Profiling aid: phases below dispatch async and normally drain at
    # the single fetch sync; setting SKETCH_TPU_SYNC_PHASES=1 blocks
    # after each so the timer attributes device time per stage.
    sync_phases = os.environ.get("SKETCH_TPU_SYNC_PHASES") == "1"
    with timer.phase("classes"):
        if use_classes:
            plan = plan_class_tables(
                sync[2:7],
                width=W,
                n_pad=tbl_tid.shape[0],
                narrow_width=_EM_NARROW_WIDTH,
                mid_width=_EM_MID_WIDTH,
                fold_singletons=_fold_ok(config, index.num_transcripts),
                pair_width=_EM_PAIR_WIDTH,
            )
            tables, static_base, static_has = build_class_tables(
                tbl_tid,
                tbl_score,
                rep,
                weight,
                num_transcripts=index.num_transcripts,
                **plan,
            )
            log.info(
                "equivalence classes: %d reads -> %d classes "
                "(%d wide, %d mid, %d folded singletons)",
                N,
                int(sync[2]),
                int(sync[3]) - (int(sync[5]) if plan["mid_width"] else 0),
                int(sync[5]) if plan["mid_width"] else 0,
                int(sync[4]) if plan["fold"] else 0,
            )
        else:
            tables, static_base, static_has = _em_tables(
                tbl_tid, tbl_score, config, num_transcripts=index.num_transcripts
            )
        if sync_phases:
            jax.block_until_ready(tables)

    sizes["em_lanes"] = sum(int(np.prod(t[0].shape)) for t in tables)
    sizes["em_width_max"] = max(int(t[0].shape[1]) for t in tables)
    with timer.phase("em_assign"):
        use_segsum = resolve_em_segsum(config.em_segsum)
        if config.em_checkpoint:
            pi, iters = _run_em(
                tables,
                packed.num_reads,
                index.num_transcripts,
                config,
                static_base=static_base,
            )
            weighted, has_entry = assign_reads_partitioned(
                tables,
                pi,
                num_transcripts=index.num_transcripts,
                dtype=config.em_dtype,
                use_segsum=use_segsum,
                static_base=static_base,
                static_has=static_has,
            )
        else:
            pi, iters, weighted, has_entry = run_em_assign_partitioned(
                tables,
                jnp.asarray(packed.num_reads, jnp.int32),
                num_transcripts=index.num_transcripts,
                max_iterations=config.em_max_iterations,
                convergence_threshold=config.em_convergence,
                pseudocount=config.pseudocount,
                epsilon=config.em_epsilon,
                dtype=config.em_dtype,
                use_segsum=use_segsum,
                static_base=static_base,
                static_has=static_has,
            )
        if sync_phases:
            jax.block_until_ready((pi, weighted))
    with timer.phase("fetch"):
        # Bundle every device->host readback into ONE transfer (each
        # np.asarray is a synchronising round trip): the float results
        # are bitcast into the int32 bundle (exact — bits round-trip) and
        # split back out on the host.
        T = index.num_transcripts
        stat_keys = sorted(stats)
        f_dtype = jnp.asarray(pi).dtype
        floats = jnp.concatenate([jnp.ravel(pi), jnp.ravel(weighted)])
        # has_entry rides as PACKED BITS (T/32 words instead of T): at
        # GENCODE scale the bool-as-int32 plane would be a third of the
        # fetch.
        Tw = (T + 31) // 32
        hb = jnp.ravel(has_entry).astype(jnp.uint32)
        if Tw * 32 > T:
            hb = jnp.concatenate([hb, jnp.zeros(Tw * 32 - T, jnp.uint32)])
        hbits = jnp.sum(
            hb.reshape(Tw, 32) << jnp.arange(32, dtype=jnp.uint32)[None, :],
            axis=1,
            dtype=jnp.uint32,
        )
        parts = (
            [jnp.reshape(jnp.asarray(iters, jnp.int32), (1,))]
            + [jax.lax.bitcast_convert_type(hbits, jnp.int32)]
            + [jnp.ravel(jnp.asarray(stats[k])).astype(jnp.int32) for k in stat_keys]
        )
        # float32 results bitcast into the int bundle (bits round-trip
        # exactly) so everything rides ONE transfer; float64 keeps a
        # second transfer (64-bit bitcast trips XLA's x64 rewriting on
        # some backends, and the f64 path is the CPU parity surface
        # where latency is irrelevant).
        one_transfer = f_dtype == jnp.float32
        if one_transfer:
            parts.append(jnp.ravel(jax.lax.bitcast_convert_type(floats, jnp.int32)))
        ints_h = np.asarray(jnp.concatenate(parts))
        floats_h = (
            ints_h[-2 * T :].view(np.float32) if one_transfer else np.asarray(floats)
        )
        iters = int(ints_h[0])
        hwords = ints_h[1 : 1 + Tw].view(np.uint32)
        has_entry = (
            (hwords[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
        ).astype(bool).reshape(-1)[:T]
        host_stats = {}
        off = 1 + Tw
        for k in stat_keys:
            n = int(np.prod(np.shape(stats[k]))) if np.shape(stats[k]) else 1
            host_stats[k] = int(ints_h[off : off + n].sum())
            off += n
        pi = floats_h[:T]
        weighted = floats_h[T:]
    for key, v in host_stats.items():
        if v:
            log.warning("capacity overflow during matching: %s=%d", key, v)
    return QuantResult(
        names=list(index.names),
        pi=pi,
        weighted_counts=weighted,
        has_entry=has_entry,
        em_iterations=int(iters),
        num_reads=packed.num_reads,
        stats=host_stats,
        timing=timer.report(),
        lengths=np.asarray(index.lengths),
        sizes=sizes,
    )


def quantify_sharded(
    index: IndexArtifact,
    packed: PackedReads,
    config: Optional[QuantConfig] = None,
    mesh=None,
) -> QuantResult:
    """Multi-device quant via the STREAMING shard_map engine
    (dist/quant_stream): reads scan through per-device class buffers in
    chunks (O(chunk + buffer) HBM at any R), the index is hash-range
    sharded, and the EM psums per iteration over the data axis.

    With mesh=None, builds a mesh over all visible devices
    (dist.mesh.mesh_factor decides the data/index split).  Results are
    identical to quantify() (asserted in tests/test_sharded.py and
    tests/test_quantify_sharded_api.py).
    """
    import jax

    from sketch_rna_tpu.dist.mesh import index_device_bytes, make_mesh, mesh_factor

    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    if jax.process_count() > 1:
        # Multi-host: `packed` is THIS process's read slice; the
        # multihost wrapper builds the global arrays and runs the same
        # shard_map step SPMD across processes.
        from sketch_rna_tpu.dist.multihost import quantify_sharded_multihost

        return quantify_sharded_multihost(index, packed, config, mesh)
    if packed.num_reads == 0:
        # Same clean empty result as quantify() — without this, padding
        # to B=0 rows runs EM with pc/0 = inf pi.
        return _empty_result(index)
    if mesh is None:
        # index_bytes auto-widens the index axis when a full replica
        # would exceed the per-device HBM budget (BASELINE config 4:
        # GENCODE-scale indexes shard across hosts without the caller
        # having to know to ask).
        dp, ip = mesh_factor(
            len(jax.devices()), index_bytes=index_device_bytes(index)
        )
        mesh = make_mesh(dp, ip)
    dp = mesh.shape["data"]
    ip = mesh.shape["index"]

    R = packed.num_reads
    L = int(packed.padded_len)
    Bl = config.batch_size
    Bg = Bl * dp
    nb = max((R + Bg - 1) // Bg, 1)
    codes = jnp.pad(jnp.asarray(packed.codes), ((0, nb * Bg - R), (0, 0)))
    lengths = jnp.pad(jnp.asarray(packed.lengths, dtype=jnp.int32), (0, nb * Bg - R))
    codes_all = codes.reshape(nb, Bg, L)
    lengths_all = lengths.reshape(nb, Bg)

    ks = tuple(index.kmer_lengths)
    caps = tuple(config.sketch_capacity_for(k, L) for k in ks)
    # Tier calibration uses the UNSHARDED index probe: its totals are the
    # global per-read event counts — exactly the sharded tier key.
    bpacked, _post_full, bucket_meta = _device_index(index, ks)
    widths, _probe_w = _tier_widths_for(
        index, packed, config, bpacked, bucket_meta, caps, ks, L
    )
    # The sharded engine groups shard-merged event windows (counts for
    # one (read, tid, k) spread across hash-range shards), so per-k
    # tables can't pre-group there: collapse per-k calibration to the
    # shared max-over-k form.
    from sketch_rna_tpu.match.rowmatch import shared_tier_widths

    widths = shared_tier_widths(widths)
    return _sharded_stream_core(
        index, config, mesh, codes_all, lengths_all, R, widths, nb
    )


def _sharded_stream_core(
    index: IndexArtifact,
    config: QuantConfig,
    mesh,
    codes_all,
    lengths_all,
    R: int,
    widths,
    nb: int,
) -> QuantResult:
    """The sharded streaming engine proper, shared by the single-process
    path (device-local arrays) and the multi-host path (global arrays
    from jax.make_array_from_process_local_data with the SAME shardings
    the shard_map in_specs declare).  All static arguments (widths, pad
    plan) must be identical on every process — callers establish that
    via allgather consensus before calling."""
    from sketch_rna_tpu.dist.quant_stream import em_assign_sharded, stream_sharded_scan
    from sketch_rna_tpu.index.shard import shard_index_arrays

    ip = mesh.shape["index"]
    Bl = config.batch_size
    L = int(codes_all.shape[2])
    shards = shard_index_arrays(index, ip)
    ks = tuple(index.kmer_lengths)
    keys = tuple(jnp.asarray(shards[k][0]) for k in ks)
    row_ptr = tuple(jnp.asarray(shards[k][1]) for k in ks)
    postings = tuple(jnp.asarray(shards[k][2]) for k in ks)
    caps = tuple(config.sketch_capacity_for(k, L) for k in ks)
    # Per-device rows: a buffer this large can never overflow (fill only
    # grows by appended rows), so the overflow retry below terminates.
    m_cap_full = max(_round_up(nb * Bl, 1024), 2 * Bl)
    m_cap = min(max(config.stream_class_capacity, 2 * Bl), m_cap_full)

    def run(tiers: bool, epr: int = config.expand_per_read):
        return stream_sharded_scan(
            codes_all,
            lengths_all,
            keys,
            row_ptr,
            postings,
            mesh=mesh,
            kmer_lengths=ks,
            sketch_fraction=config.sketch_fraction,
            sketch_caps=caps,
            chain_fraction=config.chain_fraction,
            expand_per_read=epr,
            candidate_capacity=config.candidate_capacity,
            num_transcripts=index.num_transcripts,
            match_tiers=tiers,
            tier_widths=widths,
            m_cap=m_cap,
            narrow_width=_EM_NARROW_WIDTH,
            mid_width=_EM_MID_WIDTH,
        )

    tiers_now = config.match_tiers
    bt, bs, bw, scalars, dropped, sk_ov = run(tiers_now)
    sc = np.asarray(scalars)
    if tiers_now and int(sc[2]) > 0:
        log.warning(
            "tiered sharded match dropped %d pretail events; rerunning flat",
            int(sc[2]),
        )
        tiers_now = False
        bt, bs, bw, scalars, dropped, sk_ov = run(tiers_now)
        sc = np.asarray(scalars)
    # Class-buffer overflow: the read chunks are device-resident, so the
    # exact recovery is ONE rerun at the per-device row bound, where
    # overflow is impossible (the single-device streaming path drains to
    # the host instead; here every process must take the same
    # deterministic branch — sc is psum'd, the bound is pure arithmetic
    # — to keep multi-host SPMD consensus).
    if config.stream_drain and int(sc[4]) > 0 and m_cap < m_cap_full:
        log.warning(
            "sharded class buffer overflowed (%d reads dropped); "
            "rerunning with %d rows",
            int(sc[4]),
            m_cap_full,
        )
        m_cap = m_cap_full
        bt, bs, bw, scalars, dropped, sk_ov = run(tiers_now)
        sc = np.asarray(scalars)
    # Full-budget expansion drops: the reference never drops a posting
    # event (/root/reference/src/sparse_chaining.cpp:48-73); double the
    # per-read window until it covers the dataset.  `dropped` is psum'd
    # inside the shard_map (replicated), so every process takes the same
    # branch; the doubling is bounded by EXPAND_RETRY_MAX.
    epr_now = config.expand_per_read
    while int(np.asarray(dropped).sum()) > 0 and epr_now < EXPAND_RETRY_MAX:
        epr_now = min(2 * epr_now, EXPAND_RETRY_MAX)
        log.warning(
            "sharded expansion budget dropped %d events; rerunning with "
            "expand_per_read=%d",
            int(np.asarray(dropped).sum()),
            epr_now,
        )
        bt, bs, bw, scalars, dropped, sk_ov = run(tiers_now, epr_now)
        sc = np.asarray(scalars)

    W = max(int(sc[0]), 1)
    W = min(1 << (W - 1).bit_length(), config.candidate_capacity)
    m_pad = min(max(_round_up(int(sc[1]), 1024), 1024), m_cap)

    # Static tier plan for program 2 from the MESH-MAX per-shard counts
    # (sc[5:11], see stream_sharded_scan) — each derived count is maxed
    # per shard, so every shard's tiers fit these pads; mirrors
    # em/classes.plan_class_tables for the per-shard setting.
    wide_all, wide_excl, midc, tail1 = (int(x) for x in sc[5:9])
    multi_fold, multi_nofold = int(sc[9]), int(sc[10])
    fold = _fold_ok(config, index.num_transcripts) and tail1 > 0 and m_pad >= 1024
    split = W > _EM_NARROW_WIDTH and wide_all > 0 and m_pad >= 1024
    mid_active = split and W > _EM_MID_WIDTH and midc > 0
    nw2 = wide_excl if mid_active else wide_all
    n_multi = multi_fold if fold else multi_nofold
    nm_pad = min(max(_round_up(max(n_multi, 1), 2048), 1024), m_pad)
    nmid_pad = min(_round_up(midc, 512), m_pad) if mid_active else 0
    nw_pad = min(_round_up(max(nw2, 1), 512), m_pad) if (split and nw2 > 0) else 0

    pi, iters, weighted, has_entry = em_assign_sharded(
        bt,
        bs,
        bw,
        jnp.asarray(R, jnp.int32),
        mesh=mesh,
        num_transcripts=index.num_transcripts,
        m_pad=m_pad,
        width=W,
        em_max_iterations=config.em_max_iterations,
        em_convergence=config.em_convergence,
        pseudocount=config.pseudocount,
        em_epsilon=config.em_epsilon,
        em_dtype=config.em_dtype,
        use_segsum=resolve_em_segsum(config.em_segsum),
        nm_pad=nm_pad,
        nmid_pad=nmid_pad,
        nw_pad=nw_pad,
        narrow_width=_EM_NARROW_WIDTH,
        mid_width=_EM_MID_WIDTH,
        split=split,
        fold=fold,
    )
    host_stats = {
        "expand_dropped": int(np.asarray(dropped).sum()),
        "sketch_overflow": int(np.asarray(sk_ov).sum()),
        "candidate_spilled": int(sc[3]),
        "class_overflow": int(sc[4]),
        "expand_dropped_pretail": int(sc[2]),
    }
    for key, v in host_stats.items():
        if v:
            log.warning("capacity overflow during sharded match: %s=%d", key, v)
    return QuantResult(
        names=list(index.names),
        pi=np.asarray(pi),
        weighted_counts=np.asarray(weighted),
        has_entry=np.asarray(has_entry),
        em_iterations=int(iters),
        num_reads=R,
        stats=host_stats,
        lengths=np.asarray(index.lengths),
    )


def quantify_samples(
    index: IndexArtifact,
    samples: Dict[str, Union[PackedReads, Callable[[], PackedReads]]],
    config: Optional[QuantConfig] = None,
    sharded: bool = False,
) -> Dict[str, QuantResult]:
    """Multi-sample batch quant (BASELINE.json config 5): quantify many
    FASTQ samples against one loaded index.  Single-host form runs
    samples sequentially over the shared device index (index load and
    bucket tables amortized); under a multi-host mesh the natural outer
    axis is samples-per-host, each host running this loop on its share.
    sharded=True runs each sample through the multi-device engine
    instead (one mesh over all visible devices, reused across samples).
    """
    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    quant = quantify_sharded if sharded else quantify
    out: Dict[str, QuantResult] = {}
    for name, packed in samples.items():
        # A callable defers the parse+pack until this sample's turn, so
        # N samples never hold N whole-file packs in host RAM at once
        # (config 5: 8 x 50M reads would otherwise be ~100 GB).
        out[name] = quant(index, packed() if callable(packed) else packed, config)
    return out


def format_cpp_double(v: float) -> str:
    """C++ default ostream double formatting: %g with 6 significant
    digits (src/data_io.cpp:148 uses the stream defaults)."""
    return f"{v:.6g}"


def write_csv(path: str, result: QuantResult, with_tpm: bool = False) -> None:
    """CSV schema of output_to_csv (src/data_io.cpp:133-152):
    header Name,NumReads,EM_Abundance; rows only for transcripts with a
    read_counts entry; deterministic index order replaces quirk Q4.

    with_tpm appends an optional true-TPM column (quirk Q3: the reference
    README promises TPM but never computes it; off by default to keep the
    byte-level schema)."""
    tpm = result.tpm() if with_tpm else None
    with open(path, "w") as fh:
        if with_tpm:
            fh.write("Name,NumReads,EM_Abundance,TPM\n")
        else:
            fh.write("Name,NumReads,EM_Abundance\n")
        for t in range(len(result.names)):
            if not result.has_entry[t]:
                continue
            row = (
                f"{result.names[t]},{format_cpp_double(float(result.weighted_counts[t]))},"
                f"{format_cpp_double(float(result.pi[t]))}"
            )
            if with_tpm:
                row += f",{format_cpp_double(float(tpm[t]))}"
            fh.write(row + "\n")
