"""Configuration for the quantification pipeline.

Every constant that is hard-coded in the reference is promoted to a config
field here with the reference's exact default (SURVEY.md §5 "Config / flag
system"):

  sketch_fraction   = 0.05   (src/main.cpp:43, global `sketch_size`)
  chain_fraction    = 0.9    (src/main.cpp:185, `sparse_chain(..., 0.9)`)
  em_max_iterations = 20     (src/main.cpp:188)
  em_convergence    = 0.01   (src/main.cpp:188)
  pseudocount       = 0.01   (src/isoform_assignment.cpp:54)
  em_epsilon        = 1e-10  (src/isoform_assignment.cpp:28)
  kmer_lengths      = (31,)  (src/main.cpp:215 default)

Device capacity knobs (raggedness bounds, SURVEY.md §7.4) have no
reference equivalent; overflow past any capacity is counted and reported,
never silent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    # --- reference-mirrored algorithm constants -------------------------
    kmer_lengths: Tuple[int, ...] = (31,)
    sketch_fraction: float = 0.05
    chain_fraction: float = 0.9
    em_max_iterations: int = 20
    em_convergence: float = 0.01
    pseudocount: float = 0.01
    em_epsilon: float = 1e-10

    # --- device capacity / batching knobs -------------------------------
    # Max reads per device batch through the hash+match kernels.
    batch_size: int = 8192
    # Padded read length (reads are padded/bucketed to this many bases).
    max_read_len: int = 256
    # Per-read, per-k sketch capacity (distinct kept hashes). Expected kept
    # count is ~fraction*(L-k+1); default leaves generous headroom.
    sketch_capacity: int = 32
    # Posting-expansion budget per read per k (event lanes). Hot reads on
    # isoform-family data genuinely need >128 (measured: 128 drops events
    # on the bench transcriptome); overflow is counted, never silent.
    expand_per_read: int = 256
    # Optional PER-K expansion budgets (len == len(kmer_lengths)),
    # overriding expand_per_read per k.  Set by the expansion-overflow
    # retry so only the k that actually dropped events pays a doubled
    # window (at GENCODE {21,31} one ambiguous k otherwise doubles every
    # k's tail tier).  None = expand_per_read for every k.
    expand_per_read_k: "Optional[Tuple[int, ...]]" = None
    # Max candidate transcripts retained per read after thresholding
    # (reference keeps all; overflow keeps top-score and is counted).
    candidate_capacity: int = 64
    # dtype for EM/assignment accumulation: "float64" matches the reference
    # (C++ double) bit-for-bit on CPU; "float32" is the accelerator default.
    em_dtype: str = "float32"
    # Tiered posting-expansion windows: batch rows sort by event count and
    # each tier gets a window sized to its rank (match/rowmatch.tier_plan)
    # — ~6x fewer expanded lanes than a flat expand_per_read window.
    match_tiers: bool = True
    # K>1 grouping mode: True = per-k top-table intersection (linear in
    # K; per-k sets truncate at 2*candidate_capacity BEFORE the
    # intersection — PARITY.md deviation 7), False = the merged K-wide
    # event grouping (truncates only the final set).  On any candidate
    # spill the engines rerun with False (exactness over speed).
    match_per_k_tables: bool = True
    # Scatter-free posterior accumulation (em/segsum.py): lanes sort by
    # transcript ONCE per quant, then every EM iteration reduces the
    # posterior sums with a segmented scan + one [T] gather instead of a
    # duplicate-index scatter-add.  "auto" means the scatter (see
    # em.resolve_em_segsum); "on" forces the segsum path.
    em_segsum: str = "auto"
    # Collapse reads with identical candidate profiles into weighted
    # equivalence classes before EM (exact; EM cost then scales with
    # transcriptome ambiguity, not read count).
    em_equivalence_classes: bool = True
    # Fold single-candidate equivalence classes out of the EM loop: their
    # E-step posterior is identically 1 (the read's one candidate takes
    # the whole normalized mass), so their posterior-sum contribution is
    # an iteration-invariant constant (em/classes.py build_class_tables).
    # Auto-disabled when em_epsilon could zero a singleton's denominator
    # (pipeline._fold_ok); exact whenever active.  Typically removes
    # ~40% of EM loop rows on real transcriptomes.
    em_fold_singletons: bool = True
    # Streaming path: class-buffer row capacity (bounds DISTINCT candidate
    # profiles, i.e. transcriptome ambiguity — not read count) and reads
    # per host->device super-chunk.  8M rows ~ 4 GB at C=64 — sized so
    # GENCODE-scale multi-10M-read runs hold their global classes on
    # device (synthetic uniform 8M reads already form 2.03M distinct
    # classes, and every drain copies its segment to the host).  Buffers
    # are additionally bounded by the dataset's own row count when it is
    # known up front, so small runs stay small.  Not yet re-derived from
    # the GPU's memory (ROADMAP Speed item 7).
    stream_class_capacity: int = 1 << 23
    stream_chunk_reads: int = 1 << 20
    # Streaming dual-buffer split: classes with at most this many
    # candidates live in the big [stream_class_capacity, width] running
    # buffer (lossless — class rows are rank-ordered, so narrow classes
    # have only zero lanes past the split), while wider classes go to a
    # small full-width side buffer.  4x less HBM and compaction work
    # than a C=64-wide buffer; <1% of GENCODE-scale
    # classes exceed 16 candidates.  0 disables the split (single
    # full-width buffer).
    stream_narrow_width: int = 16
    # Exactness under class-buffer pressure (default on).  Single-device
    # streaming: when the buffer risks overflowing on the next
    # super-chunk, compact it on device and, if still crowded, drain the
    # compacted classes to the host; drained segments re-merge into
    # global equivalence classes before the EM — super-chunks are also
    # clamped to the buffer, so no batch can ever drop.  Sharded engine:
    # on overflow, rerun the device-resident scan once at the
    # per-device-row bound (where overflow is impossible).  False
    # restores the counted-drop behavior (stats["class_overflow"]) on
    # both paths.
    stream_drain: bool = True
    # Mid-run EM checkpointing: save (pi, iteration) to this path every
    # em_checkpoint_every iterations and resume from it when present.
    # The reference's only persisted artifact is the index (SURVEY.md §5
    # "Checkpoint / resume"); this adds the missing mid-run state.
    em_checkpoint: Optional[str] = None
    em_checkpoint_every: int = 5

    def sketch_capacity_for(self, k: int, read_len: Optional[int] = None) -> int:
        """Auto-size sketch capacity from the padded read length (or an
        explicit per-bucket width)."""
        n_kmers = max((read_len or self.max_read_len) - k + 1, 1)
        import math

        expected = n_kmers * self.sketch_fraction
        # ~6 sigma headroom on a binomial tail, rounded up to a lane-friendly
        # multiple of 8; never below the configured floor.
        cap = int(math.ceil(expected + 6.0 * math.sqrt(max(expected, 1.0))))
        cap = ((cap + 7) // 8) * 8
        return max(cap, self.sketch_capacity)


DEFAULT_CONFIG = QuantConfig()
