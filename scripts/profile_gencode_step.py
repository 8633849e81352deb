"""Per-stage device timing of the quant step at GENCODE scale.

Usage: python scripts/profile_gencode_step.py [index.npz]

Times each stage of sketch_match_step on one [8192, 256] batch against
the full 250k-isoform index, plus the EM iteration pieces at the real
class-table shapes.  Every timing runs before any device->host
transfer, and the script takes its data-dependent widths from fixed
representative values rather than syncing calibration scalars.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

enable_compilation_cache()

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.artifact import load_index
from sketch_rna_tpu.match.bucket_lookup import bucket_lookup
from sketch_rna_tpu.match.rowmatch import (
    row_events_to_candidates,
    row_expand_from_runs,
    row_match_runs_tiered,
)
from sketch_rna_tpu.pipeline import _device_index, sketch_match_step
from sketch_rna_tpu.sketch.fracminhash import sketch_batch
from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome


def timeit(name, fn, n=20):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"{name:46s} {best*1000:9.3f} ms", flush=True)
    return best


def main():
    idx_path = (
        sys.argv[1] if len(sys.argv) > 1 else "/tmp/sketch_scale_cache/T250000_k31.npz"
    )
    idx = load_index(idx_path)
    ks = tuple(idx.kmer_lengths)
    K = len(ks)
    cfg = QuantConfig(kmer_lengths=ks, em_dtype="float32", max_read_len=256)
    B, L = cfg.batch_size, 152  # l_eff for 150bp reads (rounded to 8)
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    bpacked, postings, metas = _device_index(idx, ks)
    T = idx.num_transcripts
    print(f"T={T} ks={ks} caps={caps} B={B} L={L}", flush=True)

    # Reads sampled from the SAME transcriptome (seed 2026) so posting
    # densities are production-like.
    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, T)
    codes, lengths = sample_reads_device(seqs, B, 150, L, 7)
    jax.block_until_ready((codes, lengths))

    # --- stage timings ---------------------------------------------------
    sketches = []
    for ki, k in enumerate(ks):
        f = jax.jit(lambda c, l, k=k, cap=caps[ki]: sketch_batch(c, l, k, 0.05, cap))
        timeit(f"sketch k={k}", lambda: f(codes, lengths))
        sketches.append(f(codes, lengths))

    probes = []
    for ki, k in enumerate(ks):
        h, m, _ = sketches[ki]
        shift, mb = metas[ki]
        # Big tables MUST be jit ARGUMENTS: closure capture embeds them
        # as program constants, which ships hundreds of MB inside the
        # remote compile request (HTTP 413) and re-validates them per
        # call (the closure-constant dispatch cost, docs/DESIGN.md).
        f = jax.jit(
            lambda h, m, tbl, shift=shift, mb=mb: bucket_lookup(
                h, m, tbl, shift=shift, mb=mb
            ),
            static_argnames=(),
        )
        timeit(
            f"probe k={k} (full cap={caps[ki]}, mb={mb})",
            lambda: f(h, m, bpacked[ki]),
        )
        # tiered probe width: representative w0=24 over 15/16 rows
        w0 = 24
        f2 = jax.jit(
            lambda h, m, tbl, shift=shift, mb=mb, w0=w0: bucket_lookup(
                h[:, :w0], m[:, :w0], tbl, shift=shift, mb=mb
            )
        )
        timeit(f"probe k={k} (tiered w0={w0})", lambda: f2(h, m, bpacked[ki]))
        # 128-lane-aligned rows: pad 3*mb -> 128 junk-tail columns so the
        # row gather moves whole native vector tiles.
        row_lanes = bpacked[ki].shape[1]
        if row_lanes < 128:
            padded = jnp.pad(bpacked[ki], ((0, 0), (0, 128 - row_lanes)))
            jax.block_until_ready(padded)
            timeit(
                f"probe k={k} (tiered w0={w0}, 128-lane rows)",
                lambda: f2(h, m, padded),
            )
        probes.append(f(h, m, bpacked[ki]))

    # expansion + grouping, flat vs tiered, at representative widths
    starts = [p[0] for p in probes]
    lens = [p[1] for p in probes]

    def flat_match(starts, lens, postings):
        parts = []
        for ki in range(K):
            key, _ = row_expand_from_runs(
                starts[ki], lens[ki], postings[ki],
                events_per_read=cfg.expand_per_read, k_index=ki, num_k=K,
            )
            parts.append(key)
        keym = jnp.concatenate(parts, axis=1) if K > 1 else parts[0]
        r = row_events_to_candidates(
            keym, num_k=K, chain_fraction=0.9,
            candidate_capacity=cfg.candidate_capacity, num_transcripts=T,
        )
        return r.tid, r.score, r.mask

    jf = jax.jit(flat_match)
    timeit("expand+group FLAT (Epr=256)", lambda: jf(starts, lens, postings))

    def tiered_match(starts, lens, postings):
        r, perm = row_match_runs_tiered(
            starts, lens, postings, num_k=K,
            events_per_read=cfg.expand_per_read, chain_fraction=0.9,
            candidate_capacity=cfg.candidate_capacity, num_transcripts=T,
            tier_widths=(16, 64),
        )
        return r.tid, r.score, r.mask

    jt = jax.jit(tiered_match)
    timeit("expand+group TIERED (16/64/256)", lambda: jt(starts, lens, postings))

    # the full production step (tiered, probe_width=24)
    def full_step(codes, lengths, bpacked, postings, tiers):
        t, s, m, st = sketch_match_step(
            codes, lengths, bpacked, postings,
            kmer_lengths=ks, sketch_fraction=0.05, sketch_caps=caps,
            chain_fraction=0.9, expand_per_read=cfg.expand_per_read,
            candidate_capacity=cfg.candidate_capacity, bucket_meta=metas,
            num_transcripts=T, match_tiers=tiers,
            tier_widths=(16, 64), probe_width=24 if tiers else None,
        )
        return t, s, m

    jfs = jax.jit(full_step, static_argnames=("tiers",))
    timeit("FULL STEP tiered", lambda: jfs(codes, lengths, bpacked, postings, tiers=True))
    timeit("FULL STEP flat", lambda: jfs(codes, lengths, bpacked, postings, tiers=False))


if __name__ == "__main__":
    main()
