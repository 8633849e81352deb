"""Multi-k cost decomposition at GENCODE scale: is the overhead per-k
work or K-coupling?

Round-5 question: GENCODE {21,31} match_scan measures ~3.5 s/1M reads
vs single-k 31's ~0.95 s — 3.7x, far beyond the ~2x structural work.
The round-4 attribution (grouping-sort width, DESIGN known-gap 8) was
refuted by scripts/profile_multik_merge.py (the sort is latency-bound;
per-k sorts + bitonic merge measure ~neutral).

The decisive A/B here: time the PRODUCTION fused step for k=21 alone
(K=1), k=31 alone (K=1), and {21,31} (K=2), same reads, each k against
its own index slice.  If t(21)+t(31) ~= t(21,31), multi-k overhead is
just per-k work (k=21 being intrinsically more expensive: bigger
posting lists / wider probe rows); if t(21,31) >> t(21)+t(31), the
K>1 coupling (grouping branch, shared tier permutation) is the cost
and gets attacked.

Index arrays are passed as jit ARGUMENTS (closing over them embeds
~100 MB of constants in the HLO and trips the remote-compile size cap).

Usage: python scripts/profile_multik_stages.py
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

enable_compilation_cache()

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.artifact import load_index
from sketch_rna_tpu.io.packing import PackedReads
from sketch_rna_tpu.pipeline import _device_index, _tier_widths_for, sketch_match_step
from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome


def timeit(name, fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"  {name:46s} {best*1e3:8.3f} ms/batch", flush=True)
    return best


@partial(
    jax.jit,
    static_argnames=(
        "kmer_lengths", "sketch_fraction", "sketch_caps", "chain_fraction",
        "expand_per_read", "candidate_capacity", "bucket_meta",
        "num_transcripts", "match_tiers", "tier_widths", "probe_width",
    ),
)
def step(codes, lengths, bpacked, postings, **kw):
    return sketch_match_step(codes, lengths, bpacked, postings, **kw)[0]


def run_one(name, idx, ks, epr, codes, lengths, cfg_base):
    cfg = QuantConfig(
        kmer_lengths=ks, em_dtype="float32", max_read_len=256, expand_per_read=epr
    )
    L = 256
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    bpacked, postings, metas = _device_index(idx, ks)
    packed = PackedReads(codes, lengths, [])
    widths, probe_w = _tier_widths_for(idx, packed, cfg, bpacked, metas, caps, ks, L)
    for ki, k in enumerate(ks):
        print(
            f"  [k={k}] keys={idx.per_k[k].num_keys/1e6:.1f}M "
            f"postings={postings[ki].shape[0]/1e6:.1f}M mb={metas[ki][1]} "
            f"cap={caps[ki]}"
        )
    print(f"  tier_widths={widths} probe_w={probe_w}")
    t = timeit(
        name,
        lambda c, l: step(
            c, l, bpacked, postings,
            kmer_lengths=ks,
            sketch_fraction=cfg.sketch_fraction,
            sketch_caps=caps,
            chain_fraction=cfg.chain_fraction,
            expand_per_read=epr,
            candidate_capacity=cfg.candidate_capacity,
            bucket_meta=metas,
            num_transcripts=idx.num_transcripts,
            match_tiers=True,
            tier_widths=widths,
            probe_width=probe_w,
        ),
        codes,
        lengths,
    )
    return t


def main():
    cfg = QuantConfig(kmer_lengths=(31,), em_dtype="float32", max_read_len=256)
    B = cfg.batch_size
    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, 250000)
    codes, lengths = sample_reads_device(seqs, B, 150, 256, 7)
    jax.block_until_ready((codes, lengths))

    idx31 = load_index("/tmp/sketch_scale_cache/T250000_k31.npz")
    idx2 = load_index("/tmp/sketch_scale_cache/T250000_k21_31.npz")

    t31 = run_one("k=31 alone (K=1)", idx31, (31,), 256, codes, lengths, cfg)
    # k=21 alone, sliced from the multi-k artifact
    t21 = run_one("k=21 alone (K=1)", idx2, (21,), 256, codes, lengths, cfg)
    t_both = run_one("{21,31} (K=2)", idx2, (21, 31), 512, codes, lengths, cfg)
    print(
        f"\n  sum of singles {1e3*(t21+t31):.2f} ms vs K=2 {1e3*t_both:.2f} ms "
        f"-> coupling overhead {1e3*(t_both-t21-t31):+.2f} ms/batch "
        f"({t_both/(t21+t31):.2f}x)"
    )
    print(
        f"  per-1M-read scan: k31 {t31*128:.2f} s, k21 {t21*128:.2f} s, "
        f"K=2 {t_both*128:.2f} s"
    )


if __name__ == "__main__":
    main()
