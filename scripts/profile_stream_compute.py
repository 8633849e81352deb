"""Streaming scan rate without the host feed: device-resident chunks A/B.

The file->CSV streaming run pays per-chunk host-to-device copies on
top of the chunk programs.  This script bounds the compute-only rate
in one run: the same chunk program (2-bit unpack + chunk_match_classes
+ class-buffer append, production config) loops over chunks that are
already on device, so the feed never appears.  If this rate matches
the fused path's per-read rate, the streaming residual is the feed;
if not, it is compute.

Usage: python scripts/profile_stream_compute.py [n_chunks]
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
from sketch_rna_tpu.io.packing import PackedReads
from sketch_rna_tpu.pipeline import _device_index, _tier_widths_for
from sketch_rna_tpu.stream import _ClassBuffer, _unpack2, chunk_match_classes
from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome


def main():
    n_chunks = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    idx = load_index("/tmp/sketch_scale_cache/T250000_k31.npz")
    cfg = QuantConfig(kmer_lengths=(31,), em_dtype="float32")
    ks = (31,)
    B = cfg.batch_size
    C = cfg.candidate_capacity
    L = 152  # the 32M FASTQ's 150 bp rounded to the 8-multiple pad
    chunk_reads = cfg.stream_chunk_reads
    nb = chunk_reads // B

    bpacked, postings, metas = _device_index(idx, ks)
    for p in (*bpacked, *postings):
        np.asarray(p[(0,) * p.ndim])
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)

    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, 250000)
    codes, lengths = sample_reads_device(seqs, chunk_reads, 150, L, 11)
    packed = PackedReads(codes, lengths, [])
    widths, probe_w = _tier_widths_for(idx, packed, cfg, bpacked, metas, caps, ks, L)
    print(f"tier_widths={widths} probe_w={probe_w}", flush=True)

    # Device-resident 2-bit chunk (exactly what the feed ships), so the
    # loop's first op is the same unpack the production path runs.
    codes2 = jnp.asarray(
        PackedReads(np.asarray(codes), np.asarray(lengths), []).bit_packed().codes2
    )
    lengths_dev = jnp.asarray(np.asarray(lengths), jnp.int32)
    jax.block_until_ready((codes2, lengths_dev))

    nw = int(cfg.stream_narrow_width)
    wcap = 1 << 16
    m_cap = cfg.stream_class_capacity
    buf = _ClassBuffer(m_cap, nw, True)
    buf_w = _ClassBuffer(max(1 << 18, 4 * wcap), C, True)

    def one_chunk():
        cd = _unpack2(codes2, L).reshape(nb, B, L)
        ld = lengths_dev.reshape(nb, B)
        out = chunk_match_classes(
            cd,
            ld,
            bpacked,
            postings,
            kmer_lengths=ks,
            sketch_fraction=cfg.sketch_fraction,
            sketch_caps=caps,
            chain_fraction=cfg.chain_fraction,
            expand_per_read=cfg.expand_per_read,
            candidate_capacity=C,
            bucket_meta=metas,
            num_transcripts=idx.num_transcripts,
            match_tiers=cfg.match_tiers,
            tier_widths=widths,
            probe_width=probe_w,
            narrow_width=nw,
            wide_capacity=wcap,
        )
        (nb_t, nb_s, nb_w, n_cls, bw_t, bw_s, bw_w, n_wide, ncm, st) = out
        buf.ensure_room(nb * B, "compute-ab")
        buf_w.ensure_room(wcap, "compute-ab-wide")
        buf.append(nb_t, nb_s, nb_w, n_cls)
        buf_w.append(bw_t, bw_s, bw_w, n_wide)
        return st

    one_chunk()  # compile + first append
    jax.block_until_ready(buf.weight)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        one_chunk()
    jax.block_until_ready(buf.weight)
    dt = time.perf_counter() - t0
    reads = n_chunks * chunk_reads
    print(
        f"compute-only scan: {reads} reads in {dt:.2f} s = "
        f"{reads/dt:,.0f} reads/s (no per-chunk H2D; includes 2-bit "
        f"unpack, match, pre-dedup, buffer append)",
        flush=True,
    )


if __name__ == "__main__":
    main()
