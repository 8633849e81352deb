"""Ablation profile of the REAL match step: cumulative stage gates
inside one fused program, K=1 vs K=2, GENCODE index.

profile_multik_stages.py measures stages as separate programs, where
~2 ms dispatch floors per program swamp the real costs; this script
instead reimplements sketch_match_step's exact body with an early-exit
gate, so each timing is one fused XLA program and stage costs come from
DIFFERENCES between gates:

  sketch   : per-k hashing + fracminhash dedup
  probe    : + tiered bucket-table probe (production probe_width)
  perm     : + tier permutation (argsort by max-over-k totals + takes)
  expand   : + per-tier per-k posting expansion (production widths)
  group    : + grouping (per-k K=1 grouping + table intersection)

Usage: python scripts/profile_match_ablate.py
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

enable_compilation_cache()

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.artifact import load_index
from sketch_rna_tpu.io.packing import PackedReads
from sketch_rna_tpu.match.bucket_lookup import bucket_lookup
from sketch_rna_tpu.match.rowmatch import (
    _group_tier_parts,
    _is_per_k_widths,
    row_expand_from_runs,
    tier_plan,
    tier_rows,
)
from sketch_rna_tpu.pipeline import _device_index, _tier_widths_for
from sketch_rna_tpu.sketch.dispatch import sketch_all_k
from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome

STAGES = ("sketch", "probe", "perm", "expand", "group")


def step_until(
    stage,
    codes,
    lengths,
    bpacked,
    postings,
    *,
    ks,
    cfg,
    caps,
    metas,
    widths,
    probe_w,
    num_transcripts,
):
    """sketch_match_step's body, cut after `stage`; returns a scalar
    consuming every live intermediate so XLA can't dead-code it."""
    K = len(ks)
    B = codes.shape[0]
    acc = jnp.zeros((), jnp.int32)

    hs, ms = [], []
    for h, m, ov in sketch_all_k(codes, lengths, ks, cfg.sketch_fraction, caps):
        hs.append(h)
        ms.append(m)
        acc = acc + ov.astype(jnp.int32)
    if stage == "sketch":
        return acc + sum(jnp.sum(h[:, 0].astype(jnp.int32)) for h in hs)

    probe_tiered = probe_w is not None and B >= 1024 and probe_w < max(caps)
    if probe_tiered:
        nval = [jnp.sum(m.astype(jnp.int32), axis=1) for m in ms]
        pkey = nval[0]
        for v in nval[1:]:
            pkey = jnp.maximum(pkey, v)
        pperm = jnp.argsort(pkey).astype(jnp.int32)
        hs = [jnp.take(h, pperm, axis=0) for h in hs]
        ms = [jnp.take(m, pperm, axis=0) for m in ms]
        B0 = B - B // 16
    starts, lens_ = [], []
    for ki, cap in enumerate(caps):
        shift, mb = metas[ki]
        if probe_tiered and probe_w < cap:
            s0, l0 = bucket_lookup(
                hs[ki][:B0, :probe_w], ms[ki][:B0, :probe_w],
                bpacked[ki], shift=shift, mb=mb,
            )
            s1, l1 = bucket_lookup(
                hs[ki][B0:, :], ms[ki][B0:, :], bpacked[ki], shift=shift, mb=mb
            )
            pad = ((0, 0), (0, cap - probe_w))
            starts.append(jnp.concatenate([jnp.pad(s0, pad), s1], axis=0))
            lens_.append(jnp.concatenate([jnp.pad(l0, pad), l1], axis=0))
        else:
            s, ln = bucket_lookup(
                hs[ki], ms[ki], bpacked[ki], shift=shift, mb=mb
            )
            starts.append(s)
            lens_.append(ln)
    if stage == "probe":
        return acc + sum(jnp.sum(l) for l in lens_)

    totals = [jnp.sum(l, axis=1) for l in lens_]
    tkey = totals[0]
    for t in totals[1:]:
        tkey = jnp.maximum(tkey, t)
    perm = jnp.argsort(tkey).astype(jnp.int32)
    starts_p = [jnp.take(s, perm, axis=0) for s in starts]
    lens_p = [jnp.take(l, perm, axis=0) for l in lens_]
    if stage == "perm":
        return acc + sum(jnp.sum(l[:, 0]) for l in lens_p) + jnp.sum(perm[:3])

    # NOTE: production K>1 now runs INDEPENDENT per-k pipelines
    # (rowmatch._row_match_per_k_tiered); this gated body keeps the
    # round-5 measurement shape (shared permutation) for comparability —
    # collapse per-k calibrations to the shared form.
    per_k = _is_per_k_widths(widths)
    if per_k:
        from sketch_rna_tpu.match.rowmatch import shared_tier_widths

        widths = shared_tier_widths(widths)
        per_k = False
    plan = tier_plan(B, cfg.expand_per_read, widths)
    row0 = 0
    tier_parts = []
    for t_i, (rows, w) in enumerate(plan):
        parts = []
        for ki in range(K):
            w_k = w
            s_t = jax.lax.slice_in_dim(starts_p[ki], row0, row0 + rows, axis=0)
            l_t = jax.lax.slice_in_dim(lens_p[ki], row0, row0 + rows, axis=0)
            key, d = row_expand_from_runs(
                s_t, l_t, postings[ki], events_per_read=w_k, k_index=0, num_k=1
            )
            parts.append(key)
            acc = acc + d
        tier_parts.append(parts)
        row0 += rows
    if stage == "expand":
        return acc + sum(
            jnp.sum(p[:, 0] & 1) for parts in tier_parts for p in parts
        )

    for parts in tier_parts:
        res = _group_tier_parts(
            parts,
            num_k=K,
            chain_fraction=cfg.chain_fraction,
            candidate_capacity=cfg.candidate_capacity,
            num_transcripts=num_transcripts,
        )
        acc = acc + jnp.sum(res.tid[:, 0]) + jnp.sum(res.score[:, 0])
    return acc


def timeit(fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def run(ks, cachef, epr, codes, lengths):
    idx = load_index(os.path.join("/tmp/sketch_scale_cache", cachef))
    cfg = QuantConfig(
        kmer_lengths=ks, em_dtype="float32", max_read_len=256, expand_per_read=epr
    )
    L = 256
    caps = tuple(cfg.sketch_capacity_for(k, L) for k in ks)
    bpacked, postings, metas = _device_index(idx, ks)
    packed = PackedReads(codes, lengths, [])
    widths, probe_w = _tier_widths_for(idx, packed, cfg, bpacked, metas, caps, ks, L)
    print(f"ks={ks} epr={epr} widths={widths} probe_w={probe_w}")
    prev = 0.0
    for stage in STAGES:
        # Index arrays as jit ARGUMENTS (closures embed ~100 MB of
        # constants in the HLO -> remote-compile 413).
        f = jax.jit(
            lambda c, l, bp, po, stage=stage: step_until(
                stage, c, l, bp, po,
                ks=ks, cfg=cfg, caps=caps, metas=metas, widths=widths,
                probe_w=probe_w, num_transcripts=idx.num_transcripts,
            )
        )
        t = timeit(f, codes, lengths, bpacked, postings)
        print(f"  through {stage:7s}: {t*1e3:8.3f} ms  (+{(t-prev)*1e3:6.3f})",
              flush=True)
        prev = t
    return prev


def main():
    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, 250000)
    codes, lengths = sample_reads_device(seqs, 8192, 150, 256, 7)
    jax.block_until_ready((codes, lengths))
    t1 = run((31,), "T250000_k31.npz", 256, codes, lengths)
    t2 = run((21, 31), "T250000_k21_31.npz", 512, codes, lengths)
    print(f"K=2 / K=1 = {t2/t1:.2f}x")


if __name__ == "__main__":
    main()
