"""A/B: inline the first two postings into the bucket rows (DESIGN
known-gap 7 — resolve short posting runs without the per-hash postings
gather).

Average posting-run length at GENCODE scale is ~1.8, so offsets 0/1
cover most real event lanes; storing postings[start] and
postings[start+1] inside the probe row lets the expansion skip its
latency-bound postings gather for those lanes, at the cost of a wider
(5-section) bucket row.

Chained measurement: 30 probe+expand iterations inside one program
with a result->mask dependency, so per-iteration time is device time.

Usage: python scripts/profile_probe_inline.py [index.npz]
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
from sketch_rna_tpu.match.bucket_lookup import bucket_lookup, bucket_table_shape
from sketch_rna_tpu.pipeline import _padded_index_arrays
from sketch_rna_tpu.sketch.fracminhash import sketch_batch
from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome

_I32_MAX = np.int32(2**31 - 1)


def shape5(keys, target_load=2, max_row_lanes=128):
    """bucket_table_shape with 5 sections per row instead of 3."""
    U = int(keys.shape[0])
    nb = 1 << max(10, min(22, (max(U // target_load, 1)).bit_length()))
    max_key = int(keys.max()) if U else 0
    shift = 0
    while (max_key >> shift) >= nb:
        shift += 1
    b = (keys.astype(np.uint64) >> shift).astype(np.int64)
    counts = np.bincount(b, minlength=nb) if U else np.zeros(nb, np.int64)
    while nb > 1024:
        merged = counts.reshape(-1, 2).sum(axis=1)
        if 5 * max(int(merged.max()) if U else 0, 1) > max_row_lanes:
            break
        counts = merged
        nb >>= 1
        shift += 1
    mb = max(int(counts.max()) if U else 0, 1)
    return nb, mb, shift


def build5_device(keys, row_ptr, postings, *, nb, mb, shift):
    U = keys.shape[0]
    P = postings.shape[0]
    b = (keys >> jnp.uint32(shift)).astype(jnp.int32)
    counts = jnp.zeros(nb, jnp.int32).at[b].add(1)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    within = jnp.arange(U, dtype=jnp.int32) - starts[b]
    flat = jnp.zeros(nb * 5 * mb, jnp.int32)
    key_slots = (jnp.arange(nb * 5 * mb, dtype=jnp.int32) % (5 * mb)) < mb
    flat = jnp.where(key_slots, jnp.int32(-1), flat)
    base = b * (5 * mb) + within
    rp = row_ptr[:-1].astype(jnp.int32)
    lens = (row_ptr[1:] - row_ptr[:-1]).astype(jnp.int32)
    p0 = postings[jnp.clip(rp, 0, P - 1)]
    p1 = postings[jnp.clip(rp + 1, 0, P - 1)]
    flat = flat.at[base].set(jax.lax.bitcast_convert_type(keys, jnp.int32))
    flat = flat.at[base + mb].set(rp)
    flat = flat.at[base + 2 * mb].set(lens)
    flat = flat.at[base + 3 * mb].set(p0)
    flat = flat.at[base + 4 * mb].set(p1)
    return flat.reshape(nb, 5 * mb)


def lookup5(hashes, mask, packed, *, shift, mb):
    nb = packed.shape[0]
    b = (hashes >> jnp.uint32(shift)).astype(jnp.int32)
    b = jnp.minimum(b, nb - 1)
    rows = packed[b]
    h_i = jax.lax.bitcast_convert_type(hashes, jnp.int32)[..., None]
    eq = (rows[..., :mb] == h_i) & mask[..., None]
    start = jnp.sum(jnp.where(eq, rows[..., mb : 2 * mb], 0), axis=-1)
    length = jnp.sum(jnp.where(eq, rows[..., 2 * mb : 3 * mb], 0), axis=-1)
    p0 = jnp.sum(jnp.where(eq, rows[..., 3 * mb : 4 * mb], 0), axis=-1)
    p1 = jnp.sum(jnp.where(eq, rows[..., 4 * mb : 5 * mb], 0), axis=-1)
    return start, length, p0, p1


def expand(start, length, postings, Epr, p0=None, p1=None):
    B, S = start.shape
    P = postings.shape[0]
    cum = jnp.cumsum(length, axis=1)
    total = cum[:, -1:]
    j = jnp.arange(Epr, dtype=jnp.int32)[None, :]
    run_begin = jnp.zeros((B, Epr), jnp.int32)
    sel_start = jnp.broadcast_to(start[:, 0:1], (B, Epr))
    if p0 is not None:
        sel_p0 = jnp.broadcast_to(p0[:, 0:1], (B, Epr))
        sel_p1 = jnp.broadcast_to(p1[:, 0:1], (B, Epr))
    for s in range(1, S):
        le = cum[:, s - 1 : s] <= j
        run_begin = jnp.where(le, cum[:, s - 1 : s], run_begin)
        sel_start = jnp.where(le, start[:, s : s + 1], sel_start)
        if p0 is not None:
            sel_p0 = jnp.where(le, p0[:, s : s + 1], sel_p0)
            sel_p1 = jnp.where(le, p1[:, s : s + 1], sel_p1)
    valid = j < total
    off = j - run_begin
    if p0 is not None:
        gathered_lane = valid & (off >= 2)
        p_idx = jnp.where(gathered_lane, jnp.clip(sel_start + off, 0, P - 1), 0)
        tid_g = postings[p_idx]
        tid_ev = jnp.where(off == 0, sel_p0, jnp.where(off == 1, sel_p1, tid_g))
    else:
        p_idx = jnp.where(valid, jnp.clip(sel_start + off, 0, P - 1), 0)
        tid_ev = postings[p_idx]
    return jnp.where(valid, tid_ev, _I32_MAX)


def main():
    idx_path = (
        sys.argv[1] if len(sys.argv) > 1 else "/tmp/sketch_scale_cache/T250000_k31.npz"
    )
    idx = load_index(idx_path)
    ks = tuple(idx.kmer_lengths)
    cfg = QuantConfig(kmer_lengths=ks, em_dtype="float32", max_read_len=256)
    B, L = cfg.batch_size, 152
    k = ks[0]
    cap = cfg.sketch_capacity_for(k, L)
    keys_h, row_ptr_h, postings_h = _padded_index_arrays(idx, (k,))
    keys_h, row_ptr_h, postings_h = keys_h[0], row_ptr_h[0], postings_h[0]
    lens_h = row_ptr_h[1:] - row_ptr_h[:-1]
    frac2 = (lens_h <= 2).mean()
    # event-lane coverage: offsets 0/1 of every run
    cov = np.minimum(lens_h, 2).sum() / lens_h.sum()
    print(f"k={k} keys={keys_h.size} postings={postings_h.size} "
          f"runs<=2: {frac2:.1%} of keys; inline covers {cov:.1%} of event lanes",
          flush=True)

    nb3, mb3, sh3 = bucket_table_shape(keys_h)
    nb5, mb5, sh5 = shape5(keys_h)
    print(f"3-section: nb={nb3} mb={mb3} lanes={3*mb3} "
          f"({nb3*3*mb3*4/1e6:.0f} MB) | 5-section: nb={nb5} mb={mb5} "
          f"lanes={5*mb5} ({nb5*5*mb5*4/1e6:.0f} MB)", flush=True)

    keys_d = jnp.asarray(keys_h)
    rp_d = jnp.asarray(np.asarray(row_ptr_h, np.int32))
    post_d = jnp.asarray(np.asarray(postings_h, np.int32))
    from sketch_rna_tpu.match.bucket_lookup import build_bucket_table_device

    t3 = build_bucket_table_device(keys_d, rp_d, nb=nb3, mb=mb3, shift=sh3)
    t5 = build5_device(keys_d, rp_d, post_d, nb=nb5, mb=mb5, shift=sh5)

    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, idx.num_transcripts)
    codes, lengths = sample_reads_device(seqs, B, 150, L, 7)
    h, m, _ = jax.jit(
        lambda c, l: sketch_batch(c, l, k, 0.05, cap)
    )(codes, lengths)
    W0 = 16  # tiered probe width (production: calibrated ~16)
    Epr = 64
    h0, m0 = h[:, :W0], m[:, :W0]

    ITERS = 30

    def chained(step):
        @jax.jit
        def run(h0, m0, t, post):
            def body(i, carry):
                hc, mc, acc = carry
                keym = step(hc, mc, t, post)
                s = jnp.sum(jnp.where(keym != _I32_MAX, keym, 0))
                # result -> next-iteration dependency XLA cannot fold
                mc2 = mc & (s >= jnp.int32(-1))
                return hc, mc2, acc + s
            return jax.lax.fori_loop(0, ITERS, body, (h0, m0, jnp.int32(0)))[2]
        return run

    def step3(hc, mc, t, post):
        st, ln = bucket_lookup(hc, mc, t, shift=sh3, mb=mb3)
        return expand(st, ln, post, Epr)

    def step5_inline(hc, mc, t, post):
        st, ln, p0, p1 = lookup5(hc, mc, t, shift=sh5, mb=mb5)
        return expand(st, ln, post, Epr, p0, p1)

    def step5_noinline(hc, mc, t, post):
        st, ln, _p0, _p1 = lookup5(hc, mc, t, shift=sh5, mb=mb5)
        return expand(st, ln, post, Epr)

    # correctness first (host): keys sorted per-read events identical
    a = np.sort(np.asarray(step3(h0, m0, t3, post_d)), axis=1)
    bb = np.sort(np.asarray(step5_inline(h0, m0, t5, post_d)), axis=1)
    assert np.array_equal(a, bb), "inline expansion changed events!"
    print("inline == baseline events: OK", flush=True)

    for name, f, t in (
        ("3-section + full gather", step3, t3),
        ("5-section + inline p0/p1", step5_inline, t5),
        ("5-section + full gather (row-width control)", step5_noinline, t5),
    ):
        run = chained(f)
        jax.block_until_ready(run(h0, m0, t, post_d))  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(h0, m0, t, post_d))
            best = min(best, (time.perf_counter() - t0) / ITERS)
        print(f"{name:46s} {best*1000:9.3f} ms/iter", flush=True)


if __name__ == "__main__":
    main()
