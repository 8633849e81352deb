"""Component-level device profiling of the current quant step (dev tool)."""

import sys, os, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from bench import build_problem
from sketch_rna_tpu.pipeline import _device_index
from sketch_rna_tpu.sketch.fracminhash import sketch_batch
from sketch_rna_tpu.hash.nthash import nthash_batch_u32
from sketch_rna_tpu.match.bucket_lookup import bucket_lookup
from sketch_rna_tpu.match.rowmatch import row_expand_from_runs, row_events_to_candidates


def timeit(name, fn, *args, n=5):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:34s} {dt*1000:9.2f} ms", flush=True)
    return dt


def main():
    cfg, idx, packed, _ = build_problem()
    ks = tuple(idx.kmer_lengths)
    k0 = ks[0]
    caps = tuple(cfg.sketch_capacity_for(k) for k in ks)
    bpacked, postings, metas = _device_index(idx, ks)
    bp0 = jnp.asarray(bpacked[0])
    post0 = jnp.asarray(postings[0])
    shift, mb = metas[0]
    B = cfg.batch_size
    codes = packed.codes[:B]
    lengths = packed.lengths[:B]
    print(f"B={B} bucket_mb={mb} P={post0.shape} Epr={cfg.expand_per_read}", flush=True)

    timeit("dispatch", jax.jit(lambda c: c.sum()), codes)
    timeit("hash only", jax.jit(lambda c: nthash_batch_u32(c, k0)), codes)

    f_sk = jax.jit(lambda c, l: sketch_batch(c, l, k0, cfg.sketch_fraction, caps[0]))
    timeit("sketch (hash+2 sorts)", f_sk, codes, lengths)

    @jax.jit
    def f_lk(c, l):
        h, m, _ = sketch_batch(c, l, k0, cfg.sketch_fraction, caps[0])
        return bucket_lookup(h, m, bp0, shift=shift, mb=mb)

    timeit("+bucket lookup", f_lk, codes, lengths)

    @jax.jit
    def f_ex(c, l):
        h, m, _ = sketch_batch(c, l, k0, cfg.sketch_fraction, caps[0])
        s, ln = bucket_lookup(h, m, bp0, shift=shift, mb=mb)
        return row_expand_from_runs(s, ln, post0, events_per_read=cfg.expand_per_read,
                                    k_index=0, num_k=1)

    timeit("+row expand", f_ex, codes, lengths)

    @jax.jit
    def f_full(c, l):
        h, m, _ = sketch_batch(c, l, k0, cfg.sketch_fraction, caps[0])
        s, ln = bucket_lookup(h, m, bp0, shift=shift, mb=mb)
        key, d = row_expand_from_runs(s, ln, post0, events_per_read=cfg.expand_per_read,
                                      k_index=0, num_k=1)
        r = row_events_to_candidates(key, num_k=1, chain_fraction=cfg.chain_fraction,
                                     candidate_capacity=cfg.candidate_capacity)
        return r.tid, r.score, r.mask

    dt = timeit("full step", f_full, codes, lengths)
    print(f"==> device step reads/s: {B/dt:,.0f}", flush=True)


if __name__ == "__main__":
    main()
