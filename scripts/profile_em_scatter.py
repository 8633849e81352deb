"""Micro-bench: posterior-sum strategies for the EM inner loop.

Compares per-iteration cost of
  a) scatter-add in read layout (current run_em_tables),
  b) scatter-add over tid-sorted pairs (precomputed permutation;
     sorted indices may hit a faster XLA scatter path),
  c) jax.ops.segment_sum with indices_are_sorted=True on sorted pairs.
"""

import sys, os, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

enable_compilation_cache()

N = int(sys.argv[1]) if len(sys.argv) > 1 else 204800
W = int(sys.argv[2]) if len(sys.argv) > 2 else 16
T = int(sys.argv[3]) if len(sys.argv) > 3 else 50000
# All data generated ON DEVICE (host numpy is too slow here).
key = jax.random.PRNGKey(0)
k1, k2 = jax.random.split(key)
# Skewed popularity: square a uniform to concentrate mass.
u = jax.random.uniform(k1, (N, W))
tid = (u * u * T).astype(jnp.int32)
post = jax.random.uniform(k2, (N, W), dtype=jnp.float32)

flat = tid.reshape(-1)
tid_sorted, perm = jax.lax.sort((flat, jnp.arange(N * W, dtype=jnp.int32)), num_keys=1)
jax.block_until_ready((tid, post, tid_sorted, perm))


def timeit(name, fn, *args, n=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    print(f"{name:34s} {(time.perf_counter()-t0)/n*1000:8.2f} ms", flush=True)


@jax.jit
def f_scatter(post):
    return jnp.zeros(T, jnp.float32).at[tid.reshape(-1)].add(post.reshape(-1))


@jax.jit
def f_scatter_sorted(post):
    ps = post.reshape(-1)[perm]
    return jnp.zeros(T, jnp.float32).at[tid_sorted].add(ps)


@jax.jit
def f_segsum_sorted(post):
    ps = post.reshape(-1)[perm]
    return jax.ops.segment_sum(ps, tid_sorted, num_segments=T, indices_are_sorted=True)


@jax.jit
def f_segsum_unsorted(post):
    return jax.ops.segment_sum(post.reshape(-1), tid.reshape(-1), num_segments=T)


# (e) NO scatter at all: cumsum over tid-sorted lanes + per-transcript
# segment boundaries precomputed ONCE (static across EM iterations):
# ps[t] = cum[pos[t+1]] - cum[pos[t]] — two [T] gathers from the cumsum.
pos = jnp.searchsorted(tid_sorted, jnp.arange(T + 1, dtype=jnp.int32)).astype(
    jnp.int32
)
jax.block_until_ready(pos)


@jax.jit
def f_cumsum_diff(post):
    ps = post.reshape(-1)[perm]
    cum = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(ps)])
    return cum[pos[1:]] - cum[pos[:-1]]


# (f) pi-gather alone (the other half of the e_step), for the split.
pi0 = jnp.full(T, 1.0 / T, jnp.float32)


@jax.jit
def f_pigather(pi):
    w = pi[tid] * post
    denom = jnp.sum(w, axis=1, keepdims=True)
    return w / denom


# (g) transcript-major transpose: static gather map [T, Wt] of lane
# positions (built once), per-iteration = gather + row-sum + small
# spill scatter.  No precision hazard: sums stay per-transcript.
WT = 8
n_lanes = N * W
seg_start = pos[:-1]
seg_len = pos[1:] - pos[:-1]
gcols = seg_start[:, None] + jnp.arange(WT, dtype=jnp.int32)[None, :]
gvalid = jnp.arange(WT, dtype=jnp.int32)[None, :] < seg_len[:, None]
gmap = jnp.where(gvalid, jnp.take(jnp.concatenate([perm, jnp.zeros(WT, jnp.int32)]),
                                  jnp.minimum(gcols, n_lanes - 1)), n_lanes)
# Spill lanes: sorted positions past each segment's first WT.
lane_rank = jnp.arange(n_lanes, dtype=jnp.int32) - seg_start[tid_sorted]
spill_mask = lane_rank >= WT
n_spill = int(jnp.sum(spill_mask))
sp_order = jnp.argsort(~spill_mask, stable=True)[:max(n_spill, 1)]
spill_src = perm[sp_order]
spill_tid = tid_sorted[sp_order]
jax.block_until_ready((gmap, spill_src, spill_tid))


@jax.jit
def f_transpose(post):
    pf = jnp.concatenate([post.reshape(-1), jnp.zeros(1, jnp.float32)])
    ps = jnp.sum(pf[gmap], axis=1)
    if n_spill:
        ps = ps.at[spill_tid].add(pf[spill_src])
    return ps


# (h) the production scatter-free path: segmented associative scan over
# blocks with a static plan (em/segsum.py).
from sketch_rna_tpu.em.segsum import build_segsum_plan, segsum_apply

seg_plan = build_segsum_plan(flat, T)
jax.block_until_ready(seg_plan)


@jax.jit
def f_segsum_plan(post):
    return segsum_apply(seg_plan, post.reshape(-1))


if __name__ == "__main__" and "--chained" not in sys.argv:
    # Independent-call timings; chained_report below keeps every
    # iteration inside one program.
    print(f"N={N} W={W} T={T} lanes={N*W}", flush=True)
    timeit("scatter (read layout)", f_scatter, post)
    timeit("gather-perm + sorted scatter", f_scatter_sorted, post)
    timeit("gather-perm + sorted segsum", f_segsum_sorted, post)
    timeit("unsorted segment_sum", f_segsum_unsorted, post)
    timeit("cumsum + static seg-diff gathers", f_cumsum_diff, post)
    timeit("pi-gather + rownorm only", f_pigather, pi0)
    print(f"transpose: WT={WT} spill={n_spill} ({n_spill/(N*W):.1%} of lanes)",
          flush=True)
    timeit("transpose gather+rowsum (+spill)", f_transpose, post)
    timeit("segsum plan (production path)", f_segsum_plan, post)
    np.testing.assert_allclose(
        np.asarray(f_transpose(post)), np.asarray(f_scatter(post)), rtol=2e-3,
        atol=1e-3,
    )
    print("transpose == scatter (2e-3): OK", flush=True)
    np.testing.assert_allclose(
        np.asarray(f_segsum_plan(post)), np.asarray(f_scatter(post)), rtol=2e-3,
        atol=1e-3,
    )
    print("segsum_plan == scatter (2e-3): OK", flush=True)


# --- chained variants ------------------------------------------------------
# These run the REAL EM e-step shape — pi-gather + row-normalize +
# posterior-accumulate — as a 20-iteration fori_loop with pi feedback
# inside ONE program, exactly like run_em's while_loop.

def _chained(accumulate, iters=20):
    @jax.jit
    def run(pi):
        def body(_, pi):
            w = pi[tid] * post
            denom = jnp.sum(w, axis=1, keepdims=True)
            p = w / jnp.maximum(denom, 1e-10)
            ps = accumulate(p)
            return ps + jnp.float32(0.01)
        return jax.lax.fori_loop(0, iters, body, pi)
    return run


def chained_report():
    iters = 20
    variants = {
        "scatter": lambda p: jnp.zeros(T, jnp.float32).at[tid.reshape(-1)].add(
            p.reshape(-1)
        ),
        "segsum plan": lambda p: segsum_apply(seg_plan, p.reshape(-1)),
        "unsorted segment_sum": lambda p: jax.ops.segment_sum(
            p.reshape(-1), tid.reshape(-1), num_segments=T
        ),
    }
    results = {}
    for name, acc in variants.items():
        f = _chained(acc, iters)
        jax.block_until_ready(f(pi0))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = f(pi0)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        results[name] = best / iters
        print(f"CHAINED e-step + {name:22s} {best/iters*1000:8.2f} ms/iter",
              flush=True)
    return results


if __name__ == "__main__" and "--chained" in sys.argv:
    print(f"N={N} W={W} T={T} lanes={N*W} (chained)", flush=True)
    chained_report()
