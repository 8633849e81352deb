"""A/B: multi-k grouping-sort input — one full-width row sort vs per-k
row sorts + a bitonic merge (DESIGN known-gap 8's named fix).

The multi-k match concatenates K per-k event windows of width w into a
[B, K*w] row before the grouping sort; XLA's row sort is super-linear
in width (w*log^2 w comparator passes), so sorting the K parts
separately (same total lanes, fewer passes) and merging with log2(K*w)
compare-exchange stages should win ~15% of the sort stage.  The merge
is bit-identical to the full sort (asserted here and in
tests/test_rowmatch.py), so this is purely a perf decision.

Chained measurement: N iterations inside one jitted scan with an
iteration-to-iteration data dependency, per tier shape of the
GENCODE multi-k plan (B=8192 rows split 6/4/3/2/1 sixteenths, widths
from a representative calibration, tail = expand_per_read=256).

Usage: python scripts/profile_multik_merge.py
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

from sketch_rna_tpu.match.rowmatch import _bitonic_merge_pair

ITERS = 30
K = 2
# (rows, per-k width): tier plan for B=8192 with a representative
# GENCODE calibration (8, 16, 32, 64) + full-budget tail 256.
PLAN = ((3072, 8), (2048, 16), (1536, 32), (1024, 64), (512, 256))
# The per-batch tier shapes individually sit under the ~0.8 ms scan-
# iteration floor (first run: every shape measured 0.8 ms regardless of
# lanes); SCALE multiplies rows so the sort cost dominates the floor —
# per-batch cost = measured / SCALE.
SCALE = 16


def timed(fn, *args):
    fn(*args)[0].block_until_ready()  # compile
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / ITERS


def chain(sort_fn):
    """Scan ITERS sorts with a dependency: fold the previous output's
    first column back into the next input."""

    def step(carry, _):
        a, b, dep = carry
        out = sort_fn(a ^ (dep & 1), b)
        dep2 = out[:, :1]
        return (a, b, dep2), out[0, 0]

    def run(a, b):
        (_, _, dep), outs = jax.lax.scan(
            step, (a, b, jnp.zeros((a.shape[0], 1), jnp.int32)), None, length=ITERS
        )
        return dep, outs

    return jax.jit(run)


def main():
    rng = np.random.default_rng(7)
    total_full = total_merge = 0.0
    print(f"{'rows':>6} {'w':>4} {'full_ms':>9} {'merge_ms':>9} {'ratio':>6}")
    for rows0, w in PLAN:
        rows = rows0 * SCALE
        a = jnp.asarray(rng.integers(0, 2**31, size=(rows, w), dtype=np.int32))
        b = jnp.asarray(rng.integers(0, 2**31, size=(rows, w), dtype=np.int32))

        full = chain(lambda x, y: jnp.sort(jnp.concatenate([x, y], axis=1), axis=-1))
        merge = chain(
            lambda x, y: _bitonic_merge_pair(
                jnp.sort(x, axis=-1), jnp.sort(y, axis=-1)
            )
        )
        # bit-identity spot check at this shape
        got = np.asarray(_bitonic_merge_pair(jnp.sort(a, -1), jnp.sort(b, -1)))
        want = np.sort(np.concatenate([np.asarray(a), np.asarray(b)], 1), 1)
        assert (got == want).all(), (rows, w)

        t_full = timed(full, a, b)
        t_merge = timed(merge, a, b)
        total_full += t_full
        total_merge += t_merge
        print(
            f"{rows:>6} {w:>4} {t_full*1e3:>9.3f} {t_merge*1e3:>9.3f} "
            f"{t_merge/t_full:>6.2f}"
        )
    print(
        f"plan totals per batch (/SCALE): full {total_full/SCALE*1e3:.2f} ms, "
        f"merge {total_merge/SCALE*1e3:.2f} ms ({total_merge/total_full:.2f}x)"
    )


if __name__ == "__main__":
    main()
