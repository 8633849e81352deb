"""EM abundance estimation + soft read assignment over flat candidate
pairs (CSR view of the read -> candidate bipartite graph).

Reference semantics preserved exactly (SURVEY.md §7.0 contracts #5, #6):
  - E-step posterior(t | r) = pi[t]*count / sum over r's candidates, with
    zero contribution when the denominator <= 1e-10
    (src/isoform_assignment.cpp:30-51),
  - M-step pi[t] = posterior_sum[t] + pseudocount/R + pseudocount,
    UNNORMALIZED, pseudocount a float32 0.01 and pseudocount/R divided in
    float32 before promotion (src/isoform_assignment.cpp:54-60),
  - stop when the L1 change over ALL transcripts drops below the
    threshold, checked after the update (src/isoform_assignment.cpp:62-64),
  - assignment uses the final pi with guard total > 0.0
    (src/isoform_assignment.cpp:70-97).

Device shape (SURVEY.md §3.4): pairs are flat arrays (read, tid, score); the
E-step is two gathers + a multiply, per-read denominators and
per-transcript posterior sums are segment-sums, and the convergence loop
runs inside one jitted lax.while_loop.  Under shard_map, reads are
sharded over the data axis and the per-transcript sums are merged with a
psum — the cross-host all-reduce the reference's serial accumulation
becomes (SURVEY.md §5 "Distributed communication backend").

Pair padding convention: padded lanes carry score == 0 (inert in every
sum) and pair_read == read_capacity (an extra sentinel segment).
num_reads is the GLOBAL R (all valid reads, with or without candidates,
= homologous_segments.size()).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sketch_rna_tpu.em.segsum import plan_from_tables, segsum_apply


def _psum_maybe(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def resolve_em_segsum(mode: str) -> bool:
    """Map the config's em_segsum mode to a decision (see em/segsum.py).

    Auto policy: the plain duplicate-index scatter.  The sorted
    segmented scan beat it at no tested shape on the accelerator the
    design was first tuned on; it stays selectable ("on") and has not
    been re-timed on the GPU yet (ROADMAP Speed item 5).
    """
    return mode == "on"


@partial(
    jax.jit,
    static_argnames=(
        "num_transcripts",
        "read_capacity",
        "max_iterations",
        "convergence_threshold",
        "pseudocount",
        "epsilon",
        "dtype",
        "axis_name",
    ),
)
def run_em(
    pair_read: jnp.ndarray,
    pair_tid: jnp.ndarray,
    pair_score: jnp.ndarray,
    num_reads: jnp.ndarray,
    *,
    num_transcripts: int,
    read_capacity: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the EM loop; returns (pi [T], iterations_run []).

    pair_read holds local read rows in [0, read_capacity]; the value
    read_capacity is the padding sentinel.
    """
    T = num_transcripts
    dt = jnp.dtype(dtype)
    score = pair_score.astype(dt)
    read_ids = pair_read.astype(jnp.int32)
    n_seg = read_capacity + 1

    pi0 = jnp.full(T, 1.0 / T, dtype=dt)

    # C++: float pseudocount = 0.01; 'pseudocount / R' divides in float32
    # (size_t -> float conversion), each addition then promotes.
    pcf = jnp.float32(pseudocount)
    # Both addends stay at float32 precision before promotion, and the
    # additions run in the C++ source order — (posterior_sum + pc/R) + pc
    # left-to-right (src/isoform_assignment.cpp:54-60) — so float64 runs
    # match the reference to the last ulp.
    term_div = (pcf / num_reads.astype(jnp.float32)).astype(dt)
    term_pc = pcf.astype(dt)

    def e_step(pi):
        w = pi[pair_tid] * score
        denom = jax.ops.segment_sum(w, read_ids, num_segments=n_seg)
        inv = jnp.where(denom > jnp.asarray(epsilon, dt), 1.0 / denom, jnp.asarray(0, dt))
        post = w * inv[read_ids]
        ps = jax.ops.segment_sum(post, pair_tid, num_segments=T)
        return _psum_maybe(ps, axis_name)

    def cond(state):
        _, it, done = state
        return (it < max_iterations) & jnp.logical_not(done)

    def body(state):
        pi, it, _ = state
        new_pi = (e_step(pi) + term_div) + term_pc
        change = jnp.sum(jnp.abs(new_pi - pi))
        return new_pi, it + 1, change < jnp.asarray(convergence_threshold, dt)

    pi, iters, _ = jax.lax.while_loop(cond, body, (pi0, jnp.int32(0), jnp.bool_(False)))
    return pi, iters


@partial(
    jax.jit,
    static_argnames=(
        "num_transcripts",
        "max_iterations",
        "convergence_threshold",
        "pseudocount",
        "epsilon",
        "dtype",
        "axis_name",
    ),
)
def run_em_tables(
    tbl_tid: jnp.ndarray,  # [N, C] int32 candidate transcripts
    tbl_score: jnp.ndarray,  # [N, C] int32 scores (0 on padded lanes)
    num_reads: jnp.ndarray,  # [] int32 global R
    *,
    num_transcripts: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
    init_pi: Optional[jnp.ndarray] = None,
    start_iteration: int = 0,
    weight: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EM directly over [N, C] candidate tables (same math as run_em).

    weight (optional [N] int32): row multiplicities for equivalence-
    class EM (em/classes.py) — each row's posterior contributes
    weight[n] times, exactly equal to iterating the duplicated reads.

    The candidate-table layout makes the per-read denominator a row sum
    (pure elementwise reduce) so each iteration needs only ONE scatter-add (the
    posterior sum into [T]) instead of two segment-sums.

    init_pi/start_iteration resume from an EM checkpoint
    (em/checkpoint.py): the loop continues from the saved pi with the
    remaining iteration budget.

    Thin wrapper over run_em_partitioned with a single table — one
    implementation of the loop math to keep in sync.
    """
    pi, iters, _done = run_em_partitioned(
        ((tbl_tid, tbl_score, weight),),
        num_reads,
        num_transcripts=num_transcripts,
        max_iterations=max_iterations,
        convergence_threshold=convergence_threshold,
        pseudocount=pseudocount,
        epsilon=epsilon,
        dtype=dtype,
        axis_name=axis_name,
        init_pi=init_pi,
        start_iteration=start_iteration,
    )
    return pi, iters


@partial(
    jax.jit,
    static_argnames=(
        "num_transcripts",
        "max_iterations",
        "convergence_threshold",
        "pseudocount",
        "epsilon",
        "dtype",
        "axis_name",
        "use_segsum",
    ),
)
def run_em_partitioned(
    tables,  # tuple of (tbl_tid [Ni, Wi], tbl_score [Ni, Wi], weight [Ni] or None)
    num_reads: jnp.ndarray,
    *,
    num_transcripts: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
    init_pi: Optional[jnp.ndarray] = None,
    start_iteration: int = 0,
    use_segsum: bool = False,
    segsum_plan=None,
    static_base: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """EM over several width-partitioned class tables at once.

    Same math as run_em_tables: each table row is an independent read /
    equivalence class; posterior sums from all partitions add into one
    [T] vector per iteration.  Splitting classes into narrow and wide
    tables keeps the scatter lane count near the true pair count instead
    of num_rows x max_width.

    static_base (optional [T] int/float): iteration-invariant posterior
    contribution of folded single-candidate classes (their posterior is
    identically 1 — see em/classes.py build_class_tables).  It seeds
    each iteration's posterior sum, BEFORE the data-axis psum (the base
    is shard-local, so the psum totals it across shards exactly once).

    init_pi/start_iteration resume from an EM checkpoint; the returned
    (pi, iterations, converged) triple lets segmented runs (periodic
    checkpointing) continue EXACTLY where an uninterrupted loop would —
    `converged` distinguishes an early L1 stop from hitting the
    iteration bound, so a resumed segment never runs an extra step.
    """
    T = num_transcripts
    dt = jnp.dtype(dtype)
    base = None if static_base is None else static_base.astype(dt)
    plan = segsum_plan
    if use_segsum and plan is None:
        plan = plan_from_tables(tables, T)  # once; static across the loop
    prepped = []
    for tid, score, weight in tables:
        sc = score.astype(dt)
        wgt = None if weight is None else weight.astype(dt)[:, None]
        prepped.append((tid, sc, wgt))

    pi0 = (
        jnp.full(T, 1.0 / T, dtype=dt)
        if init_pi is None
        else jnp.asarray(init_pi, dtype=dt)
    )
    pcf = jnp.float32(pseudocount)
    # Reference addition order: (posterior_sum + pc/R) + pc, left-to-right.
    term_div = (pcf / num_reads.astype(jnp.float32)).astype(dt)
    term_pc = pcf.astype(dt)

    def e_step(pi):
        flats = [] if plan is not None else None
        ps = jnp.zeros(T, dt) if base is None else base
        for tid, sc, wgt in prepped:
            w = pi[tid] * sc
            denom = jnp.sum(w, axis=1, keepdims=True)
            inv = jnp.where(
                denom > jnp.asarray(epsilon, dt), 1.0 / denom, jnp.asarray(0, dt)
            )
            post = w * inv
            if wgt is not None:
                post = post * wgt
            if plan is not None:
                flats.append(post.reshape(-1))
            else:
                ps = ps.at[tid.reshape(-1)].add(post.reshape(-1))
        if plan is not None:
            ps = ps + segsum_apply(plan, jnp.concatenate(flats))
        return _psum_maybe(ps, axis_name)

    def cond(state):
        _, it, done = state
        return (it < max_iterations) & jnp.logical_not(done)

    def body(state):
        pi, it, _ = state
        new_pi = (e_step(pi) + term_div) + term_pc
        change = jnp.sum(jnp.abs(new_pi - pi))
        return new_pi, it + 1, change < jnp.asarray(convergence_threshold, dt)

    pi, iters, done = jax.lax.while_loop(
        cond, body, (pi0, jnp.int32(start_iteration), jnp.bool_(False))
    )
    return pi, iters, done


@partial(
    jax.jit,
    static_argnames=(
        "num_transcripts",
        "max_iterations",
        "convergence_threshold",
        "pseudocount",
        "epsilon",
        "dtype",
        "axis_name",
        "use_segsum",
    ),
)
def run_em_assign_partitioned(
    tables,
    num_reads: jnp.ndarray,
    *,
    num_transcripts: int,
    max_iterations: int = 20,
    convergence_threshold: float = 0.01,
    pseudocount: float = 0.01,
    epsilon: float = 1e-10,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
    use_segsum: bool = False,
    static_base: Optional[jnp.ndarray] = None,
    static_has: Optional[jnp.ndarray] = None,
):
    """EM + final soft assignment as ONE device program (one dispatch,
    zero host syncs between the loop and the assignment pass).

    static_base/static_has carry the folded single-candidate classes
    (see run_em_partitioned / em/classes.py build_class_tables); the
    base seeds both the per-iteration posterior sums and the final
    weighted counts (a singleton's assignment weight is also exactly 1).

    Returns (pi, iters, weighted, has_entry) — the complete quant tail.
    """
    plan = (
        plan_from_tables(tables, num_transcripts) if use_segsum else None
    )  # ONE sort shared by the EM loop and the assignment pass
    pi, iters, _done = run_em_partitioned(
        tables,
        num_reads,
        num_transcripts=num_transcripts,
        max_iterations=max_iterations,
        convergence_threshold=convergence_threshold,
        pseudocount=pseudocount,
        epsilon=epsilon,
        dtype=dtype,
        axis_name=axis_name,
        use_segsum=use_segsum,
        segsum_plan=plan,
        static_base=static_base,
    )
    weighted, has_entry = assign_reads_partitioned(
        tables,
        pi,
        num_transcripts=num_transcripts,
        dtype=dtype,
        axis_name=axis_name,
        use_segsum=use_segsum,
        segsum_plan=plan,
        static_base=static_base,
        static_has=static_has,
    )
    return pi, iters, weighted, has_entry


@partial(
    jax.jit,
    static_argnames=(
        "num_transcripts",
        "dtype",
        "axis_name",
        "use_segsum",
    ),
)
def assign_reads_partitioned(
    tables,
    pi: jnp.ndarray,
    *,
    num_transcripts: int,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
    use_segsum: bool = False,
    segsum_plan=None,
    static_base: Optional[jnp.ndarray] = None,
    static_has: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Partitioned-table soft assignment (see run_em_partitioned).

    static_base/static_has (optional [T]): folded single-candidate
    classes (em/classes.py).  Their assignment probability is exactly 1
    (w = pi*count equals its own denominator, and pi > 0 always), so the
    weighted counts gain the constant base and has_entry ORs their mask.
    Added shard-locally, BEFORE the data-axis psum.
    """
    T = num_transcripts
    dt = jnp.dtype(dtype)
    plan = segsum_plan
    if use_segsum and plan is None:
        plan = plan_from_tables(tables, T)
    prob_flats, contrib_flats = [], []
    weighted = jnp.zeros(T, dt)
    has_entry = jnp.zeros(T, jnp.int32)
    for tid, score, weight in tables:
        sc = score.astype(dt)
        w = pi[tid] * sc
        denom = jnp.sum(w, axis=1, keepdims=True)
        ok = denom > jnp.asarray(0, dt)
        inv = jnp.where(ok, 1.0 / jnp.where(ok, denom, 1.0), jnp.asarray(0, dt))
        prob = w * inv
        contributes = (sc > 0) & ok
        if weight is not None:
            prob = prob * weight.astype(dt)[:, None]
            contributes = contributes & (weight > 0)[:, None]
        if plan is not None:
            prob_flats.append(prob.reshape(-1))
            contrib_flats.append(contributes.reshape(-1).astype(jnp.int32))
        else:
            weighted = weighted.at[tid.reshape(-1)].add(prob.reshape(-1))
            has_entry = has_entry.at[tid.reshape(-1)].add(
                contributes.reshape(-1).astype(jnp.int32)
            )
    if plan is not None:
        weighted = weighted + segsum_apply(plan, jnp.concatenate(prob_flats))
        has_entry = has_entry + segsum_apply(plan, jnp.concatenate(contrib_flats))
    if static_base is not None:
        weighted = weighted + static_base.astype(dt)
    if static_has is not None:
        has_entry = has_entry + static_has.astype(jnp.int32)
    weighted = _psum_maybe(weighted, axis_name)
    has_entry = _psum_maybe(has_entry, axis_name)
    return weighted, has_entry > 0


@partial(jax.jit, static_argnames=("num_transcripts", "dtype", "axis_name"))
def assign_reads_tables(
    tbl_tid: jnp.ndarray,
    tbl_score: jnp.ndarray,
    pi: jnp.ndarray,
    *,
    num_transcripts: int,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
    weight: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Table-layout soft assignment (same math as assign_reads);
    weight as in run_em_tables.  Thin wrapper over the partitioned
    version with a single table."""
    return assign_reads_partitioned(
        ((tbl_tid, tbl_score, weight),),
        pi,
        num_transcripts=num_transcripts,
        dtype=dtype,
        axis_name=axis_name,
    )


@partial(
    jax.jit,
    static_argnames=("num_transcripts", "read_capacity", "dtype", "axis_name"),
)
def assign_reads(
    pair_read: jnp.ndarray,
    pair_tid: jnp.ndarray,
    pair_score: jnp.ndarray,
    pi: jnp.ndarray,
    *,
    num_transcripts: int,
    read_capacity: int,
    dtype: str = "float32",
    axis_name: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Soft assignment with the final pi (contract #6).

    Returns (weighted_counts [T], has_entry [T] bool) where has_entry
    marks transcripts that received a read_counts map entry in the
    reference (candidate of >= 1 read with total probability > 0) — the
    CSV row filter (src/data_io.cpp:143-147).
    """
    T = num_transcripts
    dt = jnp.dtype(dtype)
    score = pair_score.astype(dt)
    read_ids = pair_read.astype(jnp.int32)
    n_seg = read_capacity + 1

    w = pi[pair_tid] * score
    denom = jax.ops.segment_sum(w, read_ids, num_segments=n_seg)
    ok = denom > jnp.asarray(0, dt)
    inv = jnp.where(ok, 1.0 / jnp.where(ok, denom, 1.0), jnp.asarray(0, dt))
    prob = w * inv[read_ids]
    weighted = jax.ops.segment_sum(prob, pair_tid, num_segments=T)
    contributes = (score > 0) & ok[read_ids]
    has_entry = jax.ops.segment_sum(contributes.astype(jnp.int32), pair_tid, num_segments=T)
    weighted = _psum_maybe(weighted, axis_name)
    has_entry = _psum_maybe(has_entry, axis_name)
    return weighted, has_entry > 0
