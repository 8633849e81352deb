"""The full multi-chip quant step: sketch -> match -> EM -> assignment
under one jitted shard_map over a ("data", "index") mesh.

Per-device flow (SURVEY.md §5 "Distributed communication backend"):
  1. sketch the local read shard (pure local compute),
  2. probe + expand match events against the LOCAL hash-range index
     shard — hashes owned by other shards simply don't match locally,
  3. all_gather the flat events across the "index" axis, so every
     device holds all events for its read shard; per-(read, transcript)
     counts then merge across index shards exactly (this realizes the
     cross-shard max/threshold requirement of SURVEY.md §7.4),
  4. group/threshold into per-read candidate tables (local compute),
  5. EM: per-transcript posterior sums psum over "data" each iteration —
     the all-reduce form of the reference's serial accumulation
     (src/isoform_assignment.cpp:48) — with pi replicated,
  6. soft assignment with the final pi, again psum over "data".

Outputs (pi, weighted counts, has_entry, iters) are fully replicated.

ROLE: cross-check formulation.  Production sharded quant (single-process
AND multi-host) runs the scan-chunked STREAMING engine
(dist/quant_stream.py via pipeline._sharded_stream_core), which bounds
HBM at any read count.  This whole-batch step stays as the simplest
complete statement of the collective semantics — tests/test_sharded.py
pins it bit-identical to the single-device path, guarding the streaming
engine's psum/all_gather structure against drift.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sketch_rna_tpu.em.em import assign_reads_tables, run_em_tables
from sketch_rna_tpu.match.rowmatch import row_events_to_candidates, row_expand_events
from sketch_rna_tpu.sketch.fracminhash import sketch_batch


def _body(
    codes,
    lengths,
    keys,
    row_ptr,
    postings,
    num_reads,
    *,
    kmer_lengths,
    sketch_fraction,
    sketch_caps,
    chain_fraction,
    expand_per_read,
    candidate_capacity,
    num_transcripts,
    em_max_iterations,
    em_convergence,
    pseudocount,
    em_epsilon,
    em_dtype,
):
    Bl = codes.shape[0]  # local read rows
    K = len(kmer_lengths)
    hashes, masks, sk_ovs = [], [], []
    for k, cap in zip(kmer_lengths, sketch_caps):
        h, m, ov = sketch_batch(codes, lengths, k, sketch_fraction, cap)
        hashes.append(h)
        masks.append(m)
        sk_ovs.append(ov)

    # Local index shard: strip the leading shard axis.
    lkeys = [a[0] for a in keys]
    lrp = [a[0] for a in row_ptr]
    lpost = [a[0] for a in postings]

    parts, drops = [], []
    for ki in range(K):
        key, d = row_expand_events(
            hashes[ki],
            masks[ki],
            lkeys[ki],
            lrp[ki],
            lpost[ki],
            events_per_read=expand_per_read,
            k_index=ki,
            num_k=K,
        )
        parts.append(key)
        drops.append(d)
    keym = jnp.concatenate(parts, axis=1)  # [Bl, K*Epr] local events
    # Merge partial events across index shards: gather along the LANE
    # axis (each shard contributes events for its hash range; the row
    # sort inside grouping interleaves them exactly).
    keym = jax.lax.all_gather(keym, "index", axis=1, tiled=True)

    n_parts = keym.shape[1] // parts[0].shape[1]
    result = row_events_to_candidates(
        jnp.split(keym, n_parts, axis=1) if n_parts > 1 else keym,
        num_k=K,
        chain_fraction=chain_fraction,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
    )

    tbl_tid = result.tid
    tbl_score = jnp.where(result.mask, result.score, 0)

    pi, iters = run_em_tables(
        tbl_tid,
        tbl_score,
        num_reads,
        num_transcripts=num_transcripts,
        max_iterations=em_max_iterations,
        convergence_threshold=em_convergence,
        pseudocount=pseudocount,
        epsilon=em_epsilon,
        dtype=em_dtype,
        axis_name="data",
    )
    weighted, has_entry = assign_reads_tables(
        tbl_tid,
        tbl_score,
        pi,
        num_transcripts=num_transcripts,
        dtype=em_dtype,
        axis_name="data",
    )
    stats = {
        "expand_dropped": jax.lax.psum(
            jax.lax.psum(jnp.stack(drops), "index"), "data"
        ),
        "candidate_spilled": jax.lax.psum(result.stats["candidate_spilled"], "data"),
        # Sketching is replicated across the index axis (every index
        # rank sketches the same read shard), so sum over "data" only.
        "sketch_overflow": jax.lax.psum(jnp.stack(sk_ovs), "data"),
    }
    return pi, weighted, has_entry, iters, stats


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "kmer_lengths",
        "sketch_fraction",
        "sketch_caps",
        "chain_fraction",
        "expand_per_read",
        "candidate_capacity",
        "num_transcripts",
        "em_max_iterations",
        "em_convergence",
        "pseudocount",
        "em_epsilon",
        "em_dtype",
    ),
)
def quant_step_sharded(
    codes: jnp.ndarray,  # [B, L] uint8, B divisible by mesh data size
    lengths: jnp.ndarray,  # [B] int32
    keys: Tuple[jnp.ndarray, ...],  # per-k [n_index, U_pad] uint32
    row_ptr: Tuple[jnp.ndarray, ...],  # per-k [n_index, U_pad+1] int32
    postings: Tuple[jnp.ndarray, ...],  # per-k [n_index, P_pad] int32
    num_reads: jnp.ndarray,  # [] int32 global R
    *,
    mesh: Mesh,
    kmer_lengths: Tuple[int, ...],
    sketch_fraction: float,
    sketch_caps: Tuple[int, ...],
    chain_fraction: float,
    expand_per_read: int,
    candidate_capacity: int,
    num_transcripts: int,
    em_max_iterations: int = 20,
    em_convergence: float = 0.01,
    pseudocount: float = 0.01,
    em_epsilon: float = 1e-10,
    em_dtype: str = "float32",
):
    body = partial(
        _body,
        kmer_lengths=kmer_lengths,
        sketch_fraction=sketch_fraction,
        sketch_caps=sketch_caps,
        chain_fraction=chain_fraction,
        expand_per_read=expand_per_read,
        candidate_capacity=candidate_capacity,
        num_transcripts=num_transcripts,
        em_max_iterations=em_max_iterations,
        em_convergence=em_convergence,
        pseudocount=pseudocount,
        em_epsilon=em_epsilon,
        em_dtype=em_dtype,
    )
    K = len(kmer_lengths)
    in_specs = (
        P("data", None),  # codes
        P("data"),  # lengths
        tuple(P("index", None) for _ in range(K)),  # keys
        tuple(P("index", None) for _ in range(K)),  # row_ptr
        tuple(P("index", None) for _ in range(K)),  # postings
        P(),  # num_reads
    )
    out_specs = (
        P(),
        P(),
        P(),
        P(),
        {"expand_dropped": P(), "candidate_spilled": P(), "sketch_overflow": P()},
    )
    return jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )(codes, lengths, keys, row_ptr, postings, num_reads)
