"""8-device virtual-mesh dryrun at >=1M reads.

Runs the FULL sharded streaming engine (scan-chunked shard_map, bounded
per-device class buffers, psum'd EM/assignment) on an 8-device virtual
CPU mesh at 1M reads, proving the multi-chip program compiles and holds
O(buffer) memory at scale — the real-chip throughput numbers live in
scale_check.py / DESIGN.md.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python scripts/dryrun_scale.py [--reads 1000000] [--transcripts 10000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--transcripts", type=int, default=10_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--k", default="31")
    ap.add_argument("--index-hbm-budget", type=int, default=None,
                    help="per-device index HBM budget (bytes) fed to the "
                    "PRODUCTION mesh auto-widening (dist/mesh.mesh_factor "
                    "index_bytes path) — set below the index footprint to "
                    "force >=N index shards end-to-end")
    ap.add_argument("--verify-single", type=int, default=0,
                    help="ALSO run this many reads through the sharded AND "
                    "single-device paths and require bit-identical pi")
    ap.add_argument("--artifact", default=None,
                    help="write a JSON artifact with the chosen mesh + result")
    args = ap.parse_args()

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from sketch_rna_tpu.config import QuantConfig
    from sketch_rna_tpu.dist.mesh import index_device_bytes, make_mesh, mesh_factor
    from sketch_rna_tpu.index.artifact import load_index, save_index
    from sketch_rna_tpu.index.build import build_index
    from sketch_rna_tpu.io.fasta import FastaRecords
    from sketch_rna_tpu.io.packing import PackedReads
    from sketch_rna_tpu.pipeline import quantify_sharded
    from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome

    nd = len(jax.devices())
    print(f"devices={nd} backend={jax.default_backend()}", flush=True)

    rng = np.random.default_rng(2026)
    seqs = synth_transcriptome(rng, args.transcripts)
    ks = tuple(int(x) for x in args.k.split(","))
    cfg = QuantConfig(
        kmer_lengths=ks,
        batch_size=args.batch_size,
        max_read_len=((args.read_len + 127) // 128) * 128,
        em_dtype="float32",
    )
    cache = (
        f"/tmp/sketch_scale_cache/T{args.transcripts}"
        f"_k{args.k.replace(',', '_')}.npz"
    )
    if os.path.exists(cache):
        idx = load_index(cache)
    else:
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        recs = FastaRecords(
            [f"T{i:06d}" for i in range(len(seqs))],
            [bases[s].tobytes().decode() for s in seqs],
            0,
        )
        idx = build_index(recs, cfg)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        save_index(cache, idx)
    print(f"index: T={idx.num_transcripts}", flush=True)

    # The PRODUCTION mesh selection (pipeline.quantify_sharded and
    # dist/multihost both route through mesh_factor with
    # index_device_bytes): with --index-hbm-budget below the footprint,
    # the index axis must widen until each shard's share fits.
    idx_bytes = index_device_bytes(idx)
    dp, ip = mesh_factor(
        nd, index_bytes=idx_bytes, hbm_budget_bytes=args.index_hbm_budget
    )
    mesh = make_mesh(dp, ip)
    print(
        f"mesh=({dp}x{ip}) index_device_bytes={idx_bytes} "
        f"budget={args.index_hbm_budget}",
        flush=True,
    )
    if args.index_hbm_budget is not None:
        need = -(-idx_bytes // args.index_hbm_budget)  # ceil
        assert ip >= min(need, nd), (
            f"production auto-widening chose ip={ip}, need >= {min(need, nd)}"
        )

    codes, lens = sample_reads_device(
        seqs, args.reads, args.read_len, cfg.max_read_len, 7
    )
    jax.block_until_ready((codes, lens))
    packed = PackedReads(np.asarray(codes), np.asarray(lens), [])
    print(f"reads: {args.reads}", flush=True)

    t0 = time.perf_counter()
    result = quantify_sharded(idx, packed, cfg, mesh=mesh)
    dt = time.perf_counter() - t0
    assert result.pi.shape == (idx.num_transcripts,)
    assert np.isfinite(result.pi).all()
    assert result.num_reads == args.reads
    print(
        f"dryrun_scale ok: {args.reads} reads on ({dp}x{ip}) mesh in {dt:.1f}s "
        f"({args.reads/dt/1e3:.1f}k reads/s aggregate), "
        f"em_iters={result.em_iterations}, rows={int(result.has_entry.sum())}, "
        f"overflows={ {k: v for k, v in result.stats.items() if v} }",
        flush=True,
    )

    identical = None
    if args.verify_single:
        import dataclasses

        from sketch_rna_tpu.pipeline import quantify

        # float64 EM for the comparison; the suite's sharded-equality
        # bar (tests/test_sharded.py) is 1e-12 RELATIVE — cross-device
        # psum reductions associate differently than the one-program
        # sums, so last-ulp equality is not expected even in float64.
        # Requires JAX_ENABLE_X64=1 in the environment.
        vcfg = dataclasses.replace(cfg, em_dtype="float64")
        nv = args.verify_single
        small = PackedReads(packed.codes[:nv], packed.lengths[:nv], [])
        rs = quantify_sharded(idx, small, vcfg, mesh=mesh)
        r1 = quantify(idx, small, vcfg)
        rel = np.abs(rs.pi - r1.pi) / np.maximum(np.abs(r1.pi), 1e-300)
        max_rel = float(rel.max())
        rows_eq = bool(np.array_equal(rs.has_entry, r1.has_entry))
        identical = max_rel < 1e-12 and rows_eq
        print(
            f"sharded vs single-device on {nv} reads: max_rel={max_rel:.3e} "
            f"rows_equal={rows_eq}",
            flush=True,
        )
        assert identical, (
            f"sharded path diverged from single-device (max_rel={max_rel:.3e},"
            f" rows_equal={rows_eq})"
        )

    if args.artifact:
        import json

        with open(args.artifact, "w") as fh:
            json.dump(
                {
                    "devices": nd,
                    "mesh": [dp, ip],
                    "transcripts": idx.num_transcripts,
                    "index_device_bytes": idx_bytes,
                    "index_hbm_budget": args.index_hbm_budget,
                    "reads": args.reads,
                    "elapsed_s": round(dt, 1),
                    "em_iterations": result.em_iterations,
                    "rows": int(result.has_entry.sum()),
                    "overflows": {k: v for k, v in result.stats.items() if v},
                    "matches_single_device_1e12_rel_f64": identical,
                    "verify_single_reads": args.verify_single or None,
                },
                fh,
                indent=1,
            )
        print(f"artifact written to {args.artifact}", flush=True)


if __name__ == "__main__":
    main()
