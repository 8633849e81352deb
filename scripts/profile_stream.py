"""Streaming-path profiler: file -> quantify_streamed with phase timing.

Drives the exact CLI streaming route (native scan -> chunks_from_scan ->
stream.quantify_streamed) but prints the phase breakdown, per-chunk
rates, and one JSON line — the measurement harness for the round-4
streaming-gap work.

Usage: python scripts/profile_stream.py INDEX.npz READS.fq [--csv OUT]
       [--chunk-reads N] [--class-capacity N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("index")
    ap.add_argument("fastq")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--chunk-reads", type=int, default=None)
    ap.add_argument("--class-capacity", type=int, default=None)
    args = ap.parse_args()

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()

    import logging

    logging.basicConfig(level=logging.INFO)

    from sketch_rna_tpu.config import QuantConfig
    from sketch_rna_tpu.index.artifact import load_index
    from sketch_rna_tpu.io import native
    from sketch_rna_tpu.stream import quantify_streamed
    t_all = time.perf_counter()
    idx = load_index(args.index)
    ks = tuple(idx.kmer_lengths)
    kw = {}
    if args.chunk_reads:
        kw["stream_chunk_reads"] = args.chunk_reads
    if args.class_capacity:
        kw["stream_class_capacity"] = args.class_capacity
    config = QuantConfig(kmer_lengths=ks, em_dtype="float32", **kw)
    t0 = time.perf_counter()
    scan = native.NativeFastqScan(args.fastq, max(ks))
    t_scan = time.perf_counter() - t0
    n = scan.num_reads
    pad_len = ((max(scan.max_len, max(ks), 1) + 7) // 8) * 8
    print(f"scan: {n:,} reads in {t_scan:.2f}s", flush=True)

    t0 = time.perf_counter()
    stream = native.chunks_from_scan2(
        scan, config.stream_chunk_reads, pad_len,
        row_multiple=config.batch_size,
    )
    result = quantify_streamed(idx, stream, config, num_reads_hint=n)
    t_quant = time.perf_counter() - t0
    total = time.perf_counter() - t_all
    print(f"quant: {t_quant:.2f}s = {n/t_quant/1e3:.1f}k reads/s "
          f"(file->result {total:.2f}s = {n/total/1e3:.1f}k reads/s)",
          flush=True)
    print(f"timing: {result.timing}", flush=True)
    print(f"stats:  {result.stats} em_iters={result.em_iterations}", flush=True)
    if args.csv:
        from sketch_rna_tpu.pipeline import write_csv

        write_csv(args.csv, result)
        print(f"csv written to {args.csv}", flush=True)
    print(json.dumps({
        "metric": "stream_file_to_result",
        "reads": n,
        "seconds": round(total, 2),
        "reads_per_s": round(n / total, 1),
        "quant_s": round(t_quant, 2),
        "scan_s": round(t_scan, 2),
        "timing": {k: round(v, 3) for k, v in result.timing.items()},
        "stats": {k: int(v) for k, v in result.stats.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
