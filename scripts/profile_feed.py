"""Host-feed ceiling: scan + pack + H2D upload rates at production chunk sizes.

The aggregate north star (10M reads/s on 16 chips) needs each 4-chip host
to feed ~2.5M reads/s of parse+pack+upload.  This measures the three feed
stages on THIS host, separately and as the overlapped pipeline the CLI
actually runs (io/native.chunks_from_scan: a background thread packs
chunk c+1 while chunk c uploads/matches), and prints a feed-rate table
for docs/DESIGN.md plus one JSON line for machine consumption.

Replaces the reference's single-pass parse loop
(/root/reference/src/main.cpp:107-151) at measured-budget granularity.

Usage: python scripts/profile_feed.py /tmp/big8m.fq [--chunk 1048576]
       [--skip-upload]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fastq")
    ap.add_argument("--chunk", type=int, default=1 << 20)
    ap.add_argument("--min-len", type=int, default=31)
    ap.add_argument("--skip-upload", action="store_true",
                    help="host-only stages (no device contention)")
    args = ap.parse_args()

    from sketch_rna_tpu.io import native

    assert native.native_available(), "native fastio unavailable"

    # 1. Scan: mmap + parallel byte-range parse + validation + dedup.
    t0 = time.perf_counter()
    scan = native.NativeFastqScan(args.fastq, args.min_len)
    t_scan = time.perf_counter() - t0
    n = scan.num_reads
    pad_len = max(scan.max_len, args.min_len, 1)
    print(f"scan: {n:,} reads in {t_scan:.2f}s = {n/t_scan/1e6:.2f} M reads/s "
          f"(max_len={scan.max_len})", flush=True)

    # 2. Pack: range packing at chunk granularity, sequential.
    t0 = time.perf_counter()
    n_packed = 0
    for s in range(0, n, args.chunk):
        c = min(args.chunk, n - s)
        scan.pack_range(s, c, pad_len)
        n_packed += c
    t_pack = time.perf_counter() - t0
    print(f"pack: {n_packed:,} reads in {t_pack:.2f}s = "
          f"{n_packed/t_pack/1e6:.2f} M reads/s", flush=True)

    t_upload = None
    t_pipe = None
    if not args.skip_upload:
        import jax
        import jax.numpy as jnp

        dev = jax.devices()[0]
        # 3. Upload: H2D of packed chunks (codes + lengths).
        first = scan.pack_range(0, min(args.chunk, n), pad_len)
        x = jax.device_put((first.codes, first.lengths), dev)
        jax.block_until_ready(x)  # warm the transfer path
        t0 = time.perf_counter()
        n_up = 0
        bytes_up = 0
        for s in range(0, n, args.chunk):
            c = min(args.chunk, n - s)
            p = scan.pack_range(s, c, pad_len)  # repack: mirrors production
            t1 = time.perf_counter()
            x = jax.device_put((p.codes, p.lengths), dev)
            jax.block_until_ready(x)
            t_upload = (t_upload or 0.0) + time.perf_counter() - t1
            n_up += c
            bytes_up += p.codes.nbytes + p.lengths.nbytes
        print(f"upload: {n_up:,} reads in {t_upload:.2f}s = "
              f"{n_up/t_upload/1e6:.2f} M reads/s "
              f"({bytes_up/t_upload/1e9:.2f} GB/s H2D)", flush=True)

        # 4. Pipelined feed: the production chunks_from_scan overlap
        #    (background pack thread) + upload on the consumer side.
        scan2 = native.NativeFastqScan(args.fastq, args.min_len)
        t0 = time.perf_counter()
        n_pipe = 0
        for p in native.chunks_from_scan(scan2, args.chunk, pad_len):
            x = jax.device_put((p.codes, p.lengths), dev)
            jax.block_until_ready(x)
            n_pipe += p.num_reads
        t_pipe = time.perf_counter() - t0
        print(f"pipeline (pack||upload): {n_pipe:,} reads in {t_pipe:.2f}s = "
              f"{n_pipe/t_pipe/1e6:.2f} M reads/s", flush=True)

    scan.close()
    seq_total = t_scan + t_pack + (t_upload or 0.0)
    out = {
        "metric": "host_feed",
        "reads": n,
        "chunk": args.chunk,
        "scan_s": round(t_scan, 3),
        "scan_mreads_s": round(n / t_scan / 1e6, 3),
        "pack_s": round(t_pack, 3),
        "pack_mreads_s": round(n / t_pack / 1e6, 3),
        "upload_s": round(t_upload, 3) if t_upload else None,
        "upload_mreads_s": round(n / t_upload / 1e6, 3) if t_upload else None,
        "pipeline_s": round(t_pipe, 3) if t_pipe else None,
        "pipeline_mreads_s": round(n / t_pipe / 1e6, 3) if t_pipe else None,
        "feed_total_seq_s": round(seq_total, 3),
        "feed_mreads_s_seq": round(n / seq_total / 1e6, 3),
        "cores": os.cpu_count(),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
