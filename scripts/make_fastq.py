"""Generate a large on-disk FASTQ from the scale-check transcriptome.

Feeds the streaming path, which needs a real multi-gigabyte file rather
than device-resident synthetic reads.  Reads are sampled on the device
in chunks and framed into FASTQ records with vectorised numpy
(utils/synth.write_fastq).

Usage: python scripts/make_fastq.py out.fq [--transcripts 250000]
       [--reads 32000000] [--read-len 150] [--chunk 2000000]

The transcriptome uses the same generator and seed as scale_check.py.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--transcripts", type=int, default=250000)
    ap.add_argument("--reads", type=int, default=32_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--chunk", type=int, default=2_000_000)
    args = ap.parse_args()

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    from sketch_rna_tpu.utils.synth import synth_transcriptome, write_fastq

    rng = np.random.default_rng(2026)  # scale_check.py's transcriptome seed
    t0 = time.perf_counter()
    seqs = synth_transcriptome(rng, args.transcripts)
    print(
        f"transcriptome: {len(seqs)} seqs ({time.perf_counter()-t0:.1f}s)",
        flush=True,
    )
    t0 = time.perf_counter()
    write_fastq(args.out, seqs, args.reads, args.read_len, args.chunk)
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: {size/1e9:.2f} GB in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
