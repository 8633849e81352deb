"""Produce the GENCODE-scale parity artifacts against the reference tool.

Regenerates, deterministically:

  /tmp/gencode.fa              250k-isoform transcriptome (seed 2026 —
                               the SAME sequences scale_check.py and the
                               /tmp/sketch_scale_cache indexes use)
  /tmp/reads1m.fq              1M x 150 bp reads sampled from it
  /tmp/refbuild/reftool        the reference C++ pipeline compiled from
                               /root/reference/src against the nthash
                               shim (tests/test_reference_binary.py's
                               exact recipe)
  /tmp/refbuild/gencode.idx    the reference's OWN index of gencode.fa
  /tmp/refbuild/gencode_out.csv  the reference's quantification — the
                               ground truth this framework compares against
  /tmp/ours250k.npz            this framework's index artifact (copied
                               from the scale cache when present, else
                               built)

Run on the host (the reference part is single-threaded CPU); the read
sampling uses whatever JAX backend is available.

Usage: python scripts/gencode_parity.py [--transcripts 250000]
       [--reads 1000000] [--skip-ref]  (idempotent; skips existing files)
"""

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF = "/root/reference"


def build_reftool(out_dir: str) -> str:
    exe = os.path.join(out_dir, "reftool")
    if os.path.exists(exe):
        return exe
    os.makedirs(out_dir, exist_ok=True)
    cmd = [
        "g++", "-std=c++17", "-O2",
        "-include", "chrono", "-include", "algorithm",
        "-I", os.path.join(_REF, "include"),
        "-I", os.path.join(_REPO, "native", "nthash_shim"),
        *sorted(glob.glob(os.path.join(_REF, "src", "*.cpp"))),
        "-o", exe,
    ]
    print("building reference tool:", " ".join(cmd), flush=True)
    out = subprocess.run(cmd, capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr.decode()
    return exe


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=250000)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--skip-ref", action="store_true",
                    help="only generate fa/fq/our-index (no C++ runs)")
    args = ap.parse_args()

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    from sketch_rna_tpu.utils.synth import synth_transcriptome, write_fasta, write_fastq

    rng = np.random.default_rng(2026)  # scale_check.py's seed
    t0 = time.perf_counter()
    seqs = synth_transcriptome(rng, args.transcripts)
    print(f"transcriptome: {len(seqs)} seqs "
          f"({sum(s.size for s in seqs)/1e6:.0f} Mb, "
          f"{time.perf_counter()-t0:.1f}s)", flush=True)

    fa = "/tmp/gencode.fa"
    if not os.path.exists(fa):
        t0 = time.perf_counter()
        write_fasta(fa, seqs)
        print(f"wrote {fa} ({time.perf_counter()-t0:.1f}s)", flush=True)

    fq = "/tmp/reads1m.fq"
    if not os.path.exists(fq):
        t0 = time.perf_counter()
        write_fastq(fq, seqs, args.reads, args.read_len, chunk=1 << 20)
        print(f"wrote {fq} ({time.perf_counter()-t0:.1f}s)", flush=True)

    ours = "/tmp/ours250k.npz"
    if not os.path.exists(ours):
        cache = f"/tmp/sketch_scale_cache/T{args.transcripts}_k31.npz"
        if os.path.exists(cache):
            shutil.copyfile(cache, ours)
            print(f"copied {cache} -> {ours}", flush=True)
        else:
            from sketch_rna_tpu.config import QuantConfig
            from sketch_rna_tpu.index.artifact import save_index
            from sketch_rna_tpu.index.build import build_index
            from sketch_rna_tpu.io.fasta import load_fasta

            recs = load_fasta(fa)
            idx = build_index(recs, QuantConfig(kmer_lengths=(31,)))
            save_index(ours, idx)
            print(f"built {ours}", flush=True)

    if args.skip_ref:
        return
    exe = build_reftool("/tmp/refbuild")
    # Single-k AND multi-k ground truths (the reference accepts
    # -k 21,31) — the multi-k CSV backs BENCH_MATRIX's
    # c4_gencode_250k_1m_multik parity block.
    for ktag, kflag in (("", "31"), ("_k21_31", "21,31")):
        ridx = f"/tmp/refbuild/gencode{ktag}.idx"
        rcsv = f"/tmp/refbuild/gencode_out{ktag}.csv"
        if not os.path.exists(ridx):
            t0 = time.perf_counter()
            subprocess.run([exe, "-k", kflag, "-o", "index", fa, ridx],
                           check=True, timeout=3600)
            print(f"reference index -k {kflag}: "
                  f"{time.perf_counter()-t0:.1f}s", flush=True)
        if not os.path.exists(rcsv):
            t0 = time.perf_counter()
            subprocess.run([exe, "-o", "quant", ridx, fq, rcsv],
                           check=True, timeout=7200)
            print(f"reference quant -k {kflag}: "
                  f"{time.perf_counter()-t0:.1f}s", flush=True)
    print("parity artifacts ready", flush=True)


if __name__ == "__main__":
    main()
