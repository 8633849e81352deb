"""Command-line interface mirroring the reference binary (src/main.cpp:212-276).

Modes and flags preserved:
  -o/--mode {index,quant}   default quant  (src/main.cpp:214, :243-245)
  -k/--kmer-length LIST     comma-separated, default 31 (src/main.cpp:215)
  index mode:  <reference.fasta> <index_output>
  quant mode:  <index_file> <reads.fastq> <output.csv>

Reference quirk Q1 preserved: in quant mode the k-mer lengths stored in
the index always win over -k (src/main.cpp:174 net behavior).

Every hard-coded reference constant is additionally exposed as a flag
with its reference default (SURVEY.md §5 "Config / flag system").
Phase progress lines mirror src/main.cpp:176-196.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import List, Optional

from sketch_rna_tpu.config import QuantConfig

log = logging.getLogger(__name__)


def _parse_kmer_list(s: str) -> tuple:
    out = []
    for tok in s.split(","):
        tok = tok.strip()
        if tok:
            out.append(int(tok))
    if not out:
        raise argparse.ArgumentTypeError("empty k-mer list")
    return tuple(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sketch-rna-tpu",
        description="Accelerator-native alignment-free RNA-seq isoform "
        "quantification (index/quant modes mirror the reference tool).",
        epilog="Examples:\n"
        "  sketch-rna-tpu -o index -k 31 ref.fasta ref.skidx.npz\n"
        "  sketch-rna-tpu -o quant ref.skidx.npz reads.fastq out.csv\n"
        "  sketch-rna-tpu -o quant idx s1.fq.gz,s2.fq.gz out.csv   (multi-sample)\n"
        "  sketch-rna-tpu -o quant --sharded --tpm idx reads.fq out.csv",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    from sketch_rna_tpu import __version__

    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("-o", "--mode", choices=["index", "quant"], default="quant")
    p.add_argument("-k", "--kmer-length", type=_parse_kmer_list, default=(31,), metavar="K[,K...]")
    p.add_argument("positional", nargs="*", help="index: <ref.fasta> <index_out> | quant: <index> <reads.fastq> <out.csv>")
    # Reference constants promoted to flags (reference defaults).
    p.add_argument("--sketch-fraction", type=float, default=0.05)
    p.add_argument("--chain-fraction", type=float, default=0.9)
    p.add_argument("--em-max-iterations", type=int, default=20)
    p.add_argument("--em-convergence", type=float, default=0.01)
    p.add_argument("--pseudocount", type=float, default=0.01)
    # Device capacity knobs.
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--max-read-len", type=int, default=256)
    p.add_argument("--candidate-capacity", type=int, default=64)
    p.add_argument("--expand-per-read", type=int, default=256)
    p.add_argument("--em-dtype", choices=["float32", "float64"], default=None,
                   help="default: float64 on the CPU backend with x64 "
                   "enabled, float32 otherwise")
    p.add_argument("--no-native", action="store_true",
                   help="disable the native (C++) FASTQ parser")
    p.add_argument("--sharded", action="store_true",
                   help="run quant over all visible devices via the shard_map "
                   "pipeline (data-parallel reads x hash-range-sharded index)")
    p.add_argument("--tpm", action="store_true",
                   help="append a true-TPM column (length-normalized; the "
                   "reference promises TPM but never computes it)")
    p.add_argument("--index-format", choices=["npz", "refbin"], default="npz",
                   help="index mode output format: npz artifact (default) or "
                   "the reference binary layout (interoperable with the C++ tool)")
    # Multi-host execution (jax.distributed). Each process parses only its
    # byte-range slice of the FASTQ; implies --sharded.
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (multi-host)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--em-checkpoint", default=None, metavar="PATH",
                   help="periodically checkpoint EM state to PATH and resume "
                   "from it if present (single-device quant)")
    p.add_argument("--em-segsum", choices=["auto", "on", "off"], default="auto",
                   help="scatter-free segmented-scan EM posterior accumulation "
                   "(auto: the plain scatter-add)")
    p.add_argument("--stream-chunk-reads", type=int, default=None,
                   help="reads per chunk for the big-dataset streaming path "
                   "(default 1M); chunks are parsed/packed on the host while "
                   "the device matches the previous chunk")
    p.add_argument("--stream-class-capacity", type=int, default=None,
                   help="streaming class-buffer rows (default %d; bounds "
                   "DISTINCT candidate profiles held on device — overflow "
                   "drops classes and is counted, never silent)"
                   % QuantConfig.stream_class_capacity)
    p.add_argument("--merged-k-grouping", action="store_true",
                   help="multi-k: use the merged K-wide event grouping "
                   "instead of per-k table intersection (the engines "
                   "fall back to this automatically on a candidate "
                   "spill; forcing it trades ~2x multi-k match time for "
                   "truncating only the final candidate set)")
    p.add_argument("--no-stream-drain", action="store_true",
                   help="disable the class-buffer exactness recovery (host "
                   "drain + re-merge when streaming; one bigger-buffer rerun "
                   "when sharded): overflow then drops classes, counted in "
                   "stats, never silent")
    return p


def _config_from_args(args, kmer_lengths) -> QuantConfig:
    em_dtype = args.em_dtype
    import jax

    if em_dtype == "float64" and not jax.config.jax_enable_x64:
        # Without x64, jnp silently downcasts float64 -> float32 and the
        # flag would be a no-op.
        jax.config.update("jax_enable_x64", True)
    if em_dtype is None:
        em_dtype = (
            "float64"
            if jax.default_backend() == "cpu" and jax.config.jax_enable_x64
            else "float32"
        )
    return QuantConfig(
        kmer_lengths=tuple(kmer_lengths),
        sketch_fraction=args.sketch_fraction,
        chain_fraction=args.chain_fraction,
        em_max_iterations=args.em_max_iterations,
        em_convergence=args.em_convergence,
        pseudocount=args.pseudocount,
        batch_size=args.batch_size,
        max_read_len=args.max_read_len,
        candidate_capacity=args.candidate_capacity,
        expand_per_read=args.expand_per_read,
        em_dtype=em_dtype,
        em_segsum=args.em_segsum,
        em_checkpoint=args.em_checkpoint,
        **(
            {"stream_chunk_reads": args.stream_chunk_reads}
            if args.stream_chunk_reads
            else {}
        ),
        **(
            {"stream_class_capacity": args.stream_class_capacity}
            if args.stream_class_capacity
            else {}
        ),
        **({"match_per_k_tables": False} if args.merged_k_grouping else {}),
        **({"stream_drain": False} if args.no_stream_drain else {}),
    )


def run_index(
    ref_fasta: str, index_out: str, config: QuantConfig, index_format: str = "npz"
):
    from sketch_rna_tpu.index.artifact import save_index
    from sketch_rna_tpu.index.build import build_index
    from sketch_rna_tpu.io.fasta import load_fasta

    t0 = time.perf_counter()
    records = load_fasta(ref_fasta)
    idx = build_index(records, config)
    elapsed = time.perf_counter() - t0
    # Mirrors "Index built in N seconds." (src/main.cpp:88).
    print(f"Index built in {elapsed} seconds.")
    if index_format == "refbin":
        from sketch_rna_tpu.index.refbin import write_refbin_index

        write_refbin_index(index_out, idx, records.seqs)
    else:
        save_index(index_out, idx)
    print(f"Index saved to {index_out}")
    return idx


def _load_reads(reads_path: str, idx, config: QuantConfig, use_native: bool):
    """Parse + validate + pack one FASTQ (native C++ parser when built).

    The reference processes reads of any length (src/main.cpp:107-151);
    the pad width grows to the longest kept read (rounded to a
    lane-friendly multiple of 128) so no valid read is dropped.
    """
    from sketch_rna_tpu.io.fastq import load_fastq_dict
    from sketch_rna_tpu.io.packing import pack_reads

    max_k = max(idx.kmer_lengths)
    if use_native:
        from sketch_rna_tpu.io import native

        # The native parser inflates gzip itself (zlib in fastio.cpp).
        packed, stats = native.pack_fastq_native(reads_path, min_len=max_k)
        longest = stats["max_len"]
        pad_len = max(config.max_read_len, ((longest + 127) // 128) * 128)
        if packed.padded_len < pad_len:
            import numpy as np

            grown = np.zeros((packed.num_reads, pad_len), np.uint8)
            grown[:, : packed.padded_len] = packed.codes
            packed.codes = grown
        return packed
    reads = load_fastq_dict(reads_path, min_len=max_k)
    longest = max((len(s) for s in reads.values()), default=0)
    pad_len = max(config.max_read_len, ((longest + 127) // 128) * 128)
    packed, n_invalid, n_too_long = pack_reads(
        list(reads.values()), list(reads.keys()), min_len=max_k, pad_len=pad_len
    )
    assert n_too_long == 0
    return packed


def _load_reads_slice(reads_path: str, idx, config: QuantConfig):
    """Parse + pack THIS process's byte-range slice of the FASTQ
    (multi-host data parallelism, SURVEY.md §7.2 step 6)."""
    import jax

    from sketch_rna_tpu.io.fastq import byte_range_for_process, load_fastq_dict_range
    from sketch_rna_tpu.io.packing import pack_reads

    max_k = max(idx.kmer_lengths)
    start, end = byte_range_for_process(
        reads_path, jax.process_index(), jax.process_count()
    )
    reads = load_fastq_dict_range(reads_path, start, end, min_len=max_k)
    longest = max((len(s) for s in reads.values()), default=0)
    pad_len = max(config.max_read_len, ((longest + 127) // 128) * 128)
    packed, _, n_too_long = pack_reads(
        list(reads.values()), list(reads.keys()), min_len=max_k, pad_len=pad_len
    )
    assert n_too_long == 0
    return packed


def run_quant(
    index_path: str,
    reads_path: str,
    output_path: str,
    config: QuantConfig,
    use_native: bool = True,
    with_tpm: bool = False,
    sharded: bool = False,
):
    from sketch_rna_tpu.index.refbin import load_any_index
    from sketch_rna_tpu.io.fastq import load_fastq_dict
    from sketch_rna_tpu.io.packing import pack_reads
    from sketch_rna_tpu.pipeline import quantify, write_csv

    import jax

    multiproc = jax.process_count() > 1
    primary = jax.process_index() == 0

    # Accepts both our .npz artifact and the reference's binary format.
    idx = load_any_index(index_path)
    if primary:
        print("Loading index completed")
    # Quirk Q1: the index's k-mer lengths win over CLI -k.
    config = dataclasses.replace(config, kmer_lengths=tuple(idx.kmer_lengths))

    if "," in reads_path:
        # Multi-sample batch quant: comma-separated FASTQs, one CSV per
        # sample, named <output_stem>.<sample_stem>.csv.
        import os

        from sketch_rna_tpu.pipeline import quantify_samples

        samples = {}
        for fq in reads_path.split(","):
            # Fail fast on missing inputs even though parsing is lazy.
            if not os.path.exists(fq):
                raise FileNotFoundError(f"Could not open FASTQ file: {fq}")
            # Lazy loader: each sample parses/packs only when quantified
            # (quantify_samples), so host RAM holds one pack at a time.
            # Under multi-process each host parses only its byte-range
            # slice; the sharded engine merges via collectives.
            samples[os.path.splitext(os.path.basename(fq))[0]] = (
                (lambda fq=fq: _load_reads_slice(fq, idx, config))
                if multiproc
                else (lambda fq=fq: _load_reads(fq, idx, config, use_native))
            )
        if primary:
            print("Loading read completed")
        results = quantify_samples(
            idx, samples, config, sharded=sharded or multiproc
        )
        stem, ext = os.path.splitext(output_path)
        ext = ext or ".csv"
        if primary:
            for name, result in results.items():
                out = f"{stem}.{name}{ext}"
                write_csv(out, result, with_tpm=with_tpm)
                print(f"Output written to {out}")
        return results

    packed = None
    stream = None
    stream_scan = None
    if multiproc:
        packed = _load_reads_slice(reads_path, idx, config)
    elif use_native and not sharded:
        # One native scan decides the route: datasets beyond the fused
        # bound stream through chunks_from_scan (the host packs
        # chunk c+1 while the device matches chunk c) instead of ever
        # materializing the whole [R, L] pack.
        from sketch_rna_tpu.io import native
        from sketch_rna_tpu.pipeline import FUSED_MAX_PADDED_READS

        import os as _os

        # Files comfortably beyond the fused bound (2 GB ≈ 6M+ reads at
        # short-read record sizes vs FUSED_MAX_PADDED_READS=2M) stream
        # without a blocking up-front scan: LazyScanFeed scans on a
        # background thread and quantify_streamed's device index upload
        # overlaps it.  Smaller files keep the exact num_reads route.
        # (env override: tests exercise the lazy route on small files.)
        stream_min = int(
            _os.environ.get("SKETCH_TPU_STREAM_MIN_BYTES", 2 << 30)
        )
        if _os.path.getsize(reads_path) >= stream_min:
            stream_scan = native.LazyScanFeed(
                reads_path,
                max(idx.kmer_lengths),
                config.stream_chunk_reads,
                row_multiple=config.batch_size,
            )
            stream = stream_scan
            pad_len = None  # resolved from the feed when needed (retry)
        else:
            scan = native.NativeFastqScan(reads_path, max(idx.kmer_lengths))
            pad_len = max(config.max_read_len, ((scan.max_len + 127) // 128) * 128)
            if scan.num_reads > FUSED_MAX_PADDED_READS:
                # Streamed chunks pad to the true max read length
                # (8-rounded, like the fused path's lane slicing) and
                # ship 2-bit packed (io/packing.Packed2Reads): 4 bases
                # per byte quarter the host-to-device bytes.
                pad_len = max(
                    ((scan.max_len + 7) // 8) * 8, max(idx.kmer_lengths)
                )
                stream_scan = scan
                stream = native.chunks_from_scan2(
                    scan, config.stream_chunk_reads, pad_len,
                    row_multiple=config.batch_size,
                )
            else:
                packed = scan.pack_range(0, scan.num_reads, pad_len)
                scan.close()
    if packed is None and stream is None:
        packed = _load_reads(reads_path, idx, config, use_native)
    if primary:
        print("Loading read completed")

    if stream is not None:
        from sketch_rna_tpu.stream import quantify_streamed

        # LazyScanFeed resolves its own num_reads lazily (after the
        # index upload); passing the hint here would join the scan early
        # and serialize it back in front of the upload.
        lazy = isinstance(stream, native.LazyScanFeed) if use_native else False
        try:
            result = quantify_streamed(
                idx,
                stream,
                config,
                num_reads_hint=None if lazy else stream_scan.num_reads,
            )
        finally:
            # The generator closes the scan once started; an error before
            # its first iteration would otherwise leak the mmap + record
            # table (close() is idempotent).
            stream_scan.close()
        # Iterator feeds can't replay inside quantify_streamed; rebuild
        # the native scan and rerun with the recovery config (flat
        # windows / doubled expansion / single-width buffer) until the
        # overflow stats clear — each recovery moves the config toward a
        # bound, so the loop terminates.
        from sketch_rna_tpu.stream import stream_retry_config

        while True:
            retry_cfg, reason = stream_retry_config(config, result.stats)
            if retry_cfg is None:
                break
            from sketch_rna_tpu.io import native

            log.warning("streaming %s; re-scanning and rerunning", reason)
            config = retry_cfg
            if pad_len is None:
                pad_len = stream_scan.pad_len  # lazy route: 8-rounded max
            scan2 = native.NativeFastqScan(reads_path, max(idx.kmer_lengths))
            stream2 = native.chunks_from_scan2(
                scan2, config.stream_chunk_reads, pad_len,
                row_multiple=config.batch_size,
            )
            try:
                result = quantify_streamed(
                    idx, stream2, config, num_reads_hint=scan2.num_reads
                )
            finally:
                scan2.close()
    elif sharded or multiproc:
        from sketch_rna_tpu.pipeline import quantify_sharded

        result = quantify_sharded(idx, packed, config)
    else:
        result = quantify(idx, packed, config)
    if primary:
        print("Sparse chaining completed")
        print("EM estimation completed")
        print("Read assignment completed")
        write_csv(output_path, result, with_tpm=with_tpm)
        print(f"Output written to {output_path}")
    return result


def run(argv: Optional[List[str]] = None):
    """Parse argv and run one mode, as main() does.

    Returns (exit_code, result): result is the built IndexArtifact in
    index mode, the QuantResult in quant mode (a dict of them, keyed by
    sample, for a multi-sample quant), and None on a usage error.
    """
    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if args.coordinator is not None:
        from sketch_rna_tpu.dist.init import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)
    if args.mode == "index":
        if len(args.positional) < 2:
            print("Usage: sketch-rna-tpu index <reference_genome.fasta> <index_output>", file=sys.stderr)
            return 1, None
        config = _config_from_args(args, args.kmer_length)
        return 0, run_index(
            args.positional[0], args.positional[1], config, args.index_format
        )
    elif args.mode == "quant":
        if len(args.positional) < 3:
            print("Usage: sketch-rna-tpu quant <index_file> <reads.fastq> <output>", file=sys.stderr)
            return 1, None
        config = _config_from_args(args, args.kmer_length)
        return 0, run_quant(
            args.positional[0],
            args.positional[1],
            args.positional[2],
            config,
            use_native=not args.no_native,
            with_tpm=args.tpm,
            sharded=args.sharded,
        )
    return 0, None


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
