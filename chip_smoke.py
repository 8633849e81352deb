"""End-to-end smoke test of index + quant on one NVIDIA GPU.

Drives the normal CLI (sketch_rna_tpu.cli) at the size of a human
transcriptome, from seeded synthetic data written into a temporary
directory, and checks what comes out against the float64 NumPy
reference oracle (oracle/reference_oracle.py).

  phase 0  environment: card name and power limit, JAX devices, the
           native parser built from the committed sources
  phase 1  index: 250,000 transcripts (~298 Mb), k=31
  phase 2  fused quant: 1,048,576 reads x 150 bp, FASTQ -> CSV
  phase 3  streamed quant: 4,194,304 reads x 150 bp (above the fused
           bound, so the CLI takes the native 2-bit streamed route)
  phase 4  correctness: CLI vs oracle at 2,000 transcripts x 8,192 reads
           (float64 and float32), float32 vs float64 at the phase-2
           size, and whether a repeated phase-2 run is byte-identical

The last line of standard output is one JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}},
printed only when every phase passed.  Without a GPU the script exits
nonzero before any phase runs.

Usage:
  python chip_smoke.py                one card, phases 0-4
  python chip_smoke.py --four-cards   the sharded quant over four cards
                                      against the single-card CSV
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

READ_LEN = 150
K = 31
# scripts/scale_check.py's 250k-isoform transcriptome.
INDEX_TRANSCRIPTS = 250_000
INDEX_SEED = 2026
FUSED_READS = 1 << 20
STREAMED_READS = 1 << 22
# bench.py's standard transcriptome, one default batch of reads.
ORACLE_TRANSCRIPTS = 2000
ORACLE_LEN_RANGE = (600, 2500)
ORACLE_SEED = 1234
ORACLE_READS = 8192
# float64: the repo's fuzz bar (summation order differs from the oracle's,
# and on the card scatter-add sums run in atomic order).  float32: the
# EM accumulates in float32, ~1e-6 relative, plus the %.6g print.
F64_RTOL = 5e-9
F32_RTOL = 1e-4


class SmokeFailure(Exception):
    """A phase produced a wrong or missing result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def device_summary():
    """(platform, device_kind, count) as JAX reports them; raises
    SmokeFailure unless the devices are GPUs."""
    import jax

    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    if platform != "gpu":
        raise SmokeFailure(f"JAX found no GPU (platform {platform!r})")
    return platform, kind, len(devs)


def ok_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def build_native() -> None:
    from sketch_rna_tpu.io import native

    with native.build_lock():
        subprocess.run(
            ["make", "-C", os.path.join(REPO, "native"), "clean", "all"],
            check=True,
            capture_output=True,
            timeout=600,
        )
    if not native.native_available():
        raise SmokeFailure("native fastio library did not build or load")


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def cli(argv):
    """One CLI invocation in this process; returns (seconds, result)."""
    from sketch_rna_tpu import cli as sk_cli

    t0 = time.perf_counter()
    code, result = sk_cli.run(argv)
    dt = time.perf_counter() - t0
    if code != 0:
        raise SmokeFailure(f"CLI {argv} exited {code}")
    return dt, result


def read_csv(path: str):
    """Name -> (NumReads, EM_Abundance) as printed."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return {r["Name"]: (r["NumReads"], r["EM_Abundance"]) for r in rows}


def _printable_range(v: float, rtol: float):
    """Floats of the 6-digit prints of values within rtol of v."""
    from sketch_rna_tpu.pipeline import format_cpp_double

    lo, hi = sorted((v * (1 - rtol), v * (1 + rtol)))
    return float(format_cpp_double(lo)), float(format_cpp_double(hi))


def compare_with_oracle(rows, expected, rtol: float) -> float:
    """Check CSV rows against exact values: the same row set, and every
    printed value the %.6g print of some value within rtol of the exact
    one.  Returns the largest relative difference of the printed values;
    raises SmokeFailure on a mismatch."""
    if set(rows) != set(expected):
        raise SmokeFailure(
            f"row sets differ: {len(set(rows) - set(expected))} extra, "
            f"{len(set(expected) - set(rows))} missing"
        )
    worst = 0.0
    for name, exact in expected.items():
        for col, (printed, v) in enumerate(zip(rows[name], exact)):
            got = float(printed)
            lo, hi = _printable_range(v, rtol)
            if not lo <= got <= hi:
                raise SmokeFailure(
                    f"{name} column {col}: {printed} is not within {rtol} "
                    f"relative of {v!r}"
                )
            worst = max(worst, abs(got - v) / max(abs(v), 1e-300))
    return worst


def compare_csvs(a, b) -> float:
    """Same row set required; returns the max relative difference."""
    if set(a) != set(b):
        raise SmokeFailure(
            f"row sets differ: {len(set(a) - set(b))} only in the first, "
            f"{len(set(b) - set(a))} only in the second"
        )
    worst = 0.0
    for name, va in a.items():
        for x, y in zip(va, b[name]):
            x, y = float(x), float(y)
            worst = max(worst, abs(x - y) / max(abs(x), abs(y), 1e-300))
    return worst


def oracle_rows(seqs, read_codes, names):
    """Oracle CSV values (name -> (NumReads, EM_Abundance)), float64."""
    from sketch_rna_tpu.oracle.reference_oracle import oracle_quant

    _, pi, weighted, csv_tids = oracle_quant(seqs, read_codes, (K,))
    return {names[t]: (float(weighted[t]), float(pi[t])) for t in csv_tids}


def write_oracle_problem(workdir: str, n_transcripts: int, n_reads: int, seed: int):
    """bench.py's transcriptome and reads sampled from it; returns
    (fasta, fastq, oracle rows)."""
    from sketch_rna_tpu.utils.synth import (
        frame_fastq,
        sample_reads_device,
        synth_transcriptome,
        write_fasta,
    )

    seqs = synth_transcriptome(
        np.random.default_rng(seed), n_transcripts, *ORACLE_LEN_RANGE
    )
    fa = os.path.join(workdir, "oracle.fa")
    fq = os.path.join(workdir, "oracle.fq")
    names = write_fasta(fa, seqs, "T{:05d}")
    codes, _ = sample_reads_device(seqs, n_reads, READ_LEN, READ_LEN, seed)
    codes = np.asarray(codes)
    with open(fq, "wb") as fh:
        fh.write(frame_fastq(codes, 0))
    read_codes = {f"r{i:010d}": codes[i] for i in range(n_reads)}
    return fa, fq, oracle_rows(seqs, read_codes, names)


def quant_report(tag: str, seconds: float, result, csv_path: str) -> None:
    log(
        f"[{tag}] {seconds:.3f} s wall, {result.num_reads} reads "
        f"({result.num_reads / seconds:,.0f} reads/s incl. parse and compile), "
        f"em_iterations={result.em_iterations}, "
        f"rows={int(np.sum(result.has_entry))}, stats={result.stats}, "
        f"peak_bytes_in_use={peak_bytes()}"
    )
    if not os.path.getsize(csv_path):
        raise SmokeFailure(f"{tag}: empty CSV")
    if not (np.isfinite(result.pi).all() and np.isfinite(result.weighted_counts).all()):
        raise SmokeFailure(f"{tag}: non-finite abundances")


def write_index_inputs(workdir: str):
    """Phase 1-2 inputs: the 250k transcriptome FASTA and the 1M-read FASTQ."""
    from sketch_rna_tpu.utils.synth import synth_transcriptome, write_fasta, write_fastq

    t0 = time.perf_counter()
    seqs = synth_transcriptome(np.random.default_rng(INDEX_SEED), INDEX_TRANSCRIPTS)
    fa = os.path.join(workdir, "tx250k.fa")
    write_fasta(fa, seqs)
    fq = os.path.join(workdir, "reads1m.fq")
    write_fastq(fq, seqs, FUSED_READS, READ_LEN)
    log(
        f"[inputs] {len(seqs)} transcripts, {sum(s.size for s in seqs)} bases, "
        f"{FUSED_READS} reads written in {time.perf_counter() - t0:.1f} s"
    )
    return seqs, fa, fq


def build_index_phase(workdir: str, fa: str):
    """CLI index of the phase-1 FASTA; returns (path, IndexArtifact)."""
    from sketch_rna_tpu.dist.mesh import index_device_bytes

    idx_path = os.path.join(workdir, "tx250k.skidx.npz")
    dt, idx = cli(["-o", "index", "-k", str(K), fa, idx_path])
    log(
        f"[phase 1] index of {idx.num_transcripts} transcripts: {dt:.3f} s wall, "
        f"keys={idx.per_k[K].num_keys}, postings={idx.per_k[K].num_postings}, "
        f"index_device_bytes={index_device_bytes(idx)}"
    )
    return idx_path, idx


def single_card(workdir: str) -> None:
    from sketch_rna_tpu.utils.synth import write_fastq

    seqs, fa, fq1m = write_index_inputs(workdir)
    idx_path, _ = build_index_phase(workdir, fa)

    csv1m = os.path.join(workdir, "reads1m.csv")
    dt, res = cli(["-o", "quant", idx_path, fq1m, csv1m])
    quant_report("phase 2 fused", dt, res, csv1m)

    fq4m = os.path.join(workdir, "reads4m.fq")
    t0 = time.perf_counter()
    write_fastq(fq4m, seqs, STREAMED_READS, READ_LEN)
    log(f"[phase 3] {STREAMED_READS} reads written in {time.perf_counter() - t0:.1f} s")
    del seqs
    csv4m = os.path.join(workdir, "reads4m.csv")
    dt, res = cli(["-o", "quant", idx_path, fq4m, csv4m])
    quant_report("phase 3 streamed", dt, res, csv4m)
    os.remove(fq4m)

    # Phase 4.  float32 runs first: the float64 flag turns on x64 for
    # the rest of the process.
    again = os.path.join(workdir, "reads1m_again.csv")
    cli(["-o", "quant", idx_path, fq1m, again])
    with open(csv1m, "rb") as fa_, open(again, "rb") as fb_:
        identical = fa_.read() == fb_.read()
    log(
        f"[phase 4] phase-2 float32 CSV rerun byte-identical: {identical}; "
        f"max rel diff {compare_csvs(read_csv(csv1m), read_csv(again)):.3e}"
    )
    oracle_checks(workdir, ORACLE_TRANSCRIPTS, ORACLE_READS)
    csv1m64 = os.path.join(workdir, "reads1m_f64.csv")
    dt, res = cli(["-o", "quant", "--em-dtype", "float64", idx_path, fq1m, csv1m64])
    worst = compare_csvs(read_csv(csv1m), read_csv(csv1m64))
    log(
        f"[phase 4] phase-2 size float32 vs float64 ({dt:.3f} s): "
        f"{int(np.sum(res.has_entry))} rows identical, max rel diff {worst:.3e}"
    )


def oracle_checks(workdir: str, n_transcripts: int, n_reads: int) -> None:
    """CLI index + quant of bench.py's transcriptome against the oracle:
    default float32 within F32_RTOL, then float64 within F64_RTOL."""
    fa_o, fq_o, expected = write_oracle_problem(
        workdir, n_transcripts, n_reads, ORACLE_SEED
    )
    idx_o = os.path.join(workdir, "oracle.skidx.npz")
    cli(["-o", "index", "-k", str(K), fa_o, idx_o])
    for dtype, rtol in (("float32", F32_RTOL), ("float64", F64_RTOL)):
        out = os.path.join(workdir, f"oracle_{dtype}.csv")
        cli(["-o", "quant", "--em-dtype", dtype, idx_o, fq_o, out])
        worst = compare_with_oracle(read_csv(out), expected, rtol)
        log(
            f"[phase 4] {dtype} CLI vs oracle ({n_transcripts} transcripts, "
            f"{n_reads} reads): {len(expected)} rows identical, max rel diff "
            f"of printed values {worst:.3e} (bar {rtol} before the %.6g print)"
        )


def four_cards(workdir: str) -> None:
    import jax

    from sketch_rna_tpu.dist.mesh import index_device_bytes, mesh_factor

    _, fa, fq1m = write_index_inputs(workdir)
    idx_path, idx = build_index_phase(workdir, fa)
    n = len(jax.devices())
    dp, ip = mesh_factor(n, index_bytes=index_device_bytes(idx))
    log(f"[four-card] ('data', 'index') mesh over {n} devices: ({dp}, {ip})")
    sharded = os.path.join(workdir, "reads1m_sharded.csv")
    dt, res = cli(["-o", "quant", "--sharded", idx_path, fq1m, sharded])
    quant_report("four-card sharded", dt, res, sharded)
    single = os.path.join(workdir, "reads1m_single.csv")
    dt, res = cli(["-o", "quant", idx_path, fq1m, single])
    quant_report("device 0 single-card", dt, res, single)
    worst = compare_csvs(read_csv(single), read_csv(sharded))
    if worst > F32_RTOL:
        raise SmokeFailure(f"sharded vs single-card max rel diff {worst:.3e}")
    log(
        f"[four-card] sharded vs single-card: {len(read_csv(single))} rows "
        f"identical, max rel diff {worst:.3e} (bar {F32_RTOL})"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded quant and its comparison")
    args = ap.parse_args(argv)

    log(f"[phase 0] {card_name_and_power()}")
    import jax

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    log(f"[phase 0] compilation cache: {enable_compilation_cache()}")
    platform, kind, count = device_summary()
    log(f"[phase 0] jax {jax.__version__}: {jax.devices()}")
    log(f"[phase 0] platform={platform} device_kind={kind} count={count}")
    if args.four_cards and count != 4:
        raise SmokeFailure(f"--four-cards needs 4 devices, found {count}")
    build_native()
    log("[phase 0] native fastio built from native/fastio.cpp and loaded")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four_cards:
            four_cards(workdir)
        else:
            single_card(workdir)
    log(card_name_and_power())
    print(ok_line(platform, kind, count), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
