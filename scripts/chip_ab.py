"""On-card A/B timing behind the index-backend default, plus a trace.

  index   the CLI index build of the 250k-isoform transcriptome (seed
          2026) with SKETCH_TPU_INDEX_BACKEND=cpu and =accelerator, in
          turns after a cold accelerator build
  trace   a jax.profiler trace of one standard quant (bench.py's
          transcriptome, 131,072 reads of 150 bp, k=31), reduced to
          device busy time per XLA module and the idle share inside each

Times are host wall-clock around calls that return host arrays.
Prints one JSON line per measurement; run on the card with
`python scripts/chip_ab.py [--trace-dir DIR] [--skip-index]`, or reduce a
saved trace with `python scripts/chip_ab.py --reduce DIR`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

READS = 131072
READ_LEN = 150
INDEX_TRANSCRIPTS = 250_000
DEVICE_PLANE = "/device:GPU"


def emit(**kw):
    print(json.dumps(kw), flush=True)


def standard_problem(n_transcripts: int):
    from sketch_rna_tpu.config import QuantConfig
    from sketch_rna_tpu.index.build import build_index
    from sketch_rna_tpu.io.fasta import FastaRecords
    from sketch_rna_tpu.io.packing import PackedReads
    from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome

    rng = np.random.default_rng(1234)
    seqs = synth_transcriptome(rng, n_transcripts, 600, 2500)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = FastaRecords(
        [f"T{i:05d}" for i in range(len(seqs))],
        [bases[s].tobytes().decode() for s in seqs],
        0,
    )
    cfg = QuantConfig(kmer_lengths=(31,), max_read_len=256, em_dtype="float32")
    idx = build_index(recs, cfg)
    codes, lengths = sample_reads_device(seqs, READS, READ_LEN, 256, 1234)
    return cfg, idx, PackedReads(codes, lengths, [])


def timed_quant(idx, packed, cfg):
    from sketch_rna_tpu.pipeline import quantify

    t0 = time.perf_counter()
    res = quantify(idx, packed, cfg)
    return time.perf_counter() - t0, res


def index_ab(workdir: str) -> None:
    from sketch_rna_tpu import cli
    from sketch_rna_tpu.utils.synth import synth_transcriptome, write_fasta

    seqs = synth_transcriptome(np.random.default_rng(2026), INDEX_TRANSCRIPTS)
    fa = os.path.join(workdir, "tx250k.fa")
    write_fasta(fa, seqs)
    del seqs
    runs = {"cpu": [], "accelerator": []}
    built = {}
    for i, backend in enumerate(("accelerator", "cpu", "accelerator", "accelerator", "cpu")):
        os.environ["SKETCH_TPU_INDEX_BACKEND"] = backend
        out = os.path.join(workdir, f"idx_{backend}.npz")
        t0 = time.perf_counter()
        code, idx = cli.run(["-o", "index", "-k", "31", fa, out])
        dt = time.perf_counter() - t0
        assert code == 0
        if i == 0:
            emit(measure="index_backend_cold", backend=backend, seconds=dt)
        else:
            runs[backend].append(dt)
        built[backend] = idx
    del os.environ["SKETCH_TPU_INDEX_BACKEND"]
    a, b = built["cpu"].per_k[31], built["accelerator"].per_k[31]
    same = all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("keys", "row_ptr", "postings")
    )
    emit(
        measure="index_backend_ab",
        transcripts=INDEX_TRANSCRIPTS,
        seconds=runs,
        median_s={m: statistics.median(v) for m, v in runs.items()},
        identical_indexes=same,
    )


def reduce_trace(trace_dir: str) -> None:
    """Device busy time per XLA module (the kernels' hlo_module stat),
    the idle share inside each module's span, and the longest kernels.
    Gaps inside a module's span are device time spent waiting on the
    host, e.g. the per-iteration predicate copy of a lax.while_loop."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    for plane in pd.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        evs = sorted(
            (e.start_ns, e.start_ns + e.duration_ns, e.name,
             dict(e.stats).get("hlo_module", "?"))
            for line in plane.lines
            for e in line.events
        )
        if not evs:
            continue

        def busy(spans):
            total, cur_s, cur_e = 0, None, None
            for s, e in spans:
                if cur_e is None or s > cur_e:
                    if cur_e is not None:
                        total += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            return total + (cur_e - cur_s if cur_e is not None else 0)

        modules, kernels = {}, {}
        for s, e, name, mod in evs:
            modules.setdefault(mod, []).append((s, e))
            kernels[name] = kernels.get(name, 0) + (e - s)
        window = evs[-1][1] - evs[0][0]
        per_module = {}
        for mod, spans in modules.items():
            span = max(e for _, e in spans) - spans[0][0]
            b = busy(spans)
            per_module[mod] = {
                "kernels": len(spans),
                "span_ms": span / 1e6,
                "busy_ms": b / 1e6,
                "idle_share": 1 - b / span if span else 0.0,
                "gaps_over_5us": sum(
                    1 for (_, e0), (s1, _) in zip(spans, spans[1:]) if s1 - e0 > 5000
                ),
            }
        emit(
            measure="trace",
            plane=plane.name,
            window_ms=window / 1e6,
            busy_share=busy([(s, e) for s, e, _, _ in evs]) / window,
            modules=dict(sorted(per_module.items(), key=lambda kv: -kv[1]["busy_ms"])[:10]),
            top_kernels_ms={
                n: t / 1e6 for n, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
            },
        )


def trace_standard(trace_dir: str) -> None:
    import jax

    cfg, idx, packed = standard_problem(2000)
    timed_quant(idx, packed, cfg)  # compile outside the trace
    jax.profiler.start_trace(trace_dir)
    try:
        dt, _ = timed_quant(idx, packed, cfg)
    finally:
        jax.profiler.stop_trace()
    emit(measure="traced_quant", seconds=dt)
    reduce_trace(trace_dir)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--skip-index", action="store_true")
    ap.add_argument("--reduce", metavar="DIR", help="only reduce a saved trace")
    args = ap.parse_args()
    if args.reduce:
        reduce_trace(args.reduce)
        return

    from sketch_rna_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    d = jax.devices()[0]
    emit(measure="device", platform=d.platform, kind=d.device_kind, count=len(jax.devices()))
    if d.platform != "gpu":
        sys.exit("chip_ab: no GPU")
    if not args.skip_index:
        with tempfile.TemporaryDirectory(prefix="chip_ab_") as workdir:
            index_ab(workdir)
    if args.trace_dir:
        trace_standard(args.trace_dir)


if __name__ == "__main__":
    main()
