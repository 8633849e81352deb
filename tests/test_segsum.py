"""Scatter-free segmented-scan posterior accumulation (em/segsum.py).

The segsum path must agree with the scatter path wherever both run: the
raw reducer against numpy float64 np.add.at, and the full EM+assignment
program with use_segsum on vs off (tolerances as the MXU tests — the
only differences are float summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sketch_rna_tpu.em.em import run_em_assign_partitioned
from sketch_rna_tpu.em.segsum import BLOCK, build_segsum_plan, segsum_apply


@pytest.mark.slow  # ~30s/case on CPU (associative_scan compiles per shape);
# core-suite coverage stays via the pad-lanes, EM-vs-scatter and
# full-pipeline on/off tests below
@pytest.mark.parametrize(
    "n,T",
    [
        (7, 3),  # below one block
        (BLOCK, 5),  # exactly one block
        (BLOCK + 1, 5),  # one lane spills into block 2
        (40_000, 1),  # single segment spanning ~78 blocks
        (50_000, 20_000),  # mostly tiny segments + empties
    ],
)
def test_segsum_matches_numpy(rng, n, T):
    tid = rng.integers(0, T, n).astype(np.int32)
    tid[: n // 4] = 0  # transcript 0 spans many blocks
    vals = (rng.random(n) * rng.integers(1, 1000, n)).astype(np.float32)
    plan = build_segsum_plan(jnp.asarray(tid), T)
    got = np.asarray(segsum_apply(plan, jnp.asarray(vals)))
    want = np.zeros(T, np.float64)
    np.add.at(want, tid, vals.astype(np.float64))
    # Error must stay SEGMENT-relative even with huge-weight neighbors
    # in the same block (the global-cumsum failure mode).
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-4)

    got64 = np.asarray(segsum_apply(plan, jnp.asarray(vals, jnp.float64)))
    np.testing.assert_allclose(got64, want, rtol=1e-12)

    # int32 values (the has_entry counting path) are exact.
    iv = rng.integers(0, 3, n).astype(np.int32)
    wanti = np.zeros(T, np.int64)
    np.add.at(wanti, tid, iv)
    np.testing.assert_array_equal(
        np.asarray(segsum_apply(plan, jnp.asarray(iv))), wanti
    )


def test_segsum_pad_lanes_are_inert(rng):
    """Table pad lanes (tid 0, value 0) add exactly zero, like scatter."""
    T = 50
    tid = np.zeros(700, np.int32)
    tid[:100] = rng.integers(0, T, 100)
    vals = np.zeros(700, np.float32)
    vals[:100] = rng.random(100).astype(np.float32)
    plan = build_segsum_plan(jnp.asarray(tid), T)
    got = np.asarray(segsum_apply(plan, jnp.asarray(vals)))
    want = np.zeros(T, np.float64)
    np.add.at(want, tid[:100], vals[:100].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _tables(rng, n_rows, width, T, with_weight=True):
    tid = rng.integers(0, T, (n_rows, width)).astype(np.int32)
    score = rng.integers(0, 10, (n_rows, width)).astype(np.int32)
    tid[score == 0] = 0
    weight = rng.integers(0, 5, n_rows).astype(np.int32) if with_weight else None
    return (
        jnp.asarray(tid),
        jnp.asarray(score),
        None if weight is None else jnp.asarray(weight),
    )


def test_quantify_segsum_on_matches_off(rng):
    """Full pipeline with em_segsum forced on (auto never selects it) vs
    the scatter path: same rows, float32-order-only drift."""
    import dataclasses

    from sketch_rna_tpu.config import QuantConfig
    from sketch_rna_tpu.index.build import build_index
    from sketch_rna_tpu.io.fasta import FastaRecords
    from sketch_rna_tpu.io.packing import PackedReads
    from sketch_rna_tpu.pipeline import quantify
    from sketch_rna_tpu.utils.synth import sample_reads_device, synth_transcriptome

    seqs = synth_transcriptome(rng, 60, len_lo=200, len_hi=600)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = FastaRecords(
        [f"T{i}" for i in range(len(seqs))],
        [bases[s].tobytes().decode() for s in seqs],
        0,
    )
    cfg = QuantConfig(
        kmer_lengths=(31,),
        batch_size=512,
        max_read_len=128,
        em_dtype="float32",
        em_segsum="off",
    )
    idx = build_index(recs, cfg)
    codes, lens = sample_reads_device(seqs, 1500, 100, 128, 3)
    packed = PackedReads(np.asarray(codes), np.asarray(lens), [])
    r_off = quantify(idx, packed, cfg)
    r_on = quantify(idx, packed, dataclasses.replace(cfg, em_segsum="on"))
    np.testing.assert_array_equal(r_on.has_entry, r_off.has_entry)
    assert r_on.em_iterations == r_off.em_iterations
    np.testing.assert_allclose(r_on.pi, r_off.pi, rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(
        r_on.weighted_counts, r_off.weighted_counts, rtol=2e-5, atol=1e-6
    )


@pytest.mark.parametrize("fold", [False, True])
def test_em_assign_segsum_vs_scatter(rng, fold):
    T = 3000
    tables = (
        _tables(rng, 4096, 4, T),
        _tables(rng, 512, 8, T),
        _tables(rng, 128, 16, T, with_weight=False),
    )
    static_base = (
        jnp.asarray(rng.integers(0, 50, T).astype(np.int32)) if fold else None
    )
    static_has = (
        jnp.asarray(rng.integers(0, 2, T).astype(np.int32) > 0) if fold else None
    )
    kw = dict(
        num_transcripts=T,
        max_iterations=20,
        dtype="float32",
        static_base=static_base,
        static_has=static_has,
    )
    R = jnp.asarray(9000, jnp.int32)
    pi_a, it_a, w_a, h_a = run_em_assign_partitioned(
        tables, R, use_segsum=False, **kw
    )
    pi_b, it_b, w_b, h_b = run_em_assign_partitioned(
        tables, R, use_segsum=True, **kw
    )
    assert int(it_a) == int(it_b)
    np.testing.assert_allclose(np.asarray(pi_a), np.asarray(pi_b), rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(w_a), np.asarray(w_b), rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(h_a), np.asarray(h_b))
