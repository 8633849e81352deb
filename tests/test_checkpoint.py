"""EM checkpoint/resume: a split run must reproduce the one-shot run
exactly (the EM state is exactly (pi, iteration))."""

import numpy as np
import jax.numpy as jnp
import pytest

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.em.checkpoint import (
    EMState,
    check_resumable,
    fingerprint_of,
    load_em_state,
    save_em_state,
)
from sketch_rna_tpu.em.em import run_em_tables


def make_tables(rng, N=200, C=8, T=40):
    tid = rng.integers(0, T, size=(N, C)).astype(np.int32)
    score = rng.integers(0, 5, size=(N, C)).astype(np.int32)
    return jnp.asarray(tid), jnp.asarray(score), T


def test_resume_reproduces_oneshot(rng):
    tid, score, T = make_tables(rng)
    R = jnp.asarray(180, jnp.int32)
    kw = dict(num_transcripts=T, convergence_threshold=1e-9, dtype="float64")

    pi_full, it_full = run_em_tables(tid, score, R, max_iterations=20, **kw)

    pi_half, it_half = run_em_tables(tid, score, R, max_iterations=10, **kw)
    assert int(it_half) == 10
    pi_resumed, it_resumed = run_em_tables(
        tid,
        score,
        R,
        max_iterations=20,
        init_pi=pi_half,
        start_iteration=int(it_half),
        **kw,
    )
    assert int(it_resumed) == int(it_full)
    np.testing.assert_array_equal(np.asarray(pi_resumed), np.asarray(pi_full))


def test_state_roundtrip(tmp_path, rng):
    pi = rng.random(64)
    cfg = QuantConfig()
    fp = fingerprint_of(64, 1000, cfg)
    state = EMState(pi=pi, iterations_done=7, num_reads=1000, fingerprint=fp)
    path = str(tmp_path / "em.ckpt.npz")
    save_em_state(path, state)
    loaded = load_em_state(path)
    np.testing.assert_array_equal(loaded.pi, pi)
    assert loaded.iterations_done == 7
    assert loaded.num_reads == 1000
    check_resumable(loaded, fp)
    with pytest.raises(ValueError):
        check_resumable(loaded, fingerprint_of(65, 1000, cfg))


def test_timing_utils():
    from sketch_rna_tpu.utils.timing import PhaseTimer

    t = PhaseTimer()
    with t.phase("a", items=100):
        pass
    with t.phase("a", items=100):
        pass
    rep = t.report()
    assert rep["a"] >= 0
    assert rep["a_per_s"] > 0
    assert t.items["a"] == 200


def test_quantify_kill_and_resume_e2e(tmp_path):
    """Interrupted quant (EM stopped mid-budget, checkpoint on disk) then
    a resumed full run == one uninterrupted run, through the public
    quantify() + config.em_checkpoint path."""
    import dataclasses

    import numpy as np

    from sketch_rna_tpu.config import QuantConfig
    from sketch_rna_tpu.index.build import build_index
    from sketch_rna_tpu.io.fasta import FastaRecords
    from sketch_rna_tpu.io.packing import PackedReads
    from sketch_rna_tpu.pipeline import quantify

    from util import decode, make_transcriptome, sample_reads

    rng = np.random.default_rng(31337)
    seqs = make_transcriptome(rng, n=12, len_range=(60, 400))
    recs = FastaRecords(
        [f"T{i}" for i in range(len(seqs))], [decode(s) for s in seqs], 0
    )
    cfg = QuantConfig(
        kmer_lengths=(31,), batch_size=64, max_read_len=128, em_dtype="float64"
    )
    idx = build_index(recs, cfg)
    reads = [r for r in sample_reads(rng, seqs, n_reads=200, read_len=90) if r.size >= 31]
    codes = np.zeros((len(reads), 128), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    packed = PackedReads(codes, lens, [str(i) for i in range(len(reads))])

    uninterrupted = quantify(idx, packed, cfg)
    assert uninterrupted.em_iterations > 7  # the kill point must be mid-run

    ckpt = str(tmp_path / "em.ckpt.npz")
    # "Kill" after 7 iterations: a run whose budget ends mid-EM, saving
    # its state every 3 iterations.
    killed_cfg = dataclasses.replace(
        cfg, em_max_iterations=7, em_checkpoint=ckpt, em_checkpoint_every=3
    )
    quantify(idx, packed, killed_cfg)
    import os

    assert os.path.exists(ckpt)

    # Resume with the full budget from the saved state.
    resumed_cfg = dataclasses.replace(cfg, em_checkpoint=ckpt, em_checkpoint_every=3)
    resumed = quantify(idx, packed, resumed_cfg)

    np.testing.assert_array_equal(uninterrupted.pi, resumed.pi)
    np.testing.assert_array_equal(
        uninterrupted.weighted_counts, resumed.weighted_counts
    )
    assert uninterrupted.em_iterations == resumed.em_iterations
