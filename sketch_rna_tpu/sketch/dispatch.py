"""Sketch-stage dispatch: one helper every pipeline call site uses.

The production path is the jnp windowed-XOR hash (fused by XLA into one
elementwise pass) + two dedup row sorts.  A hand-written fused sketch
kernel lost its A/B against this on the accelerator the design was
first built for and was removed (docs/DESIGN.md).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

# Module-scope imports ONLY: this function runs inside jitted bodies, and
# a lazy import during tracing initializes the target module's jnp-level
# constants mid-trace, corrupting jit dispatch (see pipeline.py's import
# invariant note).
from sketch_rna_tpu.sketch.fracminhash import sketch_batch


def sketch_all_k(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    kmer_lengths: Sequence[int],
    fraction: float,
    caps: Sequence[int],
) -> Tuple:
    """[(hashes, mask, n_overflow)] per k."""
    return tuple(
        sketch_batch(codes, lengths, k, fraction, cap)
        for k, cap in zip(kmer_lengths, caps)
    )
