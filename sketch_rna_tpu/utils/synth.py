"""Seeded synthetic transcriptomes and reads, and their FASTA/FASTQ files.

Read sampling runs as jitted device code (transcript picks, offsets and
the base gather), so millions of reads are drawn in one program and
either stay on the device for the quant path or are framed into FASTQ
on the host with vectorised numpy.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def synth_transcriptome(
    rng: np.random.Generator,
    n: int,
    len_lo: int = 600,
    len_hi: int = 2500,
    iso_frac: float = 0.6,
) -> List[np.ndarray]:
    """Isoform families sharing long exact stretches (host-side; sizes
    are small enough that per-family numpy is fine)."""
    seqs: List[np.ndarray] = []
    while len(seqs) < n:
        ln = int(rng.integers(len_lo, len_hi))
        base = rng.integers(0, 4, size=ln).astype(np.uint8)
        seqs.append(base)
        while len(seqs) < n and rng.random() < iso_frac:
            a = int(rng.integers(0, ln // 3))
            b = int(rng.integers(a, ln))
            iso = np.concatenate(
                [base[:a], base[b:], rng.integers(0, 4, size=50).astype(np.uint8)]
            )
            if iso.size >= 100:
                seqs.append(iso.astype(np.uint8))
    return seqs[:n]


@partial(jax.jit, static_argnames=("n_reads", "read_len", "pad_len"))
def _sample_kernel(big, offs, lens, seed, *, n_reads, read_len, pad_len):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    T = lens.shape[0]
    tid = jax.random.randint(k1, (n_reads,), 0, T, dtype=jnp.int32)
    tlen = lens[tid]
    span = jnp.maximum(tlen - read_len, 0)
    u = jax.random.uniform(k2, (n_reads,))
    start = (u * (span + 1).astype(jnp.float32)).astype(jnp.int32)
    eff = jnp.minimum(tlen, read_len).astype(jnp.int32)
    gstart = offs[tid] + start
    pos = jnp.arange(read_len, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(gstart[:, None] + pos, offs[tid][:, None] + tlen[:, None] - 1)
    codes = big[idx]
    mask = pos < eff[:, None]
    codes = jnp.where(mask, codes, 0).astype(jnp.uint8)
    if pad_len > read_len:
        codes = jnp.pad(codes, ((0, 0), (0, pad_len - read_len)))
    return codes, eff


def sample_reads_device(
    seqs: List[np.ndarray],
    n_reads: int,
    read_len: int,
    pad_len: int,
    seed: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device arrays (codes [n, pad_len] uint8, lengths [n] int32)."""
    big = jnp.asarray(np.concatenate(seqs))
    lens_np = np.array([s.size for s in seqs], dtype=np.int32)
    offs_np = np.zeros(lens_np.size, dtype=np.int32)
    np.cumsum(lens_np[:-1], out=offs_np[1:])
    return _sample_kernel(
        big,
        jnp.asarray(offs_np),
        jnp.asarray(lens_np),
        seed,
        n_reads=n_reads,
        read_len=read_len,
        pad_len=pad_len,
    )


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path: str, seqs: List[np.ndarray], name_fmt: str = "T{:06d}") -> List[str]:
    """One-line-per-sequence FASTA of base-code arrays; returns the names."""
    names = [name_fmt.format(i) for i in range(len(seqs))]
    with open(path, "wb", buffering=1 << 24) as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n" + _BASES[s].tobytes() + b"\n")
    return names


def frame_fastq(codes: np.ndarray, start_id: int) -> bytes:
    """[n, L] uint8 base codes -> FASTQ bytes with fixed-width ids
    ('@r' + 10 digits), all L bases written, quality 'I'."""
    n, L = codes.shape
    head = 13
    rec_len = head + L + 3 + L + 1
    rec = np.empty((n, rec_len), dtype=np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    ids = np.arange(start_id, start_id + n, dtype=np.int64)
    for d in range(10):
        rec[:, 2 + d] = (ids // 10 ** (9 - d)) % 10 + ord("0")
    rec[:, 12] = ord("\n")
    rec[:, head : head + L] = _BASES[codes]
    rec[:, head + L] = ord("\n")
    rec[:, head + L + 1] = ord("+")
    rec[:, head + L + 2] = ord("\n")
    rec[:, head + L + 3 : head + L + 3 + L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_fastq(
    path: str,
    seqs: List[np.ndarray],
    n_reads: int,
    read_len: int,
    chunk: int = 2_000_000,
) -> None:
    """Sample n_reads reads of read_len bases from seqs on the device, in
    chunks with per-chunk seeds, and frame them into a FASTQ file."""
    written = 0
    with open(path, "wb", buffering=1 << 24) as fh:
        while written < n_reads:
            n = min(chunk, n_reads - written)
            codes, _ = sample_reads_device(
                seqs, n, read_len, read_len, 1000 + written % 997
            )
            fh.write(frame_fastq(np.asarray(codes), written))
            written += n
