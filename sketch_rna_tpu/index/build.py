"""Index construction: device-batched transcript hashing -> CSR postings.

Reference pipeline (build_and_save_index, src/main.cpp:56-92 and
build_kmer_to_transcript_map, src/sketch.cpp:51-74):
  - transcripts shorter than ANY configured k are excluded from sketching
    (src/main.cpp:66-75) but still serialized into the index,
  - per transcript per k: FracMinHash sketch (a set),
  - inverted map: hash -> list of transcript ids.

Accelerator shape (SURVEY.md §7.2 step 3): ALL heavy array work runs on
device —
  1. per length-bucketed batch: windowed ntHash + threshold mask, then a
     row sort that compacts each transcript's kept hashes to the front
     of its row (discarded lanes carry the 0xFFFFFFFF sentinel),
  2. one global device sort of the concatenated (hash, tid) pairs,
  3. the host does only linear boundary scans to dedup pairs (set
     semantics) and emit the CSR arrays.
The host never runs per-transcript set operations (a Python np.unique
loop is minutes-to-hours at GENCODE scale on weak-CPU hosts).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.hash.nthash import nthash_batch_u32
from sketch_rna_tpu.index.artifact import IndexArtifact, KIndex
from sketch_rna_tpu.io.fasta import FastaRecords
from sketch_rna_tpu.io.packing import encode_sequence
from sketch_rna_tpu.sketch.fracminhash import fracminhash_threshold

log = logging.getLogger(__name__)

# Cap on elements per device hashing batch (B * L).
_BATCH_ELEMENT_BUDGET = 1 << 24
_SENTINEL = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnums=())
def _global_pair_sort(hashes, tids):
    """Lexicographic device sort of (hash, tid) pairs."""
    return jax.lax.sort((hashes, tids), num_keys=2)


@functools.lru_cache(maxsize=1)
def _cpu_device():
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


# Fixed hashing tile + flat-with-gaps layout.  All sketchable transcripts
# concatenate into ONE flat code array separated by (max_k - 1) zero
# "gap" bases; the flat array is then viewed as fixed [TILE_BATCH,
# TILE_LEN] tiles with a (max_k - 1) halo overlap (zero-copy strided
# view).  Consequences:
#   - every hashing launch has the SAME shape: exactly one compile per
#     k for any transcriptome (an earlier bucketed scheme compiled one
#     program per (length-bucket, chunk-height, k) and the first tiled
#     scheme wasted 6.7x lanes padding each transcript to its own tile),
#   - the kernel needs no per-row transcript ids and no length masks —
#     it emits (hash, flat position) pairs, and the host resolves
#     transcript id + window validity for ONLY the ~5% kept lanes with
#     one searchsorted over the transcript offsets.
# Tiling the windowed hash is exact: a window's hash depends only on its
# k bases; windows crossing a gap / transcript boundary are filtered by
# the host validity check (pos + k <= transcript end), and halo
# duplicates collapse in the set-semantics pair dedup (SURVEY.md §5).
_TILE_LEN = 8192
_TILE_BATCH = _BATCH_ELEMENT_BUDGET // _TILE_LEN  # 2048


def _flat_with_gaps(seq_codes: List[np.ndarray], sketchable, gap: int):
    """Concatenate sketchable transcripts with `gap` zero bases between
    them.  Returns (flat uint8 [total], starts int64 [n_sk] — flat
    offset of each sketchable transcript)."""
    n_sk = len(sketchable)
    sk_lens = np.array([seq_codes[i].size for i in sketchable], dtype=np.int64)
    starts = np.zeros(n_sk, dtype=np.int64)
    if n_sk > 1:
        np.cumsum(sk_lens[:-1] + gap, out=starts[1:])
    total = int(starts[-1] + sk_lens[-1]) if n_sk else 0
    flat = np.zeros(total, dtype=np.uint8)
    for o, i in zip(starts, sketchable):
        c = seq_codes[i]
        flat[o : o + c.size] = c
    return flat, starts, sk_lens


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _hash_pos_batch(codes, row0, k, thr, cap, stride):
    """[B, TL] tile codes -> compacted kept (hash, flat position) pairs.

    The batch's kept k-mers compact on device: one flat pair sort pushes
    kept hashes (all <= thr < sentinel) to the front, and only the first
    `cap` lanes transfer to the host.  row0 is the batch's first global
    tile index (traced — no recompile per batch).  Returns
    (pair_hash [cap] u32, pair_pos [cap] i32, n_kept [] i32)."""
    h = nthash_batch_u32(codes, k)
    B, nk = h.shape
    keep = h <= jnp.uint32(thr)
    flat_h = jnp.where(keep, h, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    row = jax.lax.broadcasted_iota(jnp.int32, (B, nk), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (B, nk), 1)
    pos = ((row0.astype(jnp.int32) + row) * jnp.int32(stride) + col).reshape(-1)
    sh, sp = jax.lax.sort((flat_h, pos), num_keys=2)
    n_kept = jnp.sum(keep.astype(jnp.int32))
    return sh[:cap], sp[:cap], n_kept


@functools.partial(jax.jit, static_argnums=(1, 2))
def _hash_keep_batch(codes, k, thr):
    """CPU-backend variant: hash + threshold only ([B, nk] masked plane);
    the host compacts with flatnonzero — no O(n log n) sort on the weak
    host, and no transfer to pay for."""
    h = nthash_batch_u32(codes, k)
    keep = h <= jnp.uint32(thr)
    return jnp.where(keep, h, jnp.uint32(0xFFFFFFFF))


def _resolve_pairs(ph, pos, starts, sk_lens, sketch_ids, k):
    """Host: (hash, flat position) -> (hash, transcript id), dropping
    windows that cross a gap / transcript end / the tail padding.
    Exact: a window is the reference's iff it lies entirely within one
    transcript (src/sketch.cpp:31-37 rolls within a single sequence)."""
    i = np.searchsorted(starts, pos, side="right") - 1
    i = np.maximum(i, 0)
    valid = (pos >= starts[i]) & (pos + k <= starts[i] + sk_lens[i])
    return ph[valid], sketch_ids[i[valid]]


def _index_backend() -> str:
    """Which backend hashes the index build: "accelerator" (the default
    device: hash + compaction sort + pair sort there) or "cpu" (XLA-CPU
    hashing, host compaction and lexsort).

    Default: the accelerator whenever the default backend is one.  On an
    H100 (80GB HBM3, 400 W limit) host the whole 250k-isoform CLI build
    took a median 21.4 s on the accelerator vs 23.3 s on the CPU backend,
    in turns with a warm compile cache; the first build on a machine
    also compiles the hashing programs (31.8 s), which the persistent
    cache then keeps.
    Without an accelerator the CPU path is the one written for the host.
    SKETCH_TPU_INDEX_BACKEND=cpu|accelerator overrides."""
    import os

    env = os.environ.get("SKETCH_TPU_INDEX_BACKEND")
    if env:
        return env
    return "cpu" if jax.default_backend() == "cpu" else "accelerator"


def build_index(records: FastaRecords, config: QuantConfig) -> IndexArtifact:
    ks = tuple(sorted(config.kmer_lengths))
    max_k = max(ks)
    names = records.names
    seq_codes: List[np.ndarray] = []
    lengths = np.zeros(len(names), dtype=np.int32)
    for i, seq in enumerate(records.seqs):
        codes = encode_sequence(seq)
        assert codes is not None, "load_fasta already validated sequences"
        seq_codes.append(codes)
        lengths[i] = codes.size

    # Sketchable set: length >= every configured k (src/main.cpp:66-75).
    sketchable = [i for i in range(len(names)) if lengths[i] >= max_k]
    thr = fracminhash_threshold(config.sketch_fraction)

    gap = max_k - 1
    stride = _TILE_LEN - gap
    flat, starts, sk_lens = _flat_with_gaps(seq_codes, sketchable, gap)
    sketch_ids = np.asarray(sketchable, dtype=np.int32)
    total = flat.size
    if total + _TILE_LEN >= (1 << 31):
        raise ValueError(
            f"transcriptome too large for int32 flat positions "
            f"({total} bases with gaps); shard the FASTA and merge indexes"
        )
    n_tiles = max(-(-(max(total - _TILE_LEN, 0)) // stride) + 1, 1) if total else 0
    pad_len = (n_tiles - 1) * stride + _TILE_LEN if n_tiles else 0
    if pad_len > total:
        flat = np.concatenate([flat, np.zeros(pad_len - total, np.uint8)])
    tiles_view = np.lib.stride_tricks.as_strided(
        flat, shape=(n_tiles, _TILE_LEN), strides=(stride, 1)
    ) if n_tiles else np.zeros((0, _TILE_LEN), np.uint8)

    use_cpu = _index_backend() != "accelerator"
    cpu = _cpu_device() if use_cpu else None
    use_cpu = cpu is not None
    frac_cap = min(1.0, config.sketch_fraction * 2.0 + 0.05)
    cap = max(int(_TILE_BATCH * _TILE_LEN * frac_cap), 1)

    # Each tile batch uploads/loads ONCE and hashes every k from it.
    hash_parts: Dict[int, List[np.ndarray]] = {k: [] for k in ks}
    tid_parts: Dict[int, List[np.ndarray]] = {k: [] for k in ks}
    for b0 in range(0, n_tiles, _TILE_BATCH):
        rows = min(_TILE_BATCH, n_tiles - b0)
        batch = np.zeros((_TILE_BATCH, _TILE_LEN), np.uint8)
        batch[:rows] = tiles_view[b0 : b0 + rows]
        cj = jax.device_put(batch, cpu) if use_cpu else jnp.asarray(batch)
        for k in ks:
            nk = _TILE_LEN - k + 1
            if use_cpu:
                plane = np.asarray(_hash_keep_batch(cj, k, thr))
                kept = np.flatnonzero(plane.reshape(-1) != _SENTINEL)
                ph = plane.reshape(-1)[kept]
                kept_row, kept_col = kept // nk, kept % nk
                pos = ((b0 + kept_row) * stride + kept_col).astype(np.int64)
            else:
                row0 = jax.device_put(np.int32(b0))
                phh, pp, n_kept = _hash_pos_batch(cj, row0, k, thr, cap, stride)
                n = int(n_kept)
                if n > cap:
                    phh, pp, n_kept = _hash_pos_batch(
                        cj, row0, k, thr, _TILE_BATCH * nk, stride
                    )
                ph = np.asarray(phh[:n])
                pos = np.asarray(pp[:n]).astype(np.int64)
            # Pad-row lanes land past the last transcript and fail the
            # validity check; gap/tail windows likewise.
            h_v, t_v = _resolve_pairs(ph, pos, starts, sk_lens, sketch_ids, k)
            if h_v.size:
                hash_parts[k].append(h_v)
                tid_parts[k].append(t_v)

    per_k: Dict[int, KIndex] = {}
    for k in ks:
        if hash_parts[k]:
            all_h = np.concatenate(hash_parts[k])
            all_t = np.concatenate(tid_parts[k])
            n_real = all_h.size
            if not use_cpu and n_real > 1 << 16:
                # Big pair sort on the accelerator; pad to a power of two
                # (sentinel pairs sort last) to bound compile variants.
                padded = 1 << (n_real - 1).bit_length()
                ph = np.full(padded, _SENTINEL, dtype=np.uint32)
                pt = np.zeros(padded, dtype=np.int32)
                ph[:n_real] = all_h
                pt[:n_real] = all_t
                sh, st = _global_pair_sort(jnp.asarray(ph), jnp.asarray(pt))
                all_h = np.asarray(sh)[:n_real]
                all_t = np.asarray(st)[:n_real]
            else:
                # CPU build path: host lexsort (~9 s at 15M pairs) beats
                # shipping the pairs to a remote accelerator and back.
                order = np.lexsort((all_t, all_h))
                all_h, all_t = all_h[order], all_t[order]
        else:
            all_h = np.zeros(0, dtype=np.uint32)
            all_t = np.zeros(0, dtype=np.int32)

        # Linear host scans: dedup (hash, tid) pairs (set semantics —
        # duplicates arise from repeated k-mers within one transcript)
        # and build the CSR arrays.
        if all_h.size:
            first = np.empty(all_h.size, dtype=bool)
            first[0] = True
            np.not_equal(all_h[1:], all_h[:-1], out=first[1:])
            tid_change = np.empty(all_h.size, dtype=bool)
            tid_change[0] = True
            np.not_equal(all_t[1:], all_t[:-1], out=tid_change[1:])
            keep_pair = first | tid_change
            all_h = all_h[keep_pair]
            all_t = all_t[keep_pair]

            new_key = np.empty(all_h.size, dtype=bool)
            new_key[0] = True
            np.not_equal(all_h[1:], all_h[:-1], out=new_key[1:])
            keys = all_h[new_key]
            starts = np.flatnonzero(new_key)
            row_ptr = np.zeros(keys.size + 1, dtype=np.int32)
            row_ptr[:-1] = starts
            row_ptr[-1] = all_h.size
        else:
            keys = np.zeros(0, dtype=np.uint32)
            row_ptr = np.zeros(1, dtype=np.int32)

        per_k[k] = KIndex(
            keys=keys.astype(np.uint32), row_ptr=row_ptr, postings=all_t.astype(np.int32)
        )
        log.info(
            "index k=%d: %d keys, %d postings over %d sketchable transcripts",
            k,
            keys.size,
            all_t.size,
            len(sketchable),
        )

    return IndexArtifact(
        names=list(names),
        lengths=lengths,
        kmer_lengths=ks,
        sketch_fraction=config.sketch_fraction,
        per_k=per_k,
    )
