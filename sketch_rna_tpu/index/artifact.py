"""Array-native index artifact.

Replaces the reference's custom binary stream format (save_index /
load_index, src/data_io.cpp:165-304) with flat arrays that load straight
into device buffers (SURVEY.md §5 "Checkpoint / resume" equivalent):

  per k:  keys    [U]   uint32, sorted distinct sketch hashes
          row_ptr [U+1] int32,  CSR offsets into postings
          postings[P]   int32,  transcript indices, ascending within a row

  global: names, lengths (real lengths — the reference serializes length
          but it is always 0 due to quirk Q2), kmer_lengths, fraction.

Unlike the reference we do NOT serialize transcript sequences — quant
never reads them (SURVEY.md §2 C9: "wasted space ≈ the whole
transcriptome").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class KIndex:
    """Inverted index for one k-mer length (CSR over sorted hash keys)."""

    keys: np.ndarray  # [U] uint32 sorted
    row_ptr: np.ndarray  # [U+1] int32
    postings: np.ndarray  # [P] int32 transcript indices

    @property
    def num_keys(self) -> int:
        return int(self.keys.shape[0])

    @property
    def num_postings(self) -> int:
        return int(self.postings.shape[0])


@dataclasses.dataclass
class IndexArtifact:
    names: List[str]  # all transcripts kept by load_fasta, input order
    lengths: np.ndarray  # [T] int32 true sequence lengths
    kmer_lengths: Tuple[int, ...]
    sketch_fraction: float
    per_k: Dict[int, KIndex]

    @property
    def num_transcripts(self) -> int:
        return len(self.names)


def save_index(path: str, idx: IndexArtifact) -> None:
    arrays = {
        "format_version": np.int32(FORMAT_VERSION),
        "names": np.array(idx.names, dtype=np.str_),
        "lengths": idx.lengths.astype(np.int32),
        "kmer_lengths": np.array(idx.kmer_lengths, dtype=np.int32),
        "sketch_fraction": np.float64(idx.sketch_fraction),
    }
    for k, ki in idx.per_k.items():
        arrays[f"k{k}_keys"] = ki.keys.astype(np.uint32)
        arrays[f"k{k}_row_ptr"] = ki.row_ptr.astype(np.int32)
        arrays[f"k{k}_postings"] = ki.postings.astype(np.int32)
    # np.savez appends ".npz" when absent, which would save to a path the
    # caller never sees ("s.idx" -> "s.idx.npz" + FileNotFound on load);
    # write through a file object so the exact name is honored.
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load_index(path: str) -> IndexArtifact:
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported index format version {version}")
        kmer_lengths = tuple(int(k) for k in z["kmer_lengths"])
        per_k = {}
        for k in kmer_lengths:
            per_k[k] = KIndex(
                keys=z[f"k{k}_keys"],
                row_ptr=z[f"k{k}_row_ptr"],
                postings=z[f"k{k}_postings"],
            )
        return IndexArtifact(
            names=[str(n) for n in z["names"]],
            lengths=z["lengths"],
            kmer_lengths=kmer_lengths,
            sketch_fraction=float(z["sketch_fraction"]),
            per_k=per_k,
        )
