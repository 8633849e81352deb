"""Device-mesh helpers.

The framework's two parallel axes (SURVEY.md §2 parallelism inventory):
  "data"  — reads are embarrassingly parallel (every reference per-read
            loop: sparse_chain body, E-step body, assignment body);
  "index" — the k-mer -> postings index is hash-range sharded for large
            transcriptomes (BASELINE config 4); match events are gathered
            across this axis before grouping.

The reference has neither (single thread); these are new structure.
Collectives run over the devices' interconnect (NVLink between the
cards of one host); with jax.distributed.initialize() the same code
spans hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

# Per-device memory the replicated index may occupy before the mesh
# chooser widens the index axis: a quarter of what the device lets the
# process allocate; the rest stays free for read chunks, event windows
# and EM tables.  The CPU backend reports no limit, so it gets a fixed
# budget.  Override via SKETCH_TPU_INDEX_HBM_BUDGET (bytes).
CPU_INDEX_BUDGET = 4 << 30


def index_budget_bytes(device=None) -> int:
    """Bytes one device may spend on an index replica (see above)."""
    device = device if device is not None else jax.local_devices()[0]
    if device.platform == "cpu":
        return CPU_INDEX_BUDGET
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no memory limit; set "
            "SKETCH_TPU_INDEX_HBM_BUDGET to the index budget in bytes"
        )
    return int(stats["bytes_limit"]) // 4


def index_device_bytes(index) -> int:
    """Estimated on-device footprint of one full index replica: the per-k
    bucket probe tables ([nb, 3*mb] int32, the dominant term at GENCODE
    scale) plus postings.  Shape-only — nothing is allocated.  Cached on
    the artifact (the key histogram costs ~a second at 8M keys on weak
    hosts and the answer never changes)."""
    cached = getattr(index, "_device_bytes_cache", None)
    if cached is not None:
        return cached
    from sketch_rna_tpu.match.bucket_lookup import bucket_table_shape

    total = 0
    for k in index.kmer_lengths:
        ki = index.per_k[k]
        nb, mb, _ = bucket_table_shape(ki.keys)
        total += nb * 3 * mb * 4 + ki.num_postings * 4
    object.__setattr__(index, "_device_bytes_cache", total)
    return total


def mesh_factor(
    n_devices: int,
    max_index_shards: int = 2,
    index_bytes: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
) -> Tuple[int, int]:
    """Split n devices into (data, index) axis sizes.

    Data parallelism dominates (reads are the big dimension); the index
    axis doubles only while it stays <= max_index_shards, divides the
    device count, and leaves the data axis at least as large — so e.g.
    16 devices with max_index_shards=4 give (4, 4), and small meshes
    stay data-only.  Pass an explicit mesh (make_mesh) for other
    splits; any (dp, ip) factorization works (tested through (2, 4)).

    index_bytes (see index_device_bytes) auto-widens the cap: when a
    full replica exceeds the per-device budget (index_budget_bytes), the
    index axis grows until each shard's share fits — a fit REQUIREMENT,
    so it overrides the keep-data-axis-large preference (a mesh that
    OOMs has no throughput to preserve)."""
    index = 1
    if index_bytes is not None and n_devices > 1:
        env = os.environ.get("SKETCH_TPU_INDEX_HBM_BUDGET")
        budget = hbm_budget_bytes or (int(env) if env else index_budget_bytes())
        # Fit first: the smallest divisor of n_devices whose per-shard
        # share fits the budget (n_devices itself if none does).
        for d in range(1, n_devices + 1):
            if n_devices % d == 0:
                index = d
                if index_bytes / d <= budget:
                    break
        max_index_shards = max(max_index_shards, index)
    # Then the balanced preference: double only while data stays >= 2x.
    while (
        index * 2 <= max_index_shards
        and n_devices % (index * 2) == 0
        and n_devices // (index * 2) >= index * 2
    ):
        index *= 2
    return n_devices // index, index


def make_mesh(
    n_data: int,
    n_index: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = n_data * n_index
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_data, n_index)
    return Mesh(arr, ("data", "index"))
