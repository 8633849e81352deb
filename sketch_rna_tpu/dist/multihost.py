"""Multi-process (multi-host) sharded quantification.

Each host process parses only its byte-range slice of the FASTQ
(io/fastq.byte_range_for_process), packs it locally, and contributes its
rows to a global device array via jax.make_array_from_process_local_data
over the ("data", "index") mesh spanning every process's devices.  The
single jitted shard_map step (dist/quant_sharded.py) then runs SPMD
across hosts: collectives ride the devices' interconnect within a host and the network across hosts,
and outputs come back fully replicated so every process holds the final
pi / counts.

Cross-host semantics note: the reference's duplicate-read-ID rule (last
valid occurrence wins, src/main.cpp:150) applies within each host's
slice; duplicate IDs straddling slice boundaries are both kept.  Real
FASTQ read IDs are unique, so this deviation is theoretical; it is
asserted nowhere and documented in PARITY.md.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from sketch_rna_tpu.config import QuantConfig
from sketch_rna_tpu.index.artifact import IndexArtifact
from sketch_rna_tpu.io.packing import PackedReads

log = logging.getLogger(__name__)


def _allgather_host_ints(values) -> np.ndarray:
    """[P, len(values)] int64 across processes (tiny control-plane sync)."""
    from jax.experimental import multihost_utils

    arr = np.asarray(values, dtype=np.int64)
    return np.asarray(multihost_utils.process_allgather(arr))


def quantify_sharded_multihost(
    index: IndexArtifact,
    local_packed: PackedReads,
    config: Optional[QuantConfig] = None,
    mesh=None,
):
    """Sharded STREAMING quant where each process supplies only ITS read
    slice: the same scan-chunked engine as the single-process path
    (pipeline._sharded_stream_core) run SPMD across hosts, so HBM stays
    O(chunk + class buffer) at any per-host read count.

    All processes must call this collectively (same index, same config).
    Static program parameters that depend on data (tier widths) are made
    identical everywhere via an allgather-max consensus.  Returns the
    replicated QuantResult on every process.
    """
    from sketch_rna_tpu.dist.mesh import index_device_bytes, make_mesh, mesh_factor
    from sketch_rna_tpu.pipeline import (
        _device_index,
        _empty_result,
        _sharded_stream_core,
        _tier_widths_for,
    )

    config = config or QuantConfig(kmer_lengths=tuple(index.kmer_lengths))
    n_proc = jax.process_count()
    if mesh is None:
        # Deterministic across processes: the shape-only estimate depends
        # only on the (shared) index artifact, so every process widens
        # identically.
        dp, ip = mesh_factor(
            len(jax.devices()), index_bytes=index_device_bytes(index)
        )
        mesh = make_mesh(dp, ip)
    dp = mesh.shape["data"]
    if dp % n_proc:
        raise ValueError(
            f"data axis {dp} must divide evenly across {n_proc} processes"
        )
    dp_local = dp // n_proc
    Bl = config.batch_size

    # Control plane: local row counts and pad widths -> common shapes.
    local_R = local_packed.num_reads
    local_L = int(local_packed.padded_len) if local_R else 0
    meta = _allgather_host_ints([local_R, local_L])
    R_global = int(meta[:, 0].sum())
    if R_global == 0:
        return _empty_result(index)
    L = max(int(meta[:, 1].max()), 128)
    max_local = int(meta[:, 0].max())
    step_rows = Bl * dp_local  # this process's rows per scan step
    nb = max(-(-max_local // step_rows), 1)
    rows_local = nb * step_rows

    codes = np.zeros((rows_local, L), np.uint8)
    lengths = np.zeros(rows_local, np.int32)
    if local_R:
        codes[:local_R, :local_L] = np.asarray(local_packed.codes)
        lengths[:local_R] = np.asarray(local_packed.lengths)

    # Tier widths are STATIC shard_map parameters: calibrate on the local
    # sample, then take the cross-process max so every process compiles
    # the identical program (wider windows only add padding).
    ks = tuple(index.kmer_lengths)
    caps = tuple(config.sketch_capacity_for(k, L) for k in ks)
    bpacked, _post, bucket_meta = _device_index(index, ks)
    widths, _probe_w = _tier_widths_for(
        index, local_packed, config, bpacked, bucket_meta, caps, ks, L
    )
    # nb needs no extra consensus: it derives from max_local, which is
    # already the cross-process max (meta is allgathered above).
    wmeta = _allgather_host_ints(list(widths))
    widths = tuple(int(x) for x in wmeta.max(axis=0))

    codes_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, "data", None)),
        codes.reshape(nb, step_rows, L),
    )
    lengths_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, "data")),
        lengths.reshape(nb, step_rows),
    )
    return _sharded_stream_core(
        index, config, mesh, codes_g, lengths_g, R_global, widths, nb
    )
