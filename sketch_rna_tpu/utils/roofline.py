"""Speed-of-light accounting: judge measured throughput against the
device's published peaks.

The quant pipeline does almost no matrix products, so the relevant
rooflines are elementwise 32-bit throughput (hashing, scans) and memory
bandwidth (the bucket-probe row gather, table reads and writes).
QuantResult.sizes carries exact static counts of the shapes the device
processed (pipeline._match_tables); this module turns them and phase
times into achieved rates and shares of peak.  Sorts have no peak to
divide by and report lanes per second only.
"""

from __future__ import annotations

from typing import Dict

# Published peaks by jax device_kind.  Source: NVIDIA H100 Tensor Core
# GPU data sheet, SXM part (HBM3 bandwidth; FP32 outside the tensor
# cores, dense).  A device not listed here is an error, not a default.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_ops_per_s": 67e12,
    },
}


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Peak rates of one device of this kind (see PEAKS)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to utils/roofline.PEAKS with their source"
        ) from None


def roofline(
    sizes: Dict[str, int],
    timing: Dict[str, float],
    elapsed_s: float,
    em_iterations: int,
    device_kind: str,
    em_dtype_bytes: int = 4,
) -> Dict[str, dict]:
    """Per-phase achieved rates vs the peaks of device_kind.

    sizes/timing: QuantResult.sizes / .timing from a run with
    SKETCH_TPU_SYNC_PHASES=1 (per-phase attribution; without it the
    async phases drain at the fetch sync and only end-to-end rates are
    meaningful).  elapsed_s: end-to-end quant wall time.
    """
    peaks = device_peaks(device_kind)
    out: Dict[str, dict] = {}
    t_match = timing.get("match_scan", 0.0) or elapsed_s
    t_em = timing.get("em_assign", 0.0) or elapsed_s

    hash_ops = sizes.get("hash_ops", 0)
    if hash_ops:
        # Each 32-bit window hash XORs k precomputed rotated seeds; the
        # dedup sorts are counted under group_lanes.
        rate = hash_ops / t_match
        out["hash"] = {
            "ops": hash_ops,
            "gops_per_s": round(rate / 1e9, 2),
            "frac_f32_peak": round(rate / peaks["f32_ops_per_s"], 4),
        }
    probe_bytes = sizes.get("probe_bytes", 0)
    if probe_bytes:
        rate = probe_bytes / t_match
        out["probe_gather"] = {
            "bytes": probe_bytes,
            "gb_per_s": round(rate / 1e9, 2),
            "frac_hbm_peak": round(rate / peaks["hbm_bytes_per_s"], 4),
        }
    group_lanes = sizes.get("group_lanes", 0)
    if group_lanes:
        out["group_sort"] = {
            "lanes": group_lanes,
            "mlanes_per_s": round(group_lanes / t_match / 1e6, 1),
        }
    em_lanes = sizes.get("em_lanes", 0)
    if em_lanes and em_iterations:
        # Per iteration per lane: gather pi (4B) + write posterior (4B)
        # + scatter traffic (~8B) — ~16B/lane of device memory.
        em_bytes = em_lanes * em_iterations * (4 * em_dtype_bytes)
        rate = em_bytes / t_em
        out["em"] = {
            "lanes": em_lanes,
            "iterations": em_iterations,
            "lane_iters_per_s": round(em_lanes * em_iterations / t_em / 1e6, 1),
            "modeled_gb_per_s": round(rate / 1e9, 2),
            "frac_hbm_peak": round(rate / peaks["hbm_bytes_per_s"], 4),
        }
    # The binding constraint: largest share of peak across phases.
    bound, frac = None, 0.0
    for name, d in out.items():
        f = max(d.get("frac_hbm_peak", 0.0), d.get("frac_f32_peak", 0.0))
        if f > frac:
            bound, frac = name, f
    out["summary"] = {
        "device_kind": device_kind,
        "dominant_bound": bound,
        "frac_of_peak": round(frac, 4),
    }
    return out
