"""Device-facing settings: compile-cache placement, published peaks, the
memory-derived index budget, multi-process start-up, the native build,
and a scan that keeps accelerator-specific branches out of the code."""

import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- compilation cache ---------------------------------------------------


def test_compile_cache_defaults_into_checkout(monkeypatch):
    from sketch_rna_tpu.utils import compilecache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilecache.cache_dir() == os.path.join(_REPO, ".jax_cache")
    out = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(_REPO, ".jax_cache", "x")],
        cwd=_REPO,
    )
    assert out.returncode == 0, ".jax_cache is not gitignored"


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    nothing in code sets another (fresh process: JAX reads the variable
    at import)."""
    probe = (
        "import jax\n"
        "from sketch_rna_tpu.utils.compilecache import enable_compilation_cache\n"
        "print(enable_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"),
               PYTHONPATH=_REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "cc")] * 2
    assert not os.path.exists(os.path.join(_REPO, ".jax_cache", "never"))


# --- published peaks -----------------------------------------------------


def test_peaks_table_has_h100():
    from sketch_rna_tpu.utils.roofline import device_peaks, roofline

    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["f32_ops_per_s"] == 67e12
    out = roofline(
        {"probe_bytes": int(3.35e9), "group_lanes": 10**6},
        {"match_scan": 1.0, "em_assign": 1.0},
        1.0,
        0,
        "NVIDIA H100 80GB HBM3",
    )
    assert out["probe_gather"]["frac_hbm_peak"] == 0.001
    assert out["group_sort"] == {"lanes": 10**6, "mlanes_per_s": 1.0}
    assert out["summary"]["dominant_bound"] == "probe_gather"


def test_peaks_unknown_device_raises():
    from sketch_rna_tpu.utils.roofline import device_peaks, roofline

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("Some Other Accelerator")
    with pytest.raises(KeyError):
        roofline({}, {}, 1.0, 0, "cpu")


# --- index budget --------------------------------------------------------


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_index_budget_from_device_memory(monkeypatch):
    """A quarter of the device's allocatable bytes: on an 80 GB card a
    60 GiB limit gives 15 GiB, so a 20 GiB index shards two ways on 8
    devices and a 1 GiB index stays replicated."""
    import jax

    from sketch_rna_tpu.dist import mesh

    gib = 1 << 30
    card = _FakeDevice("gpu", {"bytes_limit": 60 * gib})
    assert mesh.index_budget_bytes(card) == 15 * gib
    monkeypatch.delenv("SKETCH_TPU_INDEX_HBM_BUDGET", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda: [card])
    assert mesh.mesh_factor(8, index_bytes=1 * gib) == (4, 2)
    assert mesh.mesh_factor(8, index_bytes=20 * gib) == (4, 2)
    assert mesh.mesh_factor(8, index_bytes=40 * gib) == (2, 4)
    assert mesh.mesh_factor(4, index_bytes=20 * gib) == (2, 2)
    assert mesh.mesh_factor(4, index_bytes=1 * gib, max_index_shards=1) == (4, 1)


def test_index_budget_cpu_and_unknown(monkeypatch):
    from sketch_rna_tpu.dist import mesh

    assert mesh.index_budget_bytes(_FakeDevice("cpu", None)) == 4 << 30
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        mesh.index_budget_bytes(_FakeDevice("gpu", {}))
    # The CPU test backend keeps the fixed budget end to end.
    monkeypatch.delenv("SKETCH_TPU_INDEX_HBM_BUDGET", raising=False)
    assert mesh.mesh_factor(8, index_bytes=12 << 30) == (2, 4)


# --- multi-process start-up -----------------------------------------------


def test_failed_distributed_init_raises(monkeypatch):
    import jax

    from sketch_rna_tpu.dist import init

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        init.init_distributed("localhost:1", num_processes=2, process_id=0)
    assert init.init_distributed() is False


@pytest.mark.parametrize(
    "coord,pid,want",
    [
        ("localhost:1234", 1, [1]),
        ("127.0.0.1:1234", 0, [0]),
        ("node7:1234", 3, None),
        (None, 0, None),
        ("localhost:1234", None, None),
    ],
)
def test_local_device_ids(coord, pid, want):
    from sketch_rna_tpu.dist.init import local_device_ids_for

    assert local_device_ids_for(coord, pid) == want


# --- native library --------------------------------------------------------


def test_native_build_failure_raises(monkeypatch):
    """A build that fails is an error on the native path, never a silent
    switch to the Python parsers; native_available() reports it."""
    from sketch_rna_tpu.io import native

    def fail(*a, **kw):
        raise subprocess.CalledProcessError(2, ["make"], stderr=b"no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native.subprocess, "run", fail)
    with pytest.raises(native.NativeUnavailable, match="no compiler"):
        native.pack_fastq_native("/nonexistent.fq", min_len=31)
    assert native.native_available() is False


# --- no accelerator-specific code paths -----------------------------------


def _sources():
    roots = [os.path.join(_REPO, d) for d in ("sketch_rna_tpu", "scripts", "tests")]
    files = [os.path.join(_REPO, f) for f in ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for root in roots:
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names if n.endswith((".py", ".sh"))]
    me = os.path.abspath(__file__)
    return [f for f in files if os.path.abspath(f) != me]


@pytest.mark.parametrize(
    "what,pattern",
    [
        ("TPU Pallas import", r"pallas(\.| import )tpu|pltpu"),
        ("branch on a TPU platform or device kind", r"""["'][Tt][Pp][Uu]["']"""),
        ("TPU generation constant", r"\b[Vv]5[ep]\b|V5E_"),
    ],
)
def test_no_tpu_specific_code(what, pattern):
    hits = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            for n, line in enumerate(fh, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, _REPO)}:{n}: {line.strip()}")
    assert not hits, f"{what}:\n" + "\n".join(hits)


# --- index build backend ---------------------------------------------------


@pytest.mark.parametrize("env,want", [(None, "cpu"), ("accelerator", "accelerator"), ("cpu", "cpu")])
def test_index_backend_rule(monkeypatch, env, want):
    """Hash on the accelerator when the default backend is one (measured
    faster on the GPU); on the CPU backend the host path; the variable
    overrides either way."""
    from sketch_rna_tpu.index import build

    if env is None:
        monkeypatch.delenv("SKETCH_TPU_INDEX_BACKEND", raising=False)
    else:
        monkeypatch.setenv("SKETCH_TPU_INDEX_BACKEND", env)
    assert build._index_backend() == want


def test_bench_refuses_cpu():
    """bench.py times only the GPU: on the CPU backend it exits nonzero
    and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(_REPO, "bench.py")],
                         cwd=_REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "quant_reads_per_s_per_chip" not in out.stdout
