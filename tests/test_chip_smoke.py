"""chip_smoke.py: its refusal to run without a GPU, its last line, its
oracle comparator, and rehearsals of its phases at tiny sizes on the
CPU backend (the card runs them at full size)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.device_summary()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_no_result_without_gpu(tmp_path, where):
    """Under the CPU backend, or copied away from the package, the script
    exits nonzero and prints no ok line."""
    script = os.path.join(_REPO, "chip_smoke.py")
    cwd = _REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_ok_line_shape():
    line = cs.ok_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert "\n" not in line


@pytest.fixture(scope="module")
def tiny_oracle_run(tmp_path_factory):
    """A float64 CLI quant of a tiny transcriptome and its oracle rows."""
    d = str(tmp_path_factory.mktemp("oracle"))
    fa, fq, expected = cs.write_oracle_problem(d, 40, 256, 5)
    idx = os.path.join(d, "o.npz")
    cs.cli(["-o", "index", "-k", "31", fa, idx])
    out = os.path.join(d, "o.csv")
    cs.cli(["-o", "quant", "--em-dtype", "float64", idx, fq, out])
    return cs.read_csv(out), expected


@pytest.mark.parametrize("change", ["none", "perturbed", "missing_row", "extra_row"])
def test_oracle_comparator(tiny_oracle_run, change):
    rows, expected = tiny_oracle_run
    rows = dict(rows)
    assert len(rows) > 5
    name = sorted(rows)[3]
    if change == "none":
        assert cs.compare_with_oracle(rows, expected, cs.F64_RTOL) < 5e-6
        return
    if change == "perturbed":
        numreads, abundance = rows[name]
        rows[name] = (numreads, repr(float(abundance) * (1 + 1e-5)))
    elif change == "missing_row":
        del rows[name]
    else:
        rows["T99999"] = ("1", "1")
    with pytest.raises(cs.SmokeFailure):
        cs.compare_with_oracle(rows, expected, cs.F64_RTOL)


def test_printable_range_brackets_rounding():
    # 1.234565 prints as 1.23456 or 1.23457 depending on the last bits;
    # either is accepted within 5e-9, a neighbour further off is not.
    lo, hi = cs._printable_range(1.2345650000001, 5e-9)
    assert lo == 1.23456 or lo == 1.23457
    assert hi == 1.23457
    assert cs._printable_range(2.0, 5e-9) == (2.0, 2.0)


@pytest.fixture
def tiny_sizes(monkeypatch):
    import jax

    import sketch_rna_tpu.pipeline as pl

    monkeypatch.setattr(cs, "INDEX_TRANSCRIPTS", 200)
    monkeypatch.setattr(cs, "FUSED_READS", 1500)
    monkeypatch.setattr(cs, "STREAMED_READS", 3000)
    monkeypatch.setattr(cs, "ORACLE_TRANSCRIPTS", 60)
    monkeypatch.setattr(cs, "ORACLE_READS", 256)
    # Phase 3 must take the streamed route: above the fused bound.
    monkeypatch.setattr(pl, "FUSED_MAX_PADDED_READS", 2048)
    monkeypatch.setattr(cs, "peak_bytes", lambda: 0)
    monkeypatch.setattr(
        cs, "device_summary", lambda: ("gpu", "rehearsal", len(jax.devices()))
    )
    monkeypatch.setattr(cs, "card_name_and_power", lambda: "rehearsal, 0 W")


def test_single_card_rehearsal(tiny_sizes, capsys):
    assert cs.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["ok"] is True
    assert out[-2] == "rehearsal, 0 W"
    text = "\n".join(out)
    for tag in ("[phase 1]", "[phase 2 fused]", "[phase 3 streamed]",
                "float32 CLI vs oracle", "float64 CLI vs oracle",
                "rerun byte-identical", "float32 vs float64"):
        assert tag in text, tag


def test_four_card_rehearsal(tiny_sizes, tmp_path, capsys):
    """The sharded CLI quant over the virtual CPU mesh matches device 0."""
    cs.four_cards(str(tmp_path))
    text = capsys.readouterr().out
    assert "[four-card] sharded vs single-card" in text


@pytest.mark.gpu
def test_oracle_checks_on_gpu(tmp_path):
    """chip_smoke's phase-4 oracle checks on the card, in a process of its
    own (this suite pins the CPU backend)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    probe = (
        "import chip_smoke as c\n"
        "c.device_summary()\n"
        "c.build_native()\n"
        f"c.oracle_checks({str(tmp_path)!r}, c.ORACLE_TRANSCRIPTS, c.ORACLE_READS)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout + out.stderr
