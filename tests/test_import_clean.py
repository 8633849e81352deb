"""Importing the package must not initialize the XLA backend.

jax.distributed.initialize (multi-host CLI) refuses to run after any
backend initialization, so no module may create device values at import
time (module-level jnp constants did exactly that and silently broke
every multi-process run — see test_multiprocess.py).  Run in a
subprocess so this test is immune to whatever the test session itself
has already initialized.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
from jax._src import xla_bridge
import sketch_rna_tpu
import sketch_rna_tpu.cli
import sketch_rna_tpu.pipeline
import sketch_rna_tpu.stream
import sketch_rna_tpu.dist.init
import sketch_rna_tpu.dist.quant_sharded
import sketch_rna_tpu.dist.quant_stream
import sketch_rna_tpu.dist.multihost
import sketch_rna_tpu.em.checkpoint
import sketch_rna_tpu.index.refbin
import sketch_rna_tpu.io.native
import sketch_rna_tpu.oracle.reference_oracle
assert not xla_bridge.backends_are_initialized(), (
    "a module initialized the XLA backend at import time"
)
print("IMPORT-CLEAN")
"""


def test_package_import_is_backend_clean():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        env=env,
        capture_output=True,
        timeout=300,
        cwd=_REPO,
    )
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert "IMPORT-CLEAN" in out.stdout.decode()
