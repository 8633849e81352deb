"""jax.profiler integration (the equivalent of the reference's gprof
workflow, SURVEY.md §5: '-g -pg' + gprof report).

Set SKETCH_TPU_PROFILE=/some/dir to capture an XLA trace around the
quant pipeline; view with TensorBoard or xprof.
"""

from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger("sketch_rna_tpu.profiling")


@contextlib.contextmanager
def maybe_trace(tag: str):
    """Trace the enclosed block if SKETCH_TPU_PROFILE is set."""
    out_dir = os.environ.get("SKETCH_TPU_PROFILE")
    if not out_dir:
        yield
        return
    import jax

    path = os.path.join(out_dir, tag)
    os.makedirs(path, exist_ok=True)
    log.info("capturing jax.profiler trace -> %s", path)
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
