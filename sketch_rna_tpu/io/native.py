"""ctypes bindings to the native fastio library (native/fastio.cpp).

The library is built from the committed sources by `make -C native`
before its first use in a process (a no-op when it is up to date, so a
stale or foreign copy is never loaded as is), and exposes drop-in
replacements for the Python parsers:
  pack_fastq_native(path, min_len, pad_len) -> (PackedReads, stats)
  load_fasta_native(path)                   -> FastaRecords

A failed build or load raises NativeUnavailable; native_available()
answers the question without raising.  The pure-Python parsers in
io/fasta.py and io/fastq.py remain the semantic reference (tests assert
both agree).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from sketch_rna_tpu.io.fasta import FastaRecords
from sketch_rna_tpu.io.packing import PackedReads

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libfastio.so")
# Serialises `make` across processes (parallel test workers, multi-process
# quant): two concurrent builds would write the library while another
# process loads it.
_BUILD_LOCK = os.path.join(_NATIVE_DIR, ".build.lock")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    """The native fastio library could not be built or loaded."""


@contextlib.contextmanager
def build_lock():
    """Hold the cross-process lock under which native/ is built and the
    library is opened."""
    with open(_BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load() -> ctypes.CDLL:
    global _lib, _load_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise NativeUnavailable(_load_error)
        try:
            with build_lock():
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "libfastio.so"],
                    check=True,
                    capture_output=True,
                    timeout=300,
                )
                lib = ctypes.CDLL(_SO_PATH)
        except subprocess.CalledProcessError as e:
            _load_error = (
                f"native fastio build failed: {e.stderr.decode(errors='replace')}"
            )
            raise NativeUnavailable(_load_error) from e
        except (OSError, subprocess.SubprocessError) as e:
            _load_error = f"native fastio build or load failed: {e}"
            raise NativeUnavailable(_load_error) from e
        lib.fastq_open_scan.restype = ctypes.c_void_p
        lib.fastq_open_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_open_scan_mt.restype = ctypes.c_void_p
        lib.fastq_open_scan_mt.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_pack.restype = ctypes.c_int
        lib.fastq_pack.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.fastq_pack_range.restype = ctypes.c_int
        lib.fastq_pack_range.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.fastq_pack_range2.restype = ctypes.c_int
        lib.fastq_pack_range2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.fastq_ids_size.restype = ctypes.c_int64
        lib.fastq_ids_size.argtypes = [ctypes.c_void_p]
        lib.fastq_get_ids.restype = ctypes.c_int
        lib.fastq_get_ids.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_close.restype = None
        lib.fastq_close.argtypes = [ctypes.c_void_p]
        lib.fasta_open_scan.restype = ctypes.c_void_p
        lib.fasta_open_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fasta_seq_len.restype = ctypes.c_int64
        lib.fasta_seq_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fasta_name_len.restype = ctypes.c_int64
        lib.fasta_name_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fasta_get.restype = ctypes.c_int
        lib.fasta_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]
        lib.fasta_close.restype = None
        lib.fasta_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        _load()
    except NativeUnavailable:
        return False
    return True


def pack_fastq_native(
    path: str,
    min_len: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    with_ids: bool = False,
) -> Tuple[PackedReads, dict]:
    """Parse+filter+pack a FASTQ with the native library.

    Semantics identical to load_fastq_dict + pack_reads (tests assert it):
    header-'@' heuristic, uppercase-ACGT validation, min_len filter,
    last-wins duplicate IDs.
    """
    lib = _load()
    n_valid = ctypes.c_int64()
    n_seen = ctypes.c_int64()
    n_invalid = ctypes.c_int64()
    max_len = ctypes.c_int64()
    h = lib.fastq_open_scan(
        path.encode(), min_len, ctypes.byref(n_valid), ctypes.byref(n_seen),
        ctypes.byref(n_invalid), ctypes.byref(max_len),
    )
    if not h:
        raise FileNotFoundError(f"Could not open FASTQ file: {path}")
    try:
        n = n_valid.value
        L = pad_len if pad_len is not None else max(int(max_len.value), min_len)
        codes = np.zeros((n, L), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        if n:
            nt = n_threads or min(os.cpu_count() or 1, 16)
            rc = lib.fastq_pack(
                h,
                L,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                nt,
            )
            if rc != 0:
                raise RuntimeError("fastq_pack failed")
        ids: Optional[list] = None
        if with_ids and n:
            size = lib.fastq_ids_size(h)
            buf = ctypes.create_string_buffer(int(size))
            offs = np.zeros(n + 1, dtype=np.int64)
            lib.fastq_get_ids(h, buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            raw = buf.raw
            ids = [raw[offs[i] : offs[i + 1]].decode() for i in range(n)]
        stats = {
            "n_seen": int(n_seen.value),
            "n_invalid": int(n_invalid.value),
            "max_len": int(max_len.value),
        }
        return PackedReads(codes, lengths, ids if ids is not None else [str(i) for i in range(n)]), stats
    finally:
        lib.fastq_close(h)


class NativeFastqScan:
    """A scanned-but-unpacked FASTQ held open for range packing.

    fastq_open_scan already performed the full parse + validation +
    global last-wins dedup (one mmap pass, views only), so packing any
    record range later is semantically identical to whole-file packing —
    chunk boundaries cannot change which reads exist.
    """

    def __init__(self, path: str, min_len: int, scan_threads: int = 0):
        lib = _load()
        self._lib = lib
        n_valid = ctypes.c_int64()
        n_seen = ctypes.c_int64()
        n_invalid = ctypes.c_int64()
        max_len = ctypes.c_int64()
        # scan_threads=0 auto-selects (parallel byte-range scan for big
        # files, sequential otherwise); >0 forces a count (tests).
        self._h = lib.fastq_open_scan_mt(
            path.encode(), min_len, scan_threads, ctypes.byref(n_valid),
            ctypes.byref(n_seen), ctypes.byref(n_invalid), ctypes.byref(max_len),
        )
        if not self._h:
            raise FileNotFoundError(f"Could not open FASTQ file: {path}")
        self.num_reads = int(n_valid.value)
        self.max_len = int(max_len.value)
        self.stats = {
            "n_seen": int(n_seen.value),
            "n_invalid": int(n_invalid.value),
            "max_len": self.max_len,
        }

    def pack_range(
        self, start: int, count: int, pad_len: int, n_threads: Optional[int] = None
    ) -> PackedReads:
        codes = np.zeros((count, pad_len), dtype=np.uint8)
        lengths = np.zeros(count, dtype=np.int32)
        if count:
            nt = n_threads or min(os.cpu_count() or 1, 16)
            rc = self._lib.fastq_pack_range(
                self._h,
                start,
                count,
                pad_len,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                nt,
            )
            if rc != 0:
                raise RuntimeError("fastq_pack_range failed")
        return PackedReads(codes, lengths, [])

    def pack_range2(
        self,
        start: int,
        count: int,
        pad_len: int,
        n_threads: Optional[int] = None,
        out_rows: Optional[int] = None,
    ) -> "Packed2Reads":
        """2-bit-packed range packing (4 bases/byte): quarters the
        host->device bytes vs pack_range.  pad_len must be a multiple
        of 4.  out_rows >= count zero-pads extra rows host-side so the
        device never needs a pad dispatch."""
        from sketch_rna_tpu.io.packing import Packed2Reads

        if pad_len % 4:
            raise ValueError("pad_len must be a multiple of 4")
        rows = out_rows if out_rows is not None else count
        if rows < count:
            raise ValueError("out_rows < count")
        codes2 = np.zeros((rows, pad_len // 4), dtype=np.uint8)
        lengths = np.zeros(rows, dtype=np.int32)
        if count:
            nt = n_threads or min(os.cpu_count() or 1, 16)
            rc = self._lib.fastq_pack_range2(
                self._h,
                start,
                count,
                pad_len,
                codes2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                nt,
            )
            if rc != 0:
                raise RuntimeError("fastq_pack_range2 failed")
        return Packed2Reads(codes2, lengths, pad_len, n_real=count)

    def close(self) -> None:
        if self._h:
            self._lib.fastq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def chunks_from_scan(
    scan: NativeFastqScan,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    close: bool = True,
):
    """Double-buffered chunk feed for stream.quantify_streamed.

    Yields PackedReads of up to chunk_reads rows from an open scan, all
    padded to ONE shared pad_len (so the device programs compile once).
    While the consumer processes chunk c, a background thread packs
    chunk c+1 (ctypes releases the GIL during the C call, so the
    overlap is real).  Closes the scan when exhausted unless close=False.
    """
    from concurrent.futures import ThreadPoolExecutor

    try:
        n = scan.num_reads
        if n == 0:
            return
        L = pad_len if pad_len is not None else max(scan.max_len, 1)
        starts = list(range(0, n, chunk_reads))
        with ThreadPoolExecutor(max_workers=1) as ex:

            def pack(s):
                return scan.pack_range(s, min(chunk_reads, n - s), L, n_threads)

            fut = ex.submit(pack, starts[0])
            for s in starts[1:]:
                cur = fut.result()
                fut = ex.submit(pack, s)
                yield cur
            yield fut.result()
    finally:
        if close:
            scan.close()


def chunks_from_scan2(
    scan: NativeFastqScan,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
    close: bool = True,
    row_multiple: int = 1,
):
    """2-bit-packed double-buffered chunk feed (see chunks_from_scan).

    Yields Packed2Reads — a quarter of the host->device bytes per chunk.
    row_multiple pads each chunk's rows host-side to that multiple (the
    device batch size), so the consumer never pays a pad dispatch.
    pad_len is rounded up to a multiple of 4 (2-bit byte packing).
    """
    from concurrent.futures import ThreadPoolExecutor

    try:
        n = scan.num_reads
        if n == 0:
            return
        L = pad_len if pad_len is not None else max(scan.max_len, 1)
        L = ((L + 3) // 4) * 4
        starts = list(range(0, n, chunk_reads))
        m = max(row_multiple, 1)
        with ThreadPoolExecutor(max_workers=1) as ex:

            def pack(s):
                c = min(chunk_reads, n - s)
                rows = ((c + m - 1) // m) * m
                return scan.pack_range2(s, c, L, n_threads, out_rows=rows)

            fut = ex.submit(pack, starts[0])
            for s in starts[1:]:
                cur = fut.result()
                fut = ex.submit(pack, s)
                yield cur
            yield fut.result()
    finally:
        if close:
            scan.close()


class LazyScanFeed:
    """A 2-bit chunk feed whose native record scan runs on a background
    thread.

    Construction returns immediately; the scan (mmap + parallel
    byte-range parse + dedup — several seconds at 32M reads) overlaps
    whatever the caller does next: at GENCODE streaming scale that is
    the device index upload (stream.quantify_streamed's
    index_prep), which previously serialized after the scan.  Any
    attribute needing scan results (num_reads, max_len, pad_len,
    iteration) joins the thread first; scan errors re-raise there.
    """

    def __init__(
        self,
        path: str,
        min_len: int,
        chunk_reads: int,
        pad_len: Optional[int] = None,
        row_multiple: int = 1,
    ):
        import threading

        self._path = path
        self._min_len = min_len
        self._chunk_reads = chunk_reads
        self._pad_len = pad_len
        self._row_multiple = row_multiple
        self._scan: Optional[NativeFastqScan] = None
        self._exc: Optional[BaseException] = None
        self._started = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            self._scan = NativeFastqScan(self._path, self._min_len)
        except BaseException as e:  # re-raised at join
            self._exc = e

    @property
    def scan(self) -> NativeFastqScan:
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._scan

    @property
    def num_reads(self) -> int:
        return self.scan.num_reads

    @property
    def pad_len(self) -> int:
        if self._pad_len is not None:
            return self._pad_len
        return max(((self.scan.max_len + 7) // 8) * 8, self._min_len)

    def __iter__(self):
        self._started = True
        return chunks_from_scan2(
            self.scan,
            self._chunk_reads,
            self.pad_len,
            row_multiple=self._row_multiple,
            close=True,
        )

    def close(self):
        # chunks_from_scan2 closes the scan once iteration starts; this
        # covers the error-before-first-chunk path.  Called from caller
        # finally blocks, so it must not raise a late background-scan
        # error over the exception already in flight — join, log, and
        # close only a scan that actually opened.
        if self._started:
            return
        self._thread.join()
        if self._exc is not None:
            log = logging.getLogger(__name__)
            log.warning("background FASTQ scan failed during cleanup: %s",
                        self._exc)
            return
        if self._scan is not None:
            self._scan.close()


def iter_fastq_chunks_native(
    path: str,
    min_len: int,
    chunk_reads: int,
    pad_len: Optional[int] = None,
    n_threads: Optional[int] = None,
):
    """Scan + double-buffered chunk feed in one call (see chunks_from_scan)."""
    scan = NativeFastqScan(path, min_len)
    if pad_len is None:
        pad_len = max(scan.max_len, min_len, 1)
    yield from chunks_from_scan(scan, chunk_reads, pad_len, n_threads)


def load_fasta_native(path: str) -> FastaRecords:
    lib = _load()
    n_records = ctypes.c_int64()
    n_invalid = ctypes.c_int64()
    h = lib.fasta_open_scan(path.encode(), ctypes.byref(n_records), ctypes.byref(n_invalid))
    if not h:
        raise FileNotFoundError(f"Could not open FASTA file: {path}")
    try:
        names, seqs = [], []
        for i in range(n_records.value):
            nl = lib.fasta_name_len(h, i)
            sl = lib.fasta_seq_len(h, i)
            nb = ctypes.create_string_buffer(int(nl))
            sb = ctypes.create_string_buffer(int(sl))
            lib.fasta_get(h, i, nb, sb)
            names.append(nb.raw.decode())
            seqs.append(sb.raw.decode())
        return FastaRecords(names, seqs, int(n_invalid.value))
    finally:
        lib.fasta_close(h)
