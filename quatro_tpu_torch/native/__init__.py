"""ctypes bindings for the native host-side data path.

Counterpart of ``quatro_tpu/native/__init__.py`` over the port's own copy
of its C source (``quatro_native.c``): the KITTI ``.bin`` reader, the
threaded padded-batch packer and the prefetching ``ScanLoader``. The
library is built at first use, never at import, with the system compiler,

    cc -O3 -shared -fPIC -pthread quatro_native.c
       -o build/native/libquatro_native.so

into ``build/native/`` beside the package (git-ignored; no
``-march=native``, so the library does not depend on the host that built
it); a library newer than its source is reused. ``available()`` says
whether it builds and loads; callers with a numpy route (io/kitti.py)
take it only when it does not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "quatro_native.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SO = BUILD_DIR / "libquatro_native.so"

_lib = None
_lib_lock = threading.Lock()


def _build() -> None:
    """Compile the library into a temporary file and move it into place
    (several processes may build at once). Raises OSError when no
    compiler builds it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for cc in ("cc", "gcc", "clang"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", "-pthread",
                            str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            os.unlink(tmp)
            errors.append(f"{cc}: {e}")
            continue
        os.replace(tmp, _SO)
        return
    raise OSError("no working C compiler for quatro_native: "
                  + "; ".join(errors))


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.quatro_load_kitti_bin.restype = ctypes.c_long
        lib.quatro_load_kitti_bin.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.quatro_pack_batch.restype = ctypes.c_int
        lib.quatro_pack_batch.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
        lib.quatro_loader_create.restype = ctypes.c_void_p
        lib.quatro_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int]
        lib.quatro_loader_next.restype = ctypes.c_long
        lib.quatro_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.quatro_loader_stop.restype = None
        lib.quatro_loader_stop.argtypes = [ctypes.c_void_p]
        lib.quatro_loader_destroy.restype = None
        lib.quatro_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """True iff the native library builds and loads.

    Tells "no toolchain / build failed" (permanent: callers take their
    numpy route) from per-file I/O errors, which the loaders raise and
    which must not turn the native route off."""
    try:
        _load()
        return True
    except OSError:
        return False


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_kitti_bin(path: str) -> np.ndarray:
    """mmap-backed KITTI .bin load -> (N, 4) float32 (x, y, z, intensity)."""
    lib = _load()
    n = lib.quatro_load_kitti_bin(os.fsencode(path), None, 0)
    if n < 0:
        raise IOError(f"failed to load {path}")
    out = np.empty((n, 4), np.float32)
    got = lib.quatro_load_kitti_bin(os.fsencode(path), _f32p(out), n)
    if got < 0:
        raise IOError(f"failed to read {path}")
    return out[:got]


def pack_batch(clouds, capacity: int, n_threads: int = 0):
    """Pack a list of (n_i, 3|4) float32 arrays into padded
    (B, capacity, 3) points + (B, capacity) bool mask, in parallel."""
    if n_threads <= 0:
        n_threads = min(len(clouds), os.cpu_count() or 1)
    lib = _load()
    b = len(clouds)
    clouds = [np.ascontiguousarray(c, np.float32) for c in clouds]
    stride = clouds[0].shape[1] if clouds else 3
    if any(c.ndim != 2 or c.shape[1] != stride or stride < 3
           for c in clouds):
        raise ValueError("pack_batch takes (n_i, 3) or (n_i, 4) clouds of "
                         "one width")
    ptrs = (ctypes.POINTER(ctypes.c_float) * b)(*[_f32p(c) for c in clouds])
    sizes = (ctypes.c_long * b)(*[c.shape[0] for c in clouds])
    out_points = np.empty((b, capacity, 3), np.float32)
    out_mask = np.empty((b, capacity), np.uint8)
    rc = lib.quatro_pack_batch(
        ptrs, sizes, b, stride, capacity, _f32p(out_points),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads)
    if rc != 0:
        raise RuntimeError("quatro_pack_batch failed")
    return out_points, out_mask.astype(bool)


class ScanLoader:
    """Prefetching KITTI scan loader (a native pthread ring buffer).

    Worker threads read and pad scans ahead of the consumer, so host IO
    overlaps the card's work: the streaming form of the reference's
    per-frame fread loop (examples/run_global_registration.cpp:377-402).
    Yields (points (capacity, 3) f32, mask (capacity,) bool) numpy arrays
    in file order; a file that cannot be read raises IOError at its turn,
    and the files after it still come.

        with ScanLoader(paths, capacity=131072) as loader:
            for points, mask in loader:
                ...
    """

    def __init__(self, paths, capacity: int, n_workers: int = 4,
                 queue_depth: int = 8):
        self._lib = _load()
        self._paths = [os.fspath(p) for p in paths]
        self.capacity = int(capacity)
        # close()/next() handshake: _cond guards _handle/_active/_closing;
        # a consumer enters the C call only while counted in _active, and
        # close() quiesces (stop, then wait for _active == 0) before
        # destroy, so no consumer calls into freed memory.
        self._cond = threading.Condition()
        self._active = 0
        self._closing = False
        if not self._paths:      # empty sequence: an exhausted iterator
            self._handle = None
            return
        arr = (ctypes.c_char_p * len(self._paths))(
            *[os.fsencode(p) for p in self._paths])
        self._handle = self._lib.quatro_loader_create(
            arr, len(self._paths), self.capacity, n_workers, queue_depth)
        if not self._handle:
            raise RuntimeError("quatro_loader_create failed")

    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            if self._handle is None or self._closing:
                raise StopIteration
            self._active += 1
            handle = self._handle
        try:
            points = np.empty((self.capacity, 3), np.float32)
            mask = np.empty(self.capacity, np.uint8)
            n = self._lib.quatro_loader_next(
                handle, _f32p(points),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()
        if n == -2:
            raise StopIteration
        if n == -1:
            raise IOError("scan load failed (bad path or unreadable file)")
        return points, mask.astype(bool)

    def close(self):
        with self._cond:
            if self._handle is None:
                return
            if self._closing:
                # another close() owns the teardown: wait it out
                while self._handle is not None:
                    self._cond.wait()
                return
            self._closing = True
            handle = self._handle
        # 1) signal shutdown (wakes consumers blocked inside C; one that
        #    enters C after this sees the flag, the memory still alive),
        # 2) wait for the Python-side consumers to leave, 3) free.
        self._lib.quatro_loader_stop(handle)
        with self._cond:
            while self._active > 0:
                self._cond.wait()
            self._handle = None
            self._cond.notify_all()
        self._lib.quatro_loader_destroy(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # the interpreter may be tearing down: nothing to report to
        try:
            self.close()
        except Exception:
            pass
