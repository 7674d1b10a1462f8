"""ctypes bindings + on-demand build of the native host runtime
(csrc/msslam_runtime.cpp): threaded decode/rectify prefetch pipeline, remap,
and VmRSS telemetry. Falls back gracefully (callers check `available()`)."""
from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "msslam_runtime.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "libmsslam_runtime.so")


def _build() -> str:
    """Build the library from its source on first use (it is not committed;
    a rebuild follows any newer source). Compiles to a private name and
    renames it into place, so concurrent processes never load a partial
    file."""
    src = os.path.abspath(_SRC)
    lib = os.path.abspath(_LIB)
    if (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src)):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             src, "-o", tmp, "-lpng", "-ljpeg", "-lz", "-lpthread"],
            check=True)
        os.replace(tmp, lib)
    return lib


@lru_cache()
def _lib():
    lib = ctypes.CDLL(_build())
    lib.msslam_pipeline_create.restype = ctypes.c_void_p
    lib.msslam_pipeline_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.msslam_pipeline_next.restype = ctypes.c_int
    lib.msslam_pipeline_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
    lib.msslam_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.msslam_decode_gray.restype = ctypes.c_int
    lib.msslam_decode_gray.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
    lib.msslam_remap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.msslam_vmrss_kb.restype = ctypes.c_long
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except Exception:
        return False


def vmrss_mb() -> float:
    return _lib().msslam_vmrss_kb() / 1024.0


def decode_gray(path: str, w: int, h: int) -> np.ndarray:
    out = np.empty((h, w), np.uint8)
    rc = _lib().msslam_decode_gray(path.encode(),
                                   out.ctypes.data_as(ctypes.c_void_p), w, h)
    if rc != 0:
        raise IOError(f"decode failed: {path}")
    return out


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray):
    h, w = src.shape
    dst = np.empty_like(src)
    _lib().msslam_remap(
        np.ascontiguousarray(src).ctypes.data_as(ctypes.c_void_p), w, h,
        np.ascontiguousarray(map_x, np.float32).ctypes.data_as(
            ctypes.c_void_p),
        np.ascontiguousarray(map_y, np.float32).ctypes.data_as(
            ctypes.c_void_p),
        dst.ctypes.data_as(ctypes.c_void_p))
    return dst


class PrefetchPipeline:
    """In-order prefetching stereo/mono frame source backed by the native
    worker pool (decode + optional rectification off the tracking thread)."""

    def __init__(self, paths_l, paths_r=None, width=0, height=0,
                 depth=8, n_workers=4, rect_maps=None):
        self.n = len(paths_l)
        self.w, self.h = width, height
        self.stereo = paths_r is not None
        self._pl = (ctypes.c_char_p * self.n)(
            *[p.encode() for p in paths_l])
        self._pr = None
        pr_arg = None
        if self.stereo:
            self._pr = (ctypes.c_char_p * self.n)(
                *[p.encode() for p in paths_r])
            pr_arg = self._pr
        rm_arg = None
        self._rm = None
        if rect_maps is not None:
            self._rm = np.ascontiguousarray(rect_maps, np.float32)
            assert self._rm.shape == (4, height, width)
            rm_arg = self._rm.ctypes.data_as(ctypes.c_void_p)
        self._h = _lib().msslam_pipeline_create(
            self._pl, pr_arg, self.n, width, height, depth, n_workers, rm_arg)
        self._i = 0

    def __len__(self):
        return self.n

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        out_l = np.empty((self.h, self.w), np.uint8)
        out_r = np.empty((self.h, self.w), np.uint8) if self.stereo else None
        rc = _lib().msslam_pipeline_next(
            self._h, out_l.ctypes.data_as(ctypes.c_void_p),
            out_r.ctypes.data_as(ctypes.c_void_p) if self.stereo else None)
        if rc != 0:
            raise StopIteration
        self._i += 1
        return (out_l, out_r) if self.stereo else out_l

    def close(self):
        if self._h:
            _lib().msslam_pipeline_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
