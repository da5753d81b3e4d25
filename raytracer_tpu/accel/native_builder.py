"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp).

The reference delegates BVH construction to the Vulkan driver's
fixed-function builder (vkCmdBuildAccelerationStructuresKHR,
acceleration_structure.odin:145-199). Our equivalent "native runtime
component" is a C++ binned-SAH builder compiled to a shared library; it
exists because the numpy builder's per-node Python overhead dominates scene
bake time for ~300k-triangle scenes.

The library is compiled on first use with `native/build.sh` (g++) into
`native/libbvh.so`, and rebuilt when the source is newer than it. The build
is part of the first bake's set-up time (`build_seconds` records it). A
failed build raises: there is no silent fallback to the numpy builder.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
SOURCE_PATH = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")
LIBRARY_PATH = os.path.join(_NATIVE_DIR, "libbvh.so")
_BUILD_SCRIPT = os.path.join(_NATIVE_DIR, "build.sh")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds this process spent compiling the library (0.0 when it was
# already built and up to date).
build_seconds = 0.0


def _needs_build() -> bool:
    return (not os.path.exists(LIBRARY_PATH)
            or os.path.getmtime(LIBRARY_PATH) < os.path.getmtime(SOURCE_PATH))


def _build() -> None:
    global build_seconds
    t0 = time.perf_counter()
    proc = subprocess.run(["sh", _BUILD_SCRIPT], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {LIBRARY_PATH} failed (rc={proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    _log.info("built %s in %.1f s", LIBRARY_PATH, build_seconds)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build()
        lib = ctypes.CDLL(LIBRARY_PATH)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.bvh_build.argtypes = [
            ctypes.c_int64,  # num_tris
            f32p, f32p, f32p,  # v0, e1, e2 [T,3]
            ctypes.c_int32,  # leaf_size
            f32p, f32p,  # out nodes_min/max [2T,3]
            i32p, i32p, i32p, i32p, i32p,  # skip, first, count, order, parent
        ]
        lib.bvh_build.restype = ctypes.c_int64  # node count (<0 = error)
        _lib = lib
        return _lib


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     leaf_size: int = 8):
    from raytracer_tpu.accel.bvh import BVH

    t = len(v0)
    if t <= 0 or leaf_size <= 0:
        raise ValueError(
            f"cannot build a BVH over {t} triangles with leaf size "
            f"{leaf_size}")
    lib = _load()
    cap = max(2 * t, 2)
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(t, np.int32)
    parent = np.empty(cap, np.int32)
    nn = lib.bvh_build(
        t,
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        leaf_size,
        nodes_min, nodes_max, skip, first, count, order, parent,
    )
    if nn < 0:
        raise RuntimeError(f"native BVH build failed (code {nn})")
    return BVH(
        nodes_min=nodes_min[:nn].copy(),
        nodes_max=nodes_max[:nn].copy(),
        nodes_skip=skip[:nn].copy(),
        nodes_first=first[:nn].copy(),
        nodes_count=count[:nn].copy(),
        tri_order=order,
        parent=parent[:nn].copy(),
    )
