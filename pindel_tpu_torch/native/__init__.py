"""Native (C++) components, compiled on demand with g++ and loaded via
ctypes.  The sources live here; the shared objects are built into
``pindel_tpu_torch/build/native/`` (not tracked) at first use and rebuilt
whenever a source file is newer.  A failed build raises."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build", "native")
_LOCK = threading.Lock()
_LIBS = {}


def _build(name: str, sources, link=("-lz",), cflags=()) -> str:
    so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    srcs = [os.path.join(_DIR, s) for s in sources]
    if (not os.path.exists(so_path)
            or any(os.path.getmtime(s) > os.path.getmtime(so_path)
                   for s in srcs)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a per-process temporary name: test workers may build at once
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *cflags,
               *srcs, "-o", tmp, *link]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so_path)
    return so_path


def load(name: str, sources, link=("-lz",), cflags=()) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name, sources, link, cflags))
        return _LIBS[name]
