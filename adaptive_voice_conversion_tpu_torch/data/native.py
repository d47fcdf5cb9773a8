"""ctypes binding for the native segment gather (native/segment_gather.cpp).

A training batch is B segments, each a contiguous range of rows of the
packed mel array, so the gather is B ``memcpy`` calls split over threads
(the C source falls back to one thread below ``4 * n_threads`` segments).

The library is compiled with ``g++`` on first use into ``build/native/`` at
the root of the checkout (a directory ``.gitignore`` lists; ``native/`` is
never written). Its file name carries a hash of the source and the flags, and
it is written under a temporary name and then renamed, so concurrent
processes never load half a file and an edited source is rebuilt. With
``-march=native`` a library fits the CPU it was built for, so the file name
also carries the building host's name and architecture: a checkout copied
to another machine builds its own. A failed
build raises with the compiler's output: there is no silent fallback to the
numpy gather (``SegmentDataset.gather_plain`` is that gather, kept as the
reference the tests hold this one against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "segment_gather.cpp"
BUILD_DIR = REPO / "build" / "native"
# native/build.sh's flags
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path() -> Path:
    key = " ".join((*CXX_FLAGS, platform.node(), platform.machine())).encode()
    digest = hashlib.sha256(SOURCE.read_bytes() + key).hexdigest()[:16]
    return BUILD_DIR / f"libsegment_gather-{digest}.so"


def build() -> Path:
    """Compile the gather unless a current build exists; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError(f"the native segment gather needs g++: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.gather_segments.argtypes = [
        ctypes.c_void_p,  # packed
        ctypes.c_int64,  # row_bytes
        ctypes.POINTER(ctypes.c_int64),  # starts
        ctypes.c_int64,  # n
        ctypes.c_int64,  # seg_rows
        ctypes.c_void_p,  # out
        ctypes.c_int,  # n_threads
    ]
    lib.gather_segments.restype = None
    return lib


def gather_segments(
    packed: np.ndarray, starts: np.ndarray, seg_rows: int, n_threads: int = 2
) -> np.ndarray:
    """``packed[s : s + seg_rows]`` for every ``s`` in ``starts``, stacked:
    (len(starts), seg_rows, n_cols) in ``packed``'s dtype."""
    if packed.ndim != 2 or not packed.flags["C_CONTIGUOUS"]:
        raise ValueError("packed must be a C-contiguous 2-D array")
    s = np.ascontiguousarray(starts, dtype=np.int64)
    if s.size and (s.min() < 0 or s.max() + seg_rows > packed.shape[0]):
        raise IndexError(
            f"segment starts [{s.min()}, {s.max()}] + {seg_rows} rows fall outside "
            f"the {packed.shape[0]} packed rows"
        )
    lib = load_library()
    out = np.empty((len(s), seg_rows, packed.shape[1]), dtype=packed.dtype)
    lib.gather_segments(
        packed.ctypes.data,
        packed.strides[0],
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(s),
        seg_rows,
        out.ctypes.data,
        n_threads,
    )
    return out
