"""ctypes binding for the native SR4000 frame decoder.

Port of ``pre3_tpu/data/native_loader.py``, with the same API
(``native_available``, ``read_frame_native``, ``read_sequence_native``)
and the same ctypes signatures. The C++ decoder
(``native/sr4000_loader.cc``) parses and preprocesses frames with a
thread pool so host IO overlaps device compute.

One change: the library is always built here, by ``g++``, from
``native/sr4000_loader.cc`` into ``build/native/`` at the repo root, under
a name that carries a hash of the source, the flags and the machine, so a
stale build is never loaded. A prebuilt ``native/build/libsr4000.so`` is
never opened: it may have been built with ``-march=native`` on another
CPU, and an illegal instruction would kill the process instead of raising.
The flags are portable (no ``-march=native``) and keep the compiler from
fusing multiply-adds, so the 3×3 smoothing rounds as the numpy parser
does. Without a compiler the numpy parser (``data/sr4000.py``) decodes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from pre3_tpu_torch.data.sr4000 import H, W, Frame, read_frame

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "sr4000_loader.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off",
             "-shared")
LD_FLAGS = ("-lpthread",)


def library_path() -> Path:
    """Where the build of ``native/sr4000_loader.cc`` lives, keyed by the
    source, the flags and the machine."""
    key = SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LD_FLAGS + (platform.machine(),)).encode()
    return BUILD_DIR / f"libsr4000_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the decoder unless its build exists; return the library's
    path. Raises RuntimeError when no C++ compiler works."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) to build the "
                           "native SR4000 decoder")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native SR4000 decoder failed (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def _load_lib():
    """Build (if needed) and load the native library; None on failure."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.sr4000_decode.restype = ctypes.c_int
    lib.sr4000_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.sr4000_decode_batch.restype = ctypes.c_int
    lib.sr4000_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def loaded_library() -> Path | None:
    """The path of the library this process loaded, or None."""
    lib = _load_lib()
    return None if lib is None else Path(lib._name)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_frame_native(path: str, smooth: bool = True) -> Frame:
    """Decode one frame via the native library (numpy fallback if absent)."""
    lib = _load_lib()
    if lib is None:
        return read_frame(path, smooth=smooth)
    intensity = np.empty((H, W), np.float32)
    xyz = np.empty((H, W, 3), np.float32)
    conf = np.empty((H, W), np.float32)
    ts = ctypes.c_double()
    rc = lib.sr4000_decode(
        path.encode(), _fptr(intensity), _fptr(xyz), _fptr(conf),
        ctypes.byref(ts), int(smooth),
    )
    if rc != 0:
        raise IOError(f"sr4000_decode({path}) failed with code {rc}")
    return Frame(
        intensity=intensity, xyz=xyz, confidence=conf, timestamp=ts.value
    )


def read_sequence_native(
    paths: list[str], smooth: bool = True, threads: int = 0
) -> list[Frame]:
    """Decode a frame batch with the native thread pool."""
    lib = _load_lib()
    if lib is None:
        return [read_frame(p, smooth=smooth) for p in paths]
    n = len(paths)
    intensity = np.empty((n, H, W), np.float32)
    xyz = np.empty((n, H, W, 3), np.float32)
    conf = np.empty((n, H, W), np.float32)
    ts = np.empty((n,), np.float64)
    status = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.sr4000_decode_batch(
        c_paths, n, _fptr(intensity), _fptr(xyz), _fptr(conf),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(smooth), threads,
    )
    bad = np.nonzero(status != 0)[0]
    if len(bad):
        raise IOError(
            f"sr4000_decode_batch: {len(bad)} frames failed, first: "
            f"{paths[bad[0]]} rc={status[bad[0]]}"
        )
    return [
        Frame(intensity=intensity[i], xyz=xyz[i], confidence=conf[i],
              timestamp=float(ts[i]))
        for i in range(n)
    ]
