"""Host<->device transfer, the build of the hand-written CUDA kernels
under csrc/, and the host-side page codec (reference:
presto_tpu/native/__init__.py).

`load_pageserde` builds `pageserde.cpp` (the wire's block codec and
checksum, a copy of the reference's source so both packages frame a
page identically) with the system `g++` into `_build/` and loads it
with `ctypes`. The build goes to a private temporary file that is then
renamed into place, so worker processes starting together cannot
corrupt it. Without a compiler the codec falls back to zlib frames,
which every node decodes."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"

_lock = threading.Lock()
_pageserde: Optional[ctypes.CDLL] = None
_pageserde_tried = False


def _build(source: Path, tag: str) -> Optional[Path]:
    """Compile `source` into `_build/<tag>-<hash>.so` (cached by
    content); None when no compiler is available or the build fails."""
    tmp = None
    try:
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"{tag}-{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
             str(source)], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
        tmp = None
        return out
    except Exception:  # noqa: BLE001 — no compiler: the zlib fallback
        return None
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_pageserde() -> Optional[ctypes.CDLL]:
    """The page codec library, or None when it cannot be built (the
    codec then writes zlib frames)."""
    global _pageserde, _pageserde_tried
    with _lock:
        if _pageserde_tried:
            return _pageserde
        _pageserde_tried = True
        path = _build(_HERE / "pageserde.cpp", "pageserde")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pt_compress.restype = ctypes.c_int64
        lib.pt_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                    ctypes.c_int64]
        lib.pt_decompress.restype = ctypes.c_int64
        lib.pt_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                      ctypes.c_int64]
        lib.pt_checksum.restype = ctypes.c_uint64
        lib.pt_checksum.argtypes = [u8p, ctypes.c_int64]
        lib.pt_compress_bound.restype = ctypes.c_int64
        lib.pt_compress_bound.argtypes = [ctypes.c_int64]
        _pageserde = lib
        return lib
