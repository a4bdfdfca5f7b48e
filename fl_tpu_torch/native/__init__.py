"""First-party native (C++) runtime components, bound via ctypes (port of
``fl_tpu.native``).

The LZ4-block codec (``fl_codec.cpp``, a byte-identical copy of the
reference's source) serves the compression service's ``lz4`` algorithm.
It is built with ``g++ -O3 -shared -fPIC`` at first use, never at import,
into ``fl_tpu_torch/_build/flcodec-<hash>/`` (listed in ``.gitignore``),
where the hash covers the source and the flags. Without a toolchain the
codec is unavailable and the service falls back to zlib
(``fl_tpu_torch.fl.compression`` records which backend wrote a payload).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "fl_codec.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

MAGIC = b"FLZ4"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _HERE.parent / "_build" / f"flcodec-{h.hexdigest()[:16]}" \
        / "libflcodec.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    # build under a name of this process's own, then rename: processes
    # that build at once never load a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native codec build failed (%s); zlib fallback in use",
                       e)
        return False
    os.replace(tmp, lib)
    return True


def load_codec() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native codec load failed: %s", e)
            _build_failed = True
            return None
        lib.fl_lz4_bound.restype = ctypes.c_int
        lib.fl_lz4_bound.argtypes = [ctypes.c_int]
        lib.fl_lz4_compress.restype = ctypes.c_int
        lib.fl_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.fl_lz4_decompress.restype = ctypes.c_int
        lib.fl_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load_codec() is not None


def lz4_compress(data: bytes) -> bytes:
    """Compress to [MAGIC][u32 original size][lz4 block]."""
    lib = load_codec()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    bound = lib.fl_lz4_bound(len(data))
    out = (ctypes.c_uint8 * bound)()
    n = lib.fl_lz4_compress(data, len(data), out, bound)
    if n < 0:
        raise RuntimeError("lz4 compression failed")
    return MAGIC + len(data).to_bytes(4, "little") + bytes(out[:n])


def lz4_decompress(blob: bytes) -> bytes:
    lib = load_codec()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    if blob[:4] != MAGIC:
        raise ValueError("not an fl_tpu lz4 payload")
    orig = int.from_bytes(blob[4:8], "little")
    # the header is untrusted: LZ4's maximum ratio is ~255×, so a declared
    # size beyond that is malformed (and would otherwise be a memory-DoS)
    if orig > 255 * max(len(blob) - 8, 1) + 64:
        raise ValueError("declared decompressed size exceeds LZ4 bound")
    out = (ctypes.c_uint8 * orig)()
    n = lib.fl_lz4_decompress(blob[8:], len(blob) - 8, out, orig)
    if n != orig:
        raise ValueError(f"lz4 decompression failed ({n} != {orig})")
    return bytes(out)
