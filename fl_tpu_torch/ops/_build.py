"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``fl_tpu_torch/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source and all started together, and
the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``; the driver's tensor-map encoder is looked up with
``dlopen`` at run time, so nothing links against the driver. The build
happens at first use, never at import, into ``fl_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), where the
hash covers the sources and the flags: a fresh checkout builds once, a
re-run reuses the library, and an edited source builds anew. nvcc's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) of
every source is kept beside the library as ``build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libfl_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / _digest() / LIB_NAME


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where the "
            "CUDA toolkit is installed (set CUDA_HOME or put nvcc on PATH)")
    return found


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects = [out.parent / f"{src.stem}.{os.getpid()}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = []
    for cmd, proc in zip(cmds, procs):
        so, se = proc.communicate()
        results.append((cmd, proc.returncode, so, se))
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    if all(rc == 0 for _, rc, _, _ in results):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects), "-ldl"]
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.returncode, proc.stdout, proc.stderr))
    for obj in objects:
        obj.unlink(missing_ok=True)
    (out.parent / "build.log").write_text("".join(
        " ".join(cmd) + "\n" + so + se for cmd, _, so, se in results))
    for cmd, rc, _, se in results:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed (exit {rc}) on {cmd[-1]}:\n{se[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed, with every C entry
    point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.fl_conv_block_fwd.argtypes = [i] + [p] * 7 + [i] * 8 + [p]
            lib.fl_conv_block_fwd.restype = i
            lib.fl_conv_block_bwd.argtypes = [i] + [p] * 8 + [i] * 8 + [p]
            lib.fl_conv_block_bwd.restype = i
            lib.fl_conv_stack_fwd.argtypes = [i] + [p] * 6 + [i] * 8 + [p]
            lib.fl_conv_stack_fwd.restype = i
            lib.fl_conv_stack_bwd.argtypes = [i] + [p] * 8 + [i] * 8 + [p]
            lib.fl_conv_stack_bwd.restype = i
            lib.fl_conv_block_smem_bytes.argtypes = [i] * 6
            lib.fl_conv_block_smem_bytes.restype = ctypes.c_size_t
            lib.fl_patch_gemm.argtypes = [i] + [p] * 3 + [i] * 10 + [p]
            lib.fl_patch_gemm.restype = i
            lib.fl_patch_wgrad.argtypes = [i] + [p] * 4 + [i] * 10 + [p]
            lib.fl_patch_wgrad.restype = i
            lib.fl_conv_patch_smem_bytes.argtypes = [i] * 8
            lib.fl_conv_patch_smem_bytes.restype = ctypes.c_size_t
            lib.fl_batched_gemm.argtypes = [i, i] + [p] * 3 + [i] * 8 + [p]
            lib.fl_batched_gemm.restype = i
            lib.fl_batched_gemm_smem_bytes.argtypes = [i] * 5
            lib.fl_batched_gemm_smem_bytes.restype = ctypes.c_size_t
            lib.fl_taploop_conv.argtypes = [i, i] + [p] * 3 + [i] * 12 + [p]
            lib.fl_taploop_conv.restype = i
            lib.fl_taploop_smem_bytes.argtypes = [i] * 8
            lib.fl_taploop_smem_bytes.restype = ctypes.c_size_t
            lib.fl_cuda_error_string.argtypes = [i]
            lib.fl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.fl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
