"""Build and load the port's hand-written CUDA kernels.

Every ``icebin_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface, which
is loaded through ``ctypes``.  No PyTorch header is included, so the build
takes seconds.  It runs at first use, into ``build/icebin_tpu_torch/<hash>``
at the repository root, keyed by a hash of the sources and flags; a later
process with the same sources loads the cached library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero status into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "build", "build_log", "check"]

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "icebin_tpu_torch"
LIB_NAME = "libicebin_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of every entry point: (argtypes, restype)
_SIGNATURES = {
    "spmm_dest_small": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_dest_ice": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "clip_rect": ((_P,) * 4 + (_I,) * 2 + (_P,), _I),
    "icebin_cuda_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "CUDA kernels of icebin_tpu_torch cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source set has no library yet; returns
    the library's path.  A failed compile raises with nvcc's output."""
    out_dir = _build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-6000:]}")
    os.replace(tmp, lib)           # atomic: concurrent builders agree
    return lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) of the build the
    current sources map to, or '' if it was not built by this checkout."""
    log = _build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a non-zero CUDA status."""
    if status != 0:
        msg = library().icebin_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
