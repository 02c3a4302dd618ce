"""Build and load the port's hand-written CUDA kernels.

Every ``icebin_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into ONE shared library with a plain C interface, which
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

__all__ = ["library", "build", "build_log", "check", "digest", "install"]

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "icebin_tpu_torch"
LIB_NAME = "libicebin_tpu_torch.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
#: C signature of every entry point: (argtypes, restype)
_SIGNATURES = {
    "spmm_dest_small": ((_P,) * 6 + (_I,) * 3 + (_P,) + (_I,) * 3 + (_P,),
                        _I),
    "spmm_dest_small_f64": ((_P,) * 6 + (_I,) * 3 + (_P,) + (_I,) * 3
                            + (_P,), _I),
    "spmm_dest_ice": ((_P,) * 6 + (_I,) * 7 + (_P,), _I),
    "spmm_dest_small_rebind": ((_P,) * 3 + (_I, _PI, _I, _PP, _I, _PI),
                               _I),
    "clip_rect": ((_P,) * 4 + (_I,) * 2 + (_P,), _I),
    "clip_poly": ((_P,) * 4 + (_I,) * 3 + (_P,), _I),
    "clip_rect_compact": ((_P,) * 4 + (_I,) * 2 + (_P,), _I),
    "clip_poly_compact": ((_P,) * 4 + (_I,) * 3 + (_P,), _I),
    "clip_stream_at": ((_P,) * 4 + (_I,) * 6 + (_P,), _I),
    "stream_reduce": ((_P,) * 4 + (_I,) * 3 + (_P,), _I),
    "spmm_floor_small": ((_P,) * 6 + (_I,) * 2 + (_P,), _I),
    "spmm_floor_ice": ((_P,) * 6 + (_I,) * 2 + (_P,), _I),
    "tile_prods": ((_P,) * 3 + (_I,) + (_P,), _I),
    "spmm_small_slots": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_small_group": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_small_batch": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_small_ablate": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_ice_slots": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_ice_batch": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_ice_ablate": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_ice_stage": ((_P,) * 6 + (_I,) * 3 + (_P,), _I),
    "spmm_ice_store": ((_P,) * 6 + (_I,) * 4 + (_P,), _I),
    "fold_tiles": ((_P, _P) + (_I,) * 4 + (_P,), _I),
    "smem_copy_block": ((_P, _P, _I, _P), _I),
    "smem_copy_cluster": ((_P, _P, _I, _I, _PI, _P), _I),
    "segment_sum": ((_P, _P, _P, _I, _P), _I),
    "books_struct_size": ((), _I),
    "books_reduce": ((_P, _I, _P), _I),
    "books_stats": ((_P,) * 5 + (ctypes.c_double,) * 4 + (_P,), _I),
    "icebin_cuda_error_string": ((_I,), ctypes.c_char_p),
    "icebin_cuda_error_name": ((_I,), ctypes.c_char_p),
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


def digest(*parts: bytes) -> str:
    """Short hash of ``parts``: the name of a build's cache directory."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()[:16]


def install(out_dir: Path, lib_name: str, make) -> Path:
    """``out_dir / lib_name``, built by ``make(tmp, log)`` unless it exists.
    ``make`` writes the library to ``tmp``, appends the compilers' output to
    the list ``log`` (saved as ``build.log``, also on failure) and raises if
    a compile fails; the library is then moved into place atomically, so
    concurrent builders agree."""
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib_name}.{os.getpid()}.tmp"
    log = []
    try:
        make(tmp, log)
        os.replace(tmp, lib)
    finally:
        (out_dir / "build.log").write_text("".join(log))
        tmp.unlink(missing_ok=True)
    return lib


def _build_dir() -> Path:
    return BUILD_ROOT / digest(" ".join(NVCC_FLAGS).encode(), *(
        b for src in _sources() for b in (src.name.encode(),
                                          src.read_bytes())))


def _compile(tmp: Path, log: list) -> None:
    nvcc, pid = _nvcc(), os.getpid()
    objs = [tmp.parent / f"{src.stem}.{pid}.o" for src in _sources()]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objs, _sources())]
    link = [nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]

    def run(cmds):
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        try:
            outs = [p.communicate()[0] for p in procs]
        finally:
            for p in procs:            # leave no compiler running
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log.extend(" ".join(c) + "\n" + out for c, out in zip(cmds, outs))
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{out[-6000:]}")

    try:
        run(jobs)                  # one nvcc per source, in parallel
        run([link])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def build() -> Path:
    """Compile the kernels if this source set has no library yet; returns
    the library's path.  A failed compile raises with nvcc's output."""
    return install(_build_dir(), LIB_NAME, _compile)


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
