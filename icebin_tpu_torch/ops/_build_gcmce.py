"""Build the port's gcmce_* C ABI library (``icebin_tpu_torch/native/
gcmce.cc``), the Fortran-GCM-facing coupler boundary.

The source embeds CPython, so it is compiled by ``g++`` (no nvcc) with the
flags ``python3-config --includes --ldflags --embed`` prints, the build
recipe of the reference's ``native/build_gcmce.sh``.  It builds at first
use into ``build/icebin_tpu_torch/gcmce-<hash>/libicebin_gcmce.so`` at the
repository root, keyed by a hash of the source, the compiler command and
the interpreter; a later process loads the cached library.  A failed build
raises with the compiler's output: there is nothing to fall back to.

A GCM links the library (``-L<dir> -licebin_gcmce``) and runs with the
checkout on ``PYTHONPATH``; a Python process loads it with ``ctypes``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

from icebin_tpu_torch.ops._build import BUILD_ROOT, digest, install

__all__ = ["gcmce_library"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gcmce.cc"
LIB_NAME = "libicebin_gcmce.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def _python_config() -> str:
    """The ``python3-config`` of this interpreter: beside it, else the
    versioned or plain one on PATH."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    here = Path(sys.executable).parent
    for cand in (here / f"python{ver}-config", here / "python3-config",
                 shutil.which(f"python{ver}-config"),
                 shutil.which("python3-config")):
        if cand and os.path.isfile(cand):
            return str(cand)
    raise RuntimeError("gcmce C ABI build: no python3-config for Python "
                       f"{ver} (beside {sys.executable} or on PATH)")


def _command():
    """The compiler command, without its output path."""
    cfg = _python_config()
    flags = [subprocess.run([cfg, *args], capture_output=True, text=True,
                            check=True).stdout.split()
             for args in (["--includes"], ["--ldflags", "--embed"])]
    return [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE),
            *flags[0], *flags[1]]


def gcmce_library() -> Path:
    """Path of the built ``libicebin_gcmce.so`` (built on first use); raises
    ``RuntimeError`` with the compiler's output if it cannot be built."""
    base = _command()

    def make(tmp: Path, log: list) -> None:
        cmd = base + ["-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"gcmce C ABI build failed: {' '.join(cmd)}: "
                               f"{e}") from e
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0 or not tmp.exists():
            raise RuntimeError(f"gcmce C ABI build failed ({res.returncode}):"
                               f"\n{log[-1][-6000:]}")

    key = digest(" ".join(base).encode(), sys.executable.encode(),
                 SOURCE.read_bytes())
    return install(BUILD_ROOT / f"gcmce-{key}", LIB_NAME, make)
