"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own library with
a plain C interface, under ``build/kernels/<name>-<hash>/`` at the root of
the checkout (a directory git ignores). The hash covers the source and the
flags, so an edit rebuilds and an unchanged source is loaded as built. All
sources that need a build are compiled together, one ``nvcc`` each. The
build uses only the sources in the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCES = {"ell_kernels": _PKG / "csrc" / "ell_kernels.cu",
           "ell_max_kernels": _PKG / "csrc" / "ell_max_kernels.cu",
           "ell_edge_kernels": _PKG / "csrc" / "ell_edge_kernels.cu",
           "ell_general_kernels": _PKG / "csrc" / "ell_general_kernels.cu",
           "lab_kernels": _PKG / "csrc" / "lab_kernels.cu"}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Flags of one source on top of NVCC_FLAGS. The max kernels test products
# for equality across kernels, so nvcc may fuse no multiply-add of its own
# around them (the activations feeding the tensor-core products).
EXTRA_FLAGS = {"ell_max_kernels": ["--fmad=false"]}

_LIBS: dict = {}
_LOGS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _flags(name: str) -> list:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all ``nvcc`` runs
    started together. Returns {name: compiler log} for what was built.
    Raises with the compiler's output if a build fails."""
    pending = {}
    for name in SOURCES:
        lib = _target(name)
        if not lib.exists():
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
                   str(SOURCES[name])]
            pending[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
    # wait for every nvcc before raising, so that none is left running
    outs = {name: proc.communicate()[0]
            for name, (proc, _, _) in pending.items()}
    failed = [n for n, (proc, _, _) in pending.items() if proc.returncode]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed for {SOURCES[n]}:\n{outs[n]}" for n in failed))
    for name, (_, tmp, lib) in pending.items():
        # atomic: a concurrent builder sees all of the library or nothing
        os.replace(tmp, lib)
        (lib.parent / "build.log").write_text(outs[name])
        _LOGS[name] = outs[name]
    return outs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` registers, shared memory and
    spills) of the library as built, or '' if it was built elsewhere."""
    if name in _LOGS:
        return _LOGS[name]
    log = _target(name).parent / "build.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib
