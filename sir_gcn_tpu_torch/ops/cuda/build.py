"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own library with
a plain C interface, under ``build/kernels/<name>-<hash>/`` at the root of
the checkout (a directory git ignores). The hash covers the source and the
flags, so an edit rebuilds and an unchanged source is loaded as built. All
sources that need a build are compiled together, one ``nvcc`` each, but a
source of ``PARTS`` in parts, one ``nvcc -c`` a part, linked into its
library when they are done. The build uses only the sources in the
checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# around them (the activations feeding the tensor-core products). The
# general source holds some 640 kernels and the max source some 140 large
# ones: their optimizer runs on as many threads as the host has (split
# compilation), so neither build is the one all the others wait for.
EXTRA_FLAGS = {"ell_max_kernels": ["--fmad=false", "--split-compile=0"],
               "ell_general_kernels": ["--split-compile=0"]}
# Sources compiled in parts: (the macro a part is selected by, the number
# of parts). The general source's 700 kernels in one nvcc took 190-400 s,
# most of it on one core (on one 8-core H100 host 318.9 s whole, 85.6 s in
# five parts: `_main`); each part keeps the C entries of its number.
PARTS = {"ell_general_kernels": ("SIR_GENERAL_PART", 5)}

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
    h.update(repr(PARTS.get(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _commands(name: str, tmp: Path, src: Path = None,
              whole: bool = False) -> tuple:
    """(the nvcc commands that compile source ``name``, all run at once;
    the link command after them, or None) for a library written to
    ``tmp``: from ``src`` if given, else the checkout's file, in the parts
    ``PARTS`` gives it unless ``whole``."""
    src = str(src or SOURCES[name])
    if whole or name not in PARTS:
        return [[_nvcc(), *_flags(name), "-o", str(tmp), src]], None
    macro, n = PARTS[name]
    flags = [f for f in _flags(name) if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.part{k}.o") for k in range(n)]
    compiles = [[_nvcc(), *flags, "-c", f"-D{macro}={k}", "-o", str(obj),
                 src] for k, obj in enumerate(objs)]
    link = [_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
            *map(str, objs)]
    return compiles, link


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
            compiles, link = _commands(name, tmp)
            procs = [subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for cmd in compiles]
            pending[name] = (procs, link, tmp, lib)
    # wait for every nvcc before raising, so that none is left running
    outs = {name: "".join(proc.communicate()[0] for proc in procs)
            for name, (procs, _, _, _) in pending.items()}
    failed = {n for n, (procs, _, _, _) in pending.items()
              if any(proc.returncode for proc in procs)}
    for name, (procs, link, _, _) in pending.items():
        if link is not None and name not in failed:
            done = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            outs[name] += done.stdout
            if done.returncode:
                failed.add(name)
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed for {SOURCES[n]}:\n{outs[n]}"
            for n in sorted(failed)))
    for name, (_, _, tmp, lib) in pending.items():
        for obj in tmp.parent.glob(f"{tmp.name}.part*.o"):
            obj.unlink()  # a parted source's objects, linked
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


def ptxas_entries(log: str) -> list:
    """(entry function, registers, spill-store bytes) of each kernel in a
    build's compiler output (``-Xptxas -v``), in the order ptxas reports
    them."""
    entries, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            entries.append((fn, int(m.group(1)), spill))
            fn = None
    return entries


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def _main(argv=None) -> None:
    """Time one source's build into a fresh directory: ``python -m
    sir_gcn_tpu_torch.ops.cuda.build NAME [SOURCE] [--whole]`` compiles
    SOURCE (by default the checkout's file of NAME) with NAME's flags, in
    its ``PARTS`` unless ``--whole``, and prints the seconds to the
    library. Nothing else should build meanwhile."""
    import argparse
    import shutil
    import tempfile
    import time

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("name", choices=sorted(SOURCES))
    ap.add_argument("source", nargs="?", type=Path)
    ap.add_argument("--whole", action="store_true")
    args = ap.parse_args(argv)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix="timed-", dir=BUILD_DIR))
    compiles, link = _commands(args.name, out / f"lib{args.name}.so",
                               args.source, args.whole)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [proc.communicate()[0] for proc in procs]
    if link is not None and not any(p.returncode for p in procs):
        logs.append(subprocess.run(link, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT,
                                   text=True).stdout)
    seconds = time.perf_counter() - t0
    built = (out / f"lib{args.name}.so").exists()
    shutil.rmtree(out)
    if not built:
        raise SystemExit("nvcc failed:\n" + "".join(logs))
    how = "whole" if len(compiles) == 1 else f"in {len(compiles)} parts"
    print(f"built {args.source or SOURCES[args.name]} {how} in "
          f"{seconds:.1f} s, {len(ptxas_entries(''.join(logs)))} kernels",
          flush=True)


if __name__ == "__main__":
    _main()
