"""ctypes loader of the native ELL planner (port of
``sir_gcn_tpu/native/__init__.py``; the C++ source is its own copy,
``csrc/ellplan.cpp``).

``g++ -O3 -shared`` builds ``csrc/ellplan.cpp`` at first use into
``build/native/<hash>/libellplan.so`` at the root of the checkout (a
directory git ignores), keyed by a hash of the source, so an edit rebuilds.
The build writes a temporary file and renames it into place, so processes
that build at once do not read a half-written library. ``ops/ell.py``
``_bucketize`` runs the library's two passes; where it cannot be built (no
``g++``) the planner stays on NumPy, whose plans are the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "ellplan.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_LIB: dict = {}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / digest / "libellplan.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        str(SOURCE), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_ellplan() -> ctypes.CDLL:
    """The planner library with typed entries, built at first use; raises
    (``FileNotFoundError`` without ``g++``, ``CalledProcessError`` on a
    failed build) where it cannot be built."""
    if "lib" not in _LIB:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.ell_chunks.restype = ctypes.c_int64
        lib.ell_chunks.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                   _I64P, _I64P, _I64P]
        lib.ell_fill_slots.restype = None
        lib.ell_fill_slots.argtypes = [_I64P] * 7 + [ctypes.c_int64, _I64P,
                                                     _F32P, _I64P]
        _LIB["lib"] = lib
    return _LIB["lib"]


def available() -> bool:
    """Whether the library loads (building it if needed); a failed build
    is not tried again in this process."""
    if "available" not in _LIB:
        try:
            load_ellplan()
            _LIB["available"] = True
        except (OSError, subprocess.CalledProcessError):
            _LIB["available"] = False
    return _LIB["available"]


def _i64(a: np.ndarray) -> np.ndarray:
    if a.dtype != np.int64 or not a.flags.c_contiguous:
        raise TypeError("the planner takes C-contiguous int64 arrays")
    return a


def ell_chunks(gkeys: np.ndarray, max_budget: int):
    """Phase A: runs of equal key in the sorted ``gkeys`` [m] cut into
    chunks of at most ``max_budget``: (chunk_key, chunk_cnt, chunk_start),
    each [n_chunks] int64."""
    lib = load_ellplan()
    gkeys = _i64(gkeys)
    m = gkeys.shape[0]
    outs = [np.empty(m, np.int64) for _ in range(3)]
    n = int(lib.ell_chunks(gkeys.ctypes.data_as(_I64P), m, max_budget,
                           *(o.ctypes.data_as(_I64P) for o in outs)))
    return tuple(o[:n] for o in outs)


def ell_fill_slots(gids, chunk_key, chunk_cnt, chunk_start, budgets, order,
                   slot_base, total: int):
    """Phase B: the slot arrays (slot_item int64, slot_valid f32, slot_key
    int64, each [total]) of the chunks laid out in ``order`` from
    ``slot_base``, each padded to its budget."""
    lib = load_ellplan()
    ins = [_i64(a) for a in (gids, chunk_key, chunk_cnt, chunk_start,
                             budgets, order, slot_base)]
    n = order.shape[0]
    if any(a.shape[0] != n for a in ins[1:]):
        raise ValueError("chunk arrays of unequal length")
    if n and ((chunk_cnt > budgets).any()
              or (chunk_start + chunk_cnt).max() > gids.shape[0]
              or slot_base[-1] + budgets[order[-1]] != total):
        raise ValueError("chunks overrun their budgets, the items or the "
                         "slots")
    slot_item = np.empty(total, np.int64)
    slot_valid = np.empty(total, np.float32)
    slot_key = np.empty(total, np.int64)
    lib.ell_fill_slots(*(a.ctypes.data_as(_I64P) for a in ins), n,
                       slot_item.ctypes.data_as(_I64P),
                       slot_valid.ctypes.data_as(_F32P),
                       slot_key.ctypes.data_as(_I64P))
    return slot_item, slot_valid, slot_key
