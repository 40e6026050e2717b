"""Wrappers of the ELL CUDA kernels (``csrc/ell_kernels.cu`` for the
linear aggregations and their edge-term forms, ``csrc/ell_edge_kernels.cu``
for the fused edge projection, ``csrc/ell_max_kernels.cu`` for max,
``csrc/ell_general_kernels.cu`` for the general sigma route and the full
vector-Jacobian backwards) and their plain PyTorch versions (port of
``sir_gcn_tpu/ops/pallas/kernels.py``).

A wrapper takes the node tables and one plan's slot arrays, checks them,
and on CUDA tensors launches its kernel on the current stream; on CPU
tensors it runs the plain version, which the tests hold against the JAX
package's Pallas kernels. A CUDA tensor never takes the plain version: a
failed build or launch raises. Each wrapper counts its launches in
``LAUNCHES``.

Shared arguments (S slots, R rows of one plan, N nodes, width H):
  slot_node [S] int32  the node each slot gathers (dst_slot_srcnode for the
                       forward, src_slot_dstnode for the backward)
  scale     [S] f32    the slot's static scale (0 on padding slots)
  row_key   [R] int32  the node of each row
  row_ptr   [R+1] int32  row r owns slots row_ptr[r]:row_ptr[r+1]
  act       an ``ops.ell.Activation`` from the registry
  slot_edge [S] int32  the sorted-edge id of each slot (the plan's
                       ``slot_edge``), for the edge terms
The index arrays come from a plan built by ``ops/ell.py`` and are trusted
to lie in range; checking them would cost a device sync.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

LAUNCHES = {"ell_act_reduce": 0, "ell_act_reduce2": 0, "ell_src_bwd": 0,
            "ell_act_reduce_edge": 0, "ell_act_reduce2_edge": 0,
            "ell_src_bwd_edge": 0, "ell_edge_act_reduce2": 0,
            "ell_edge_src_bwd": 0, "ell_max_fwd": 0, "ell_max_wincount": 0,
            "ell_max_bwd": 0, "ell_scaled_reduce": 0,
            "ell_max_fwd_edge": 0, "ell_max_wincount_edge": 0,
            "ell_max_bwd_edge": 0,
            "ell_act_reduce_rowwise": 0, "ell_geq_reduce": 0,
            "ell_src_bwd_rowwise": 0, "ell_src_bwd_fused": 0,
            "ell_act_reduce_bwd": 0, "ell_act_reduce_rowwise_edge": 0,
            "ell_geq_reduce_edge": 0, "ell_src_bwd_rowwise_edge": 0,
            # the timing lab's kernels (ops/cuda/lab.py)
            "lab_v1": 0, "lab_v2": 0, "lab_v3": 0, "lab_v4": 0, "lab_v5": 0,
            "lab_v6": 0, "lab_copy": 0, "lab_copy32": 0, "lab_pass": 0,
            "lab_pass2": 0, "lab_gather": 0, "lab_tile_sum": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# library -> entry -> argument types (the stream last)
_ARGTYPES = {
    "ell_kernels": {
        "ell_act_reduce": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
                           _VP, _VP],
        "ell_act_reduce2": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
                            _VP, _VP, _VP],
        "ell_src_bwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
                        _VP, _VP],
        "ell_act_reduce_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                _I, _I, _I, _F, _VP, _VP],
        "ell_act_reduce2_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                 _I, _I, _I, _F, _VP, _VP, _VP],
        "ell_src_bwd_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                             _I, _I, _I, _F, _VP, _VP, _VP],
    },
    "ell_edge_kernels": {
        "ell_edge_act_reduce2": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                                 _VP, _I, _I, _I, _I, _F, _VP, _VP, _VP],
        "ell_edge_src_bwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _VP, _I, _I, _I, _I, _F, _I, _VP, _VP, _VP,
                             _VP],
    },
    "ell_max_kernels": {
        "ell_max_fwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                        _F, _VP, _VP],
        "ell_max_wincount": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                             _I, _I, _I, _F, _VP, _VP],
        "ell_max_bwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                        _I, _I, _I, _F, _I, _VP, _VP, _VP, _VP, _VP],
        "ell_scaled_reduce": [_VP, _I, _VP, _VP, _VP, _I, _I, _VP, _VP],
        "ell_max_fwd_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                             _I, _I, _I, _I, _F, _VP, _VP],
        "ell_max_wincount_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                  _VP, _VP, _I, _I, _I, _I, _F, _VP, _VP],
        "ell_max_bwd_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                             _VP, _VP, _I, _I, _I, _I, _F, _I, _VP, _VP,
                             _VP, _VP, _VP],
    },
    "ell_general_kernels": {
        "ell_act_reduce_rowwise": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I,
                                   _I, _F, _VP, _VP],
        "ell_geq_reduce": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                           _F, _VP, _VP],
        "ell_act_reduce_bwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                               _I, _F, _I, _VP, _VP, _VP],
        "ell_src_bwd_rowwise": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                _I, _F, _VP, _VP],
        "ell_src_bwd_fused": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                              _F, _VP, _VP],
        "ell_act_reduce_rowwise_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP,
                                        _VP, _VP, _I, _I, _I, _F, _VP, _VP],
        "ell_geq_reduce_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                _VP, _I, _I, _I, _F, _VP, _VP],
        "ell_src_bwd_rowwise_edge": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                                     _VP, _VP, _I, _I, _I, _F, _VP, _VP,
                                     _VP],
    },
    "lab_kernels": {
        **{name: [_VP, _VP, _VP, _I, _I, _I, _I, _F, _VP, _VP]
           for name in ("lab_v1", "lab_v2", "lab_v4", "lab_v5", "lab_v6")},
        "lab_v3": [_VP, _VP, _VP, _I, _I, _I, _F, _VP, _VP],
        "lab_copy": [_VP, _I, _I, _I, _I, _VP, _VP],
        "lab_copy32": [_VP, _I, _I, _I, _I, _VP, _VP],
        "lab_pass": [_VP, _LL, _VP, _VP],
        "lab_pass2": [_VP, _LL, _I, _I, _VP, _VP],
        "lab_gather": [_VP, _VP, _I, _I, _I, _VP, _VP],
        "lab_tile_sum": [_VP, _I, _I, _I, _VP, _VP],
    },
}
# entries that launch nothing and return an int (a long long where
# _RESTYPE says so)
_QUERIES = {"ell_kernels": {"ell_layout": [_I] * 3 + [_VP] * 6},
            "ell_max_kernels": {"ell_max_bwd_blocks": [_I] * 6,
                                "ell_max_bwd_scratch": [_I] * 4,
                                "ell_max_layout": [_I] * 2},
            "ell_edge_kernels": {"ell_edge_src_bwd_blocks": [_I] * 5,
                                 "ell_edge_layout": [_I] * 4},
            "ell_general_kernels": {
                "ell_general_layout": [_I] * 4 + [_VP] * 5,
                "ell_general_edge_layout": [_I] * 4 + [_VP] * 6},
            "lab_kernels": {"lab_gather_warps": [_I] * 3}}
_RESTYPE = {"ell_edge_layout": _LL, "ell_max_bwd_scratch": _LL}
_ERROR_STRING = {"ell_kernels": "ell_error_string",
                 "ell_max_kernels": "ell_max_error_string",
                 "ell_edge_kernels": "ell_edge_error_string",
                 "ell_general_kernels": "ell_general_error_string",
                 "lab_kernels": "lab_error_string"}
_LIBRARY_OF = {entry: lib for lib, entries in _ARGTYPES.items()
               for entry in entries}
# the kernels that take any sigma of the registry, a row-wise one included,
# at any width
_GENERAL = tuple(_ARGTYPES["ell_general_kernels"])

_LIBS: dict = {}
# the g_W partials of ell_max_bwd per (device, R, H, O, act, bf16, edge) and
# the g_WE partials of ell_edge_src_bwd per (device, R, H, De, act, bf16):
# fixed for a model and its plan, so the occupancy query runs once
_BWD_BLOCKS: dict = {}
_EDGE_BWD_BLOCKS: dict = {}


def _library(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with typed entries, built at first
    use."""
    if name not in _LIBS:
        from .build import load

        lib = load(name)
        entries = {**_ARGTYPES[name], **_QUERIES.get(name, {})}
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _RESTYPE.get(entry, ctypes.c_int)
        err = getattr(lib, _ERROR_STRING[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _launch(name: str, device: torch.device, *args) -> None:
    lib_name = _LIBRARY_OF[name]
    lib = _library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = getattr(lib, _ERROR_STRING[lib_name])(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check(name: str, t: torch.Tensor, dtypes, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_F32 = (torch.float32,)
_EDGE = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


def _check_plan(slot_node, scale, row_key, row_ptr, device):
    _check("slot_node", slot_node, _I32, 1, device)
    _check("scale", scale, _F32, 1, device)
    _check("row_key", row_key, _I32, 1, device)
    _check("row_ptr", row_ptr, _I32, 1, device)
    if scale.shape != slot_node.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and slot_node "
                         f"{tuple(slot_node.shape)} differ")
    if row_ptr.shape[0] != row_key.shape[0] + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"{row_key.shape[0]} rows")


def _need_diagonal(name: str, act) -> None:
    """Raise for a sigma that couples a row's features: ``name`` computes
    sigma' elementwise."""
    if not act.diagonal:
        raise ValueError(f"{name} needs an elementwise sigma; {act.name} "
                         f"couples a row's features (the general route's "
                         f"kernels take it)")


def on_cuda(device: torch.device) -> bool:
    """Whether tensors on ``device`` take the kernels (CUDA) or the plain
    versions (CPU); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no ELL kernel for device {device}")


def _buckets(row_ptr: torch.Tensor) -> list:
    """(budget, num_rows) runs of equal row budget, from ``row_ptr``."""
    budgets = np.diff(row_ptr.cpu().numpy().astype(np.int64))
    if budgets.size == 0:
        return []
    cut = np.nonzero(np.diff(budgets))[0] + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [budgets.size]])
    return [(int(budgets[s]), int(e - s)) for s, e in zip(starts, ends)]


# csrc/ell_kernels.cu's kernels by family: the forward (#1, #2 and their
# edge-term forms), the backward (#4) and its edge-term form
_LAYOUT_FAMILY = {"ell_act_reduce": 0, "ell_act_reduce2": 0,
                  "ell_act_reduce_edge": 0, "ell_act_reduce2_edge": 0,
                  "ell_src_bwd": 1, "ell_src_bwd_edge": 2}


def ell_layout(name: str, h: int, dtype, *tensors):
    """The path a launch of ``name`` (a kernel of ``csrc/ell_kernels.cu``)
    takes for rows of width ``h`` in the gathered tables' ``dtype`` (f32 or
    bf16), given the CUDA tensors it reads and writes whole rows of (at
    most six: its node and edge tables and its outputs): (C, G, U) for the
    vector path, with C 16-byte chunks a row, G slots gathered at once by
    a warp's groups of C lanes and U gathers in flight a lane; None for the
    scalar path. The entry itself decides from the same H and pointers."""
    if len(tensors) > 6:
        raise ValueError(f"at most six tensors, got {len(tensors)}")
    ptrs = [_ptr(t) for t in tensors] + [None] * (6 - len(tensors))
    code = _library("ell_kernels").ell_layout(
        _LAYOUT_FAMILY[name], h, int(dtype == torch.bfloat16), *ptrs)
    if code == 0:
        return None
    return code >> 16, (code >> 8) & 0xFF, code & 0xFF


def bucket_offsets(buckets) -> list:
    """(budget, num_rows, slot_offset, row_offset) for each bucket."""
    offs, s, r = [], 0, 0
    for b, nr in buckets:
        offs.append((b, nr, s, r))
        s += b * nr
        r += nr
    return offs


# ----------------------------------------------------------------------
# #1 and #2: forward, with and without the derivative mass
# ----------------------------------------------------------------------

def add_cast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b added in f32 and carried in a's type (f32 or bf16), as the JAX
    route's ``add_cast`` (sir_gcn_tpu/ops/ell.py) rounds an edge term."""
    return (a.float() + b.float()).to(a.dtype)


def ell_act_reduce_plain(eq, ek, slot_src, scale, row_key, row_ptr, act,
                         buckets=None, derivative=False, e=None,
                         slot_edge=None):
    """Plain version of ``ell_act_reduce`` (and of ``ell_act_reduce2`` with
    ``derivative=True``, and of their edge-term forms with ``e`` and
    ``slot_edge``): gather, apply sigma, scale and reduce per bucket with
    ``reshape(nr, b, H).sum(1)``, as the Pallas kernels do. ek (plus the
    edge row, by ``add_cast``) is gathered in its own dtype and widened to
    f32 before the add. ``buckets`` defaults to the runs read from
    ``row_ptr``."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = eq.shape[1]
    ekg = ek.index_select(0, slot_src)
    if e is not None:
        ekg = add_cast(ekg, e.index_select(0, slot_edge))
    eq_rows = eq.index_select(0, row_key)
    rows, srows = [], []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (ekg[so:so + b * nr].float().reshape(nr, b, h)
             + eq_rows[ro:ro + nr, None, :])
        sc = scale[so:so + b * nr].reshape(nr, b, 1)
        rows.append((act(z) * sc).sum(1))
        if derivative:
            srows.append((act.grad(z) * sc).sum(1))
    rows = torch.cat(rows)
    return (rows, torch.cat(srows)) if derivative else rows


def _check_edge(e, slot_edge, width, dtype, slot_like, device):
    _check("e", e, (dtype,), 2, device)
    _check("slot_edge", slot_edge, _I32, 1, device)
    if e.shape[1] != width:
        raise ValueError(f"e {tuple(e.shape)} does not have width {width}")
    if slot_edge.shape != slot_like.shape:
        raise ValueError(f"slot_edge {tuple(slot_edge.shape)} and the slot "
                         f"array {tuple(slot_like.shape)} differ")


def _check_fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, act):
    """The checks of a dst-plan kernel's inputs: eq [N, H] f32, ek [N, H]
    f32 or bf16; a row-wise sigma for the general route's kernels only."""
    device = eq.device
    _check("eq", eq, _F32, 2, device)
    _check("ek", ek, _EDGE, 2, device)
    if ek.shape[1] != eq.shape[1]:
        raise ValueError(f"eq {tuple(eq.shape)} and ek {tuple(ek.shape)} "
                         f"differ in width")
    _check_plan(slot_src, scale, row_key, row_ptr, device)
    if name not in _GENERAL:
        _need_diagonal(name, act)
    return device


def _fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, act, derivative,
         e=None, slot_edge=None):
    device = _check_fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, act)
    edge = e is not None
    if edge:
        _check_edge(e, slot_edge, eq.shape[1], ek.dtype, slot_src, device)
    if not on_cuda(device):
        return ell_act_reduce_plain(eq, ek, slot_src, scale, row_key,
                                    row_ptr, act, derivative=derivative,
                                    e=e, slot_edge=slot_edge)
    r, h = row_key.shape[0], eq.shape[1]
    rows = torch.empty((r, h), dtype=torch.float32, device=device)
    outs = [rows]
    if derivative:
        outs.append(torch.empty((r, h), dtype=torch.float32, device=device))
    tables = (_ptr(eq), _ptr(ek)) + ((_ptr(e),) if edge else ())
    slots = (_ptr(slot_src),) + ((_ptr(slot_edge),) if edge else ())
    _launch(name, device, *tables, int(ek.dtype == torch.bfloat16), *slots,
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h, act.kernel_id,
            float(act.param), *map(_ptr, outs))
    return tuple(outs) if derivative else rows


def ell_act_reduce(eq, ek, slot_src, scale, row_key, row_ptr, act):
    """rows[r] = sum_s scale[s] * act(eq[row_key[r]] + ek[slot_src[s]]) over
    the slots of row r, in f32. eq [N, H] f32; ek [N, H] f32 or bf16.

    Replaces ``bucket_bcast_act_reduce`` (sir_gcn_tpu/ops/pallas/
    kernels.py), one launch for all buckets instead of one per bucket.
    Bound: bytes, eq and ek rows in, one f32 [R, H] out."""
    return _fwd("ell_act_reduce", eq, ek, slot_src, scale, row_key, row_ptr,
                act, derivative=False)


def ell_act_reduce2(eq, ek, slot_src, scale, row_key, row_ptr, act):
    """``ell_act_reduce`` plus srows[r] = sum_s scale[s] * act'(z): the
    derivative mass that makes the query-side gradient a node-sized
    multiply. Returns (rows, srows), both f32 [R, H].

    Replaces ``bucket_bcast_act_reduce2`` (sir_gcn_tpu/ops/pallas/
    kernels.py). Bound: bytes, as ``ell_act_reduce`` plus a second output."""
    return _fwd("ell_act_reduce2", eq, ek, slot_src, scale, row_key,
                row_ptr, act, derivative=True)


def ell_act_reduce_edge(eq, ek, slot_src, scale, row_key, row_ptr, act, e,
                        slot_edge):
    """``ell_act_reduce`` with an edge term: the key-side value of slot s is
    add_cast(ek[slot_src[s]], e[slot_edge[s]]), added in f32 and carried in
    ek's type. e [E_pad, H] in sorted-edge order shares ek's type.

    Replaces ``bucket_bcast_act_reduce`` on the JAX route's ``with_edge``
    inputs (sir_gcn_tpu/ops/ell.py ``dst_slot_inputs``), the edge rows read
    by index in the kernel. Bound: bytes, as ``ell_act_reduce`` plus one
    e row per slot."""
    return _fwd("ell_act_reduce_edge", eq, ek, slot_src, scale, row_key,
                row_ptr, act, derivative=False, e=e, slot_edge=slot_edge)


def ell_act_reduce2_edge(eq, ek, slot_src, scale, row_key, row_ptr, act, e,
                         slot_edge):
    """``ell_act_reduce2`` with the edge term of ``ell_act_reduce_edge``.

    Replaces ``bucket_bcast_act_reduce2`` on the ``with_edge`` inputs.
    Bound: bytes, as ``ell_act_reduce2`` plus one e row per slot."""
    return _fwd("ell_act_reduce2_edge", eq, ek, slot_src, scale, row_key,
                row_ptr, act, derivative=True, e=e, slot_edge=slot_edge)


# ----------------------------------------------------------------------
# #4: the src-major backward for the key-side gradient
# ----------------------------------------------------------------------

def ell_src_bwd_plain(eq, g, ek, slot_dst, scale, row_key, row_ptr, act,
                      buckets=None, e=None, slot_edge=None, edge2slot=None,
                      edge_mask=None):
    """Plain version of ``ell_src_bwd`` (and of ``ell_src_bwd_rowwise``),
    bucket by bucket: g_z = vjp(act, z)(scale * g), which for an
    elementwise act is act'(z) * (scale * g). eq and g are gathered in
    their own dtype and widened to f32. With ``e`` (and
    ``slot_edge``, ``edge2slot``, ``edge_mask``) it is the plain version of
    ``ell_src_bwd_edge``: the dst-side value adds the edge row by
    ``add_cast``, and it returns (rows, g_e) with g_e the JAX route's
    ``_edge_cotangent`` of the per-slot g_z rounded to eq's type."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = ek.shape[1]
    eqg = eq.index_select(0, slot_dst)
    if e is not None:
        eqg = add_cast(eqg, e.index_select(0, slot_edge))
    gg = g.index_select(0, slot_dst)
    ek_rows = ek.index_select(0, row_key)
    rows, gzs = [], []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (eqg[so:so + b * nr].float().reshape(nr, b, h)
             + ek_rows[ro:ro + nr, None, :])
        g_m = (gg[so:so + b * nr].float().reshape(nr, b, h)
               * scale[so:so + b * nr].reshape(nr, b, 1))
        g_z = act.vjp(z, g_m)
        rows.append(g_z.sum(1))
        gzs.append(g_z.reshape(nr * b, h))
    rows = torch.cat(rows)
    if e is None:
        return rows
    from ..ell import edge_cotangent

    g_z = torch.cat(gzs).to(eq.dtype)
    return rows, edge_cotangent(g_z, edge2slot, edge_mask)


def _check_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr):
    device = ek.device
    _check("ek", ek, _F32, 2, device)
    _check("eq", eq, _EDGE, 2, device)
    _check("g", g, (eq.dtype,), 2, device)
    if eq.shape != g.shape or eq.shape[1] != ek.shape[1]:
        raise ValueError(f"eq {tuple(eq.shape)}, g {tuple(g.shape)} and ek "
                         f"{tuple(ek.shape)} do not match")
    _check_plan(slot_dst, scale, row_key, row_ptr, device)
    return device, row_key.shape[0], ek.shape[1]


def _src_bwd(name, eq, g, ek, slot_dst, scale, row_key, row_ptr, act):
    device, r, h = _check_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr)
    if name not in _GENERAL:
        _need_diagonal(name, act)
    if not on_cuda(device):
        return ell_src_bwd_plain(eq, g, ek, slot_dst, scale, row_key,
                                 row_ptr, act)
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch(name, device, _ptr(eq), _ptr(g), int(eq.dtype == torch.bfloat16),
            _ptr(ek), _ptr(slot_dst), _ptr(scale), _ptr(row_key),
            _ptr(row_ptr), r, h, act.kernel_id, float(act.param), _ptr(out))
    return out


def ell_src_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr, act):
    """out[r] = sum_s act'(eq[slot_dst[s]] + ek[row_key[r]]) * scale[s]
    * g[slot_dst[s]] over the slots of src-plan row r, in f32. eq and g
    [N, H] share one dtype (f32 or bf16); ek [N, H] is f32.

    Replaces ``bucket_src_bwd`` without its per-slot g_z output
    (sir_gcn_tpu/ops/pallas/kernels.py). Bound: bytes, eq and g rows in,
    one f32 [R, H] out."""
    return _src_bwd("ell_src_bwd", eq, g, ek, slot_dst, scale, row_key,
                    row_ptr, act)


def ell_src_bwd_edge(eq, g, ek, slot_dst, scale, row_key, row_ptr, act, e,
                     slot_edge, edge2slot, edge_mask):
    """``ell_src_bwd`` with an edge term, and the per-edge cotangent: the
    dst-side value of slot s is add_cast(eq[slot_dst[s]], e[slot_edge[s]])
    and g_z[s] = act'(z) * scale[s] * g[slot_dst[s]]. e [E_pad, H] shares
    eq's type; edge2slot [E_pad] int32 is the plan's edge -> src-slot map and
    edge_mask [E_pad] bool the edges' validity. Returns (rows [R, H] f32,
    g_e [E_pad, H] f32), g_e = ``edge_cotangent(g_z rounded to eq's type,
    edge2slot, edge_mask)``.

    Replaces ``bucket_src_bwd`` with its per-slot g_z output and the take
    of ``_edge_cotangent`` after it (sir_gcn_tpu/ops/ell.py ``src_pass``):
    the kernel writes each slot's g_z straight into row slot_edge[s] of a
    zeroed g_e, so no [S, H] table is written. Bound: bytes, the f32 g_e
    write the largest part."""
    return _src_bwd_edge("ell_src_bwd_edge", eq, g, ek, slot_dst, scale,
                         row_key, row_ptr, act, e, slot_edge, edge2slot,
                         edge_mask)


def _src_bwd_edge(name, eq, g, ek, slot_dst, scale, row_key, row_ptr, act,
                  e, slot_edge, edge2slot, edge_mask):
    device, r, h = _check_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr)
    if name not in _GENERAL:
        _need_diagonal(name, act)
    _check_edge(e, slot_edge, h, eq.dtype, slot_dst, device)
    _check("edge2slot", edge2slot, _I32, 1, device)
    _check("edge_mask", edge_mask, (torch.bool,), 1, device)
    if not edge2slot.shape == edge_mask.shape == e.shape[:1]:
        raise ValueError(f"edge2slot {tuple(edge2slot.shape)}, edge_mask "
                         f"{tuple(edge_mask.shape)} and e {tuple(e.shape)} "
                         f"differ in edge count")
    if not on_cuda(device):
        return ell_src_bwd_plain(eq, g, ek, slot_dst, scale, row_key,
                                 row_ptr, act, e=e, slot_edge=slot_edge,
                                 edge2slot=edge2slot, edge_mask=edge_mask)
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    g_e = torch.zeros((e.shape[0], h), dtype=torch.float32, device=device)
    _launch(name, device, _ptr(eq), _ptr(g), _ptr(e),
            int(eq.dtype == torch.bfloat16), _ptr(ek), _ptr(slot_dst),
            _ptr(slot_edge), _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h,
            act.kernel_id, float(act.param), _ptr(out), _ptr(g_e))
    return out, g_e


# ----------------------------------------------------------------------
# #7 and #8: the fused edge projection (SIREConv's W_E inside the kernels)
# ----------------------------------------------------------------------
#
# e_basis [E_pad, De] f32 is the edge basis in sorted-edge order and w_e
# [De, H] f32 the projection, in the JAX layout; a slot's edge term is
# e_basis[slot_edge[s]] @ w_e, in f32 and never rounded. The kernels take
# every De and H: on the register path (H <= 128, De <= 16; see
# ``EdgeLayout``) W_E and, in the backward, the warps' g_WE partials sit in
# the lanes' registers; on the shared path in a block's shared memory; on
# the columns path (tables larger than a block's shared memory) a block
# takes a chunk of W_E's columns, or reads W_E and keeps the partials in
# device memory; the backward's columns-path shapes with De <= 16 take the
# tiles path (W_E's columns in registers, g_WE on tensor-core tiles).

_EDGE_PATHS = {1: "shared", 2: "registers", 3: "columns", 4: "tiles"}


class EdgeLayout(NamedTuple):
    """How ``csrc/ell_edge_kernels.cu`` runs #7 (``fwd``) and #8
    (``bwd``) for rows of width H and a basis of width De: each kernel's
    path, "registers" (W_E and #8's g_WE partial in the lanes' registers,
    the slots' basis rows copied into shared memory by cp.async, several
    slots' node rows in flight), "shared" (the first design: W_E and the
    partials in shared memory), "columns" (the first design on chunks of
    columns, for tables larger than a block's shared memory) or, #8 only,
    "tiles" (the columns path's shapes with De <= 16: a block takes 128
    columns, a lane 4 of them and their W_E columns in registers, each
    slot's g_z row goes into the warp's tile of 16 slots, whose g_WE
    products run on the tensor cores in three TF32 passes, the next
    batch's rows copied into shared memory across rows); the features
    a lane of the row (a pass's on the shared path); the basis values a
    register-path or tiles-path kernel holds a slot (De padded to 8 or
    16; 0 when none takes either path); the slots whose node rows are in
    flight in each kernel (on the register path in the backward one with
    tanh, two with leaky_relu; on the tiles path a batch, 8 slots in bf16,
    4 in f32); each kernel's warps a block; on the columns and tiles paths
    each kernel's chunk (the columns a block takes, 0 on the other paths)
    and whether it keeps W_E
    (and #8 its partials) in device memory, where not even 32 columns'
    tables fit in shared memory."""

    fwd: str
    bwd: str
    feat_per_lane: int
    basis_width: int
    fwd_inflight: int
    bwd_inflight: int
    fwd_warps: int
    bwd_warps: int
    fwd_chunk: int = 0
    bwd_chunk: int = 0
    fwd_device: bool = False
    bwd_device: bool = False


def decode_edge_layout(code: int) -> Optional[EdgeLayout]:
    """The ``EdgeLayout`` of a code from the library's ``ell_edge_layout``
    (bits 0-1 the forward's path and 2-3 the backward's low two bits, bit
    36 its third, 1 shared, 2 registers, 3 columns, 4 tiles; 4-6 features
    a lane, 7-11 the basis width held, 12-15 and 16-19 the slots in
    flight, 20-23 and 24-27 the warps a block, 28-30 and 31-33 the chunks
    / 32, 34 and 35 the tables in device memory); None for -1, arguments
    the library refuses."""
    if code < 0:
        return None
    paths = code & 3, (code >> 2 & 3) | (code >> 36 & 1) << 2
    chunks = 32 * (code >> 28 & 7), 32 * (code >> 31 & 7)
    if (any(p not in _EDGE_PATHS for p in paths)
            or any((p in (3, 4)) != (c > 0) for p, c in zip(paths, chunks))):
        raise ValueError(f"layout code {code:#x} names no path, or a chunk "
                         f"off the columns and tiles paths")
    fwd, bwd = (_EDGE_PATHS[p] for p in paths)
    return EdgeLayout(fwd, bwd, code >> 4 & 7, code >> 7 & 0x1F,
                      code >> 12 & 0xF, code >> 16 & 0xF, code >> 20 & 0xF,
                      code >> 24 & 0xF, *chunks, bool(code >> 34 & 1),
                      bool(code >> 35 & 1))


def ell_edge_layout(h: int, de: int, act, dtype) -> Optional[EdgeLayout]:
    """The paths #7 and #8 take for rows of width ``h``, a basis of width
    ``de``, the elementwise sigma ``act`` and node rows of ``dtype`` (see
    ``EdgeLayout``); the library's entries decide from the same h and de.
    Needs a card: it asks the built library."""
    if h < 1 or de < 1:
        raise ValueError(f"widths must be positive, got H = {h}, De = {de}")
    code = _library("ell_edge_kernels").ell_edge_layout(
        h, de, act.kernel_id, int(dtype == torch.bfloat16))
    return decode_edge_layout(code)


def _edge_projection(e_basis, w_e, slot_edge):
    """[S, H] f32 edge terms of the slots, one matmul."""
    return e_basis.index_select(0, slot_edge) @ w_e


def ell_edge_act_reduce2_plain(eq, ek, e_basis, w_e, slot_src, slot_edge,
                               scale, row_key, row_ptr, act, buckets=None):
    """Plain version of ``ell_edge_act_reduce2``, bucket by bucket."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = eq.shape[1]
    kv = ek.index_select(0, slot_src).float() + _edge_projection(
        e_basis, w_e, slot_edge)
    eq_rows = eq.index_select(0, row_key)
    rows, srows = [], []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (kv[so:so + b * nr].reshape(nr, b, h)
             + eq_rows[ro:ro + nr, None, :])
        sc = scale[so:so + b * nr].reshape(nr, b, 1)
        rows.append((act(z) * sc).sum(1))
        srows.append((act.grad(z) * sc).sum(1))
    return torch.cat(rows), torch.cat(srows)


def ell_edge_src_bwd_plain(eq, g, ek, e_basis, w_e, slot_dst, slot_edge,
                           scale, row_key, row_ptr, act, buckets=None):
    """Plain version of ``ell_edge_src_bwd``, bucket by bucket; a slot with
    scale 0 contributes exactly 0 (``where``, not a product)."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = ek.shape[1]
    qv = eq.index_select(0, slot_dst).float() + _edge_projection(
        e_basis, w_e, slot_edge)
    gg = g.index_select(0, slot_dst)
    ek_rows = ek.index_select(0, row_key)
    rows, gzs = [], []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (qv[so:so + b * nr].reshape(nr, b, h)
             + ek_rows[ro:ro + nr, None, :])
        sc = scale[so:so + b * nr].reshape(nr, b, 1)
        g_z = torch.where(sc != 0, act.grad(z) * (
            gg[so:so + b * nr].float().reshape(nr, b, h) * sc), 0.0)
        rows.append(g_z.sum(1))
        gzs.append(g_z.reshape(nr * b, h))
    egr = e_basis.index_select(0, slot_edge)
    return torch.cat(rows), egr.T @ torch.cat(gzs)


def _check_fused(node_tbl, e_basis, w_e, slot_idx, slot_edge, scale, row_key,
                 row_ptr):
    device = node_tbl.device
    _check("e_basis", e_basis, _F32, 2, device)
    _check("w_e", w_e, _F32, 2, device)
    h, de = node_tbl.shape[1], e_basis.shape[1]
    if w_e.shape != (de, h):
        raise ValueError(f"w_e {tuple(w_e.shape)} is not [De, H] = "
                         f"{(de, h)}")
    _check("slot_edge", slot_edge, _I32, 1, device)
    if slot_edge.shape != slot_idx.shape:
        raise ValueError(f"slot_edge {tuple(slot_edge.shape)} and the slot "
                         f"array {tuple(slot_idx.shape)} differ")
    _check_plan(slot_idx, scale, row_key, row_ptr, device)
    return device, row_key.shape[0], h, de


def ell_edge_act_reduce2(eq, ek, e_basis, w_e, slot_src, slot_edge, scale,
                         row_key, row_ptr, act):
    """With z = eq[row_key[r]] + (ek[slot_src[s]] + e_basis[slot_edge[s]]
    @ w_e), rows[r] = sum_s scale[s] * act(z) and srows[r] = sum_s
    scale[s] * act'(z), both f32 [R, H]. eq [N, H] f32, ek [N, H] f32 or
    bf16, e_basis [E_pad, De] f32, w_e [De, H] f32, any De and H. Zero-scale
    slots are skipped.

    Replaces ``bucket_edge_act_reduce2`` (sir_gcn_tpu/ops/pallas/
    kernels.py), one launch for all buckets; ``ell_edge_layout`` tells its
    path (W_E past a block's shared memory: the columns path). Bound:
    operations at the arxiv width, 2 De + 9 flops per valid slot and
    feature."""
    device = _check_fwd("ell_edge_act_reduce2", eq, ek, slot_src, scale,
                        row_key, row_ptr, act)
    _, r, h, de = _check_fused(eq, e_basis, w_e, slot_src, slot_edge, scale,
                               row_key, row_ptr)
    if not on_cuda(device):
        return ell_edge_act_reduce2_plain(eq, ek, e_basis, w_e, slot_src,
                                          slot_edge, scale, row_key,
                                          row_ptr, act)
    rows = torch.empty((r, h), dtype=torch.float32, device=device)
    srows = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch("ell_edge_act_reduce2", device, _ptr(eq), _ptr(ek),
            int(ek.dtype == torch.bfloat16), _ptr(e_basis), _ptr(w_e),
            _ptr(slot_src), _ptr(slot_edge), _ptr(scale), _ptr(row_key),
            _ptr(row_ptr), r, h, de, act.kernel_id, float(act.param),
            _ptr(rows), _ptr(srows))
    return rows, srows


def ell_edge_src_bwd(eq, g, ek, e_basis, w_e, slot_dst, slot_edge, scale,
                     row_key, row_ptr, act):
    """The src-major backward of ``ell_edge_act_reduce2``: with z =
    ek[row_key[r]] + (eq[slot_dst[s]] + e_basis[slot_edge[s]] @ w_e) and
    g_z = act'(z) * scale[s] * g[slot_dst[s]], returns rows [R, H] f32 =
    sum over row r's slots of g_z, and g_we [De, H] f32 = sum over all slots
    of e_basis[slot_edge[s]]^T g_z[s]. eq and g [N, H] share one dtype (f32
    or bf16); ek [N, H] f32; any De and H. Zero-scale slots contribute
    exactly 0.

    Replaces ``bucket_edge_src_bwd`` (sir_gcn_tpu/ops/pallas/kernels.py).
    Bound: operations at the arxiv width, 4 De + 7 flops per valid slot and
    feature. g_we is summed per warp, block and then over blocks (on the
    columns path with the partials in device memory, per warp and then
    over warps; on the tiles path, past a block's shared memory with De <=
    16, a warp's sums are three-pass TF32 tensor-core products of tiles of
    16 slots) in a fixed order, so it is the same from run to run;
    ``ell_edge_layout`` tells the path."""
    device, r, h = _check_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr)
    _need_diagonal("ell_edge_src_bwd", act)
    _, _, _, de = _check_fused(ek, e_basis, w_e, slot_dst, slot_edge, scale,
                               row_key, row_ptr)
    if not on_cuda(device):
        return ell_edge_src_bwd_plain(eq, g, ek, e_basis, w_e, slot_dst,
                                      slot_edge, scale, row_key, row_ptr,
                                      act)
    bf16 = int(eq.dtype == torch.bfloat16)
    key = (device.index, r, h, de, act.kernel_id, bf16)
    if key not in _EDGE_BWD_BLOCKS:
        with torch.cuda.device(device):
            _EDGE_BWD_BLOCKS[key] = _library(
                "ell_edge_kernels").ell_edge_src_bwd_blocks(
                    r, h, de, act.kernel_id, bf16)
    parts = _EDGE_BWD_BLOCKS[key]  # the [De, H] partials it writes
    if parts <= 0:
        raise ValueError(f"ell_edge_src_bwd refuses R = {r}, H = {h}, De = "
                         f"{de}")
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    part = torch.empty((parts, de * h), dtype=torch.float32, device=device)
    g_we = torch.empty((de, h), dtype=torch.float32, device=device)
    _launch("ell_edge_src_bwd", device, _ptr(eq), _ptr(g), bf16, _ptr(ek),
            _ptr(e_basis), _ptr(w_e), _ptr(slot_dst), _ptr(slot_edge),
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h, de,
            act.kernel_id, float(act.param), parts, _ptr(out), _ptr(part),
            _ptr(g_we))
    return out, g_we


# ----------------------------------------------------------------------
# #9-#12: max aggregation (W_R per slot before the reduce)
# ----------------------------------------------------------------------
#
# The max wrappers take the dst plan's slot arrays as the linear ones do,
# plus W [H, O] f32 and, for the backward, node-level tables: key_max
# [N, O] (the key-level max, pre-bias) and gsc [N, O] (the cotangent split
# over tied winners). The kernels read a row's key_max and gsc rows through
# row_key, where the Pallas kernels take them pre-gathered per row.

NEG = torch.finfo(torch.float32).min


class MaxLayout(NamedTuple):
    """How ``csrc/ell_max_kernels.cu`` runs #9-#11 for widths (H, O):
    ``path`` "tensor" (the three-pass TF32 product on the tensor cores, the
    same for all three kernels); the forward's warps a block and W columns
    a block (more columns take more blocks in grid.y; on the wide path a
    warp's slab of W); the backward's warps a block and whether each warp
    keeps its g_W tiles in registers for the whole walk (else in the
    block's slice of the scratch; the wide path forms g_W apart, from a
    row of a and g_m a slot). ``wide``: the wide path, taken where the
    first design's backward cannot hold W beside four warps' tiles (H = O
    = 200 and wider): a block of up to sixteen warps (the same in both
    kernels) a tile of ``tile_slots`` slots, staged once, W streamed
    through shared memory by column slabs (16 slots a warp's tile on the
    first design, whose W sits in shared memory)."""

    path: str
    fwd_warps: int
    fwd_columns: int
    bwd_warps: int
    gw_in_registers: bool
    wide: bool = False
    tile_slots: int = 16


def decode_max_layout(code: int) -> Optional[MaxLayout]:
    """The ``MaxLayout`` of a code from the library's ``ell_max_layout``
    (bit 0 the tensor-core path, bits 1-5 forward warps, 6-13 forward
    columns, 14-18 backward warps, 19 g_W in registers, 20 the wide path,
    21-22 its subtiles of 16 slots a tile);
    None for -1, widths the kernels cannot take."""
    if code < 0:
        return None
    if not code & 1:
        raise ValueError(f"layout code {code:#x} names no product path")
    wide = bool(code >> 20 & 1)
    return MaxLayout("tensor", (code >> 1) & 0x1F, (code >> 6) & 0xFF,
                     (code >> 14) & 0x1F, bool(code >> 19 & 1), wide,
                     16 * ((code >> 21) & 3) if wide else 16)


def ell_max_layout(h: int, o: int) -> Optional[MaxLayout]:
    """The path #9, #10 and #11 take for W [h, o] (see ``MaxLayout``), or
    None for widths they cannot take; the library's entries decide from
    the same h and o. Needs a card: it asks the built library."""
    if h < 1 or o < 1:
        raise ValueError(f"widths must be positive, got H = {h}, O = {o}")
    return decode_max_layout(_library("ell_max_kernels").ell_max_layout(h, o))


def slot_products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [n, H] @ w [H, O] in f32, summed over h in increasing order with
    one rounded multiply and one rounded add per term. Each output row
    then depends on its own values only: a library GEMM may round equal
    rows differently in products of other shapes (one per bucket), which
    would split the exact ties that duplicated edges make."""
    m = a[:, :1] * w[0]
    for h in range(1, a.shape[1]):
        m = m + a[:, h:h + 1] * w[h]
    return m


def _row_reduce(z: torch.Tensor, op) -> torch.Tensor:
    """``op`` over the last dim of z in increasing order, one elementwise
    op a feature, keeping that dim (size 1): each row's result depends on
    its own values only, as ``slot_products``' sums do."""
    r = z[..., :1]
    for h in range(1, z.shape[-1]):
        r = op(r, z[..., h:h + 1])
    return r


def slot_act(act, z: torch.Tensor) -> torch.Tensor:
    """sigma(z) over each slot's row, as the plain max versions take it:
    an elementwise sigma as the registry computes it; a row-wise one
    (centered_relu, softmax) with its statistics summed by ``_row_reduce``.
    A library reduction may sum rows that start at different offsets in
    different orders (rows of an odd width), which would split the exact
    ties that duplicated edges make; these rows are rounded alike."""
    if act.diagonal:
        return act(z)
    if act.name == "centered_relu":
        mean = _row_reduce(z, torch.add) / z.shape[-1]
        return torch.relu(z - act.param * mean)
    if act.name == "softmax":
        x = torch.exp(z - _row_reduce(z, torch.maximum))
        return x / _row_reduce(x, torch.add)
    raise NotImplementedError(f"no plain max form of sigma {act.name}")


def bucket_products(eq, ek, slot_src, scale, row_key, w, act, buckets,
                    e=None, slot_edge=None):
    """Per bucket: (rows nr, row offset, z [nr, b, H], a = act(z)
    (``slot_act``), m = a @ w [nr, b, O], slot validity [nr, b, 1]), as the
    Pallas max kernels compute them, with ``slot_products`` for m. With an
    edge table ``e`` the key side of slot s is add_cast(ek[slot_src[s]],
    e[slot_edge[s]]), as the JAX route's ``slot_inputs`` rounds it."""
    h, o = w.shape
    ekg = ek.index_select(0, slot_src)
    if e is not None:
        ekg = add_cast(ekg, e.index_select(0, slot_edge))
    eq_rows = eq.index_select(0, row_key)
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (ekg[so:so + b * nr].float().reshape(nr, b, h)
             + eq_rows[ro:ro + nr, None, :])
        a = slot_act(act, z)
        m = slot_products(a.reshape(nr * b, h), w).reshape(nr, b, o)
        valid = scale[so:so + b * nr].reshape(nr, b, 1) > 0
        yield nr, ro, z, a, m, valid


def ell_max_fwd_plain(eq, ek, slot_src, scale, row_key, row_ptr, w, act,
                      buckets=None, e=None, slot_edge=None):
    """Plain version of ``ell_max_fwd`` (of ``ell_max_fwd_edge`` with ``e``
    and ``slot_edge``), bucket by bucket."""
    buckets = _buckets(row_ptr) if buckets is None else buckets
    return torch.cat([
        torch.where(valid, m, NEG).amax(1) for _, _, _, _, m, valid in
        bucket_products(eq, ek, slot_src, scale, row_key, w, act, buckets,
                        e, slot_edge)])


def ell_max_wincount_plain(eq, ek, slot_src, scale, row_key, row_ptr, w,
                           key_max, act, buckets=None, e=None,
                           slot_edge=None):
    """Plain version of ``ell_max_wincount`` (and of its edge form),
    bucket by bucket."""
    buckets = _buckets(row_ptr) if buckets is None else buckets
    ref = key_max.index_select(0, row_key)
    return torch.cat([
        ((m == ref[ro:ro + nr, None, :]) & valid).float().sum(1)
        for nr, ro, _, _, m, valid in
        bucket_products(eq, ek, slot_src, scale, row_key, w, act, buckets,
                        e, slot_edge)])


def ell_max_bwd_plain(eq, ek, slot_src, scale, row_key, row_ptr, w, key_max,
                      gsc, act, buckets=None, e=None, slot_edge=None):
    """Plain version of ``ell_max_bwd`` (and of its edge form), bucket by
    bucket: g_z = act.vjp(z, g_m @ w.T), sigma's vector-Jacobian product
    over each slot's row (act'(z) * g_a for an elementwise sigma)."""
    buckets = _buckets(row_ptr) if buckets is None else buckets
    h, o = w.shape
    ref = key_max.index_select(0, row_key)
    gsc_rows = gsc.index_select(0, row_key)
    geq, gz = [], []
    gw = torch.zeros_like(w)
    for nr, ro, z, a, m, valid in bucket_products(
            eq, ek, slot_src, scale, row_key, w, act, buckets, e, slot_edge):
        win = ((m == ref[ro:ro + nr, None, :]) & valid).float()
        g_m = (win * gsc_rows[ro:ro + nr, None, :]).reshape(-1, o)
        gw += a.reshape(-1, h).T @ g_m
        g_z = act.vjp(z, (g_m @ w.T).reshape(z.shape))
        geq.append(g_z.sum(1))
        gz.append(g_z.reshape(-1, h).to(ek.dtype))
    return torch.cat(geq), torch.cat(gz), gw


def _check_max(eq, ek, slot_src, scale, row_key, row_ptr, w, node_tables,
               e=None, slot_edge=None):
    """The checks of a max kernel's inputs: any sigma of the registry, an
    elementwise or a row-wise one, takes them."""
    device = eq.device
    _check("eq", eq, _F32, 2, device)
    _check("ek", ek, _EDGE, 2, device)
    _check("w", w, _F32, 2, device)
    if ek.shape[1] != eq.shape[1] or w.shape[0] != eq.shape[1]:
        raise ValueError(f"eq {tuple(eq.shape)}, ek {tuple(ek.shape)} and w "
                         f"{tuple(w.shape)} do not match")
    for name, t in node_tables.items():
        _check(name, t, _F32, 2, device)
        if t.shape != (eq.shape[0], w.shape[1]):
            raise ValueError(f"{name} {tuple(t.shape)} is not [N, O] = "
                             f"{(eq.shape[0], w.shape[1])}")
    _check_plan(slot_src, scale, row_key, row_ptr, device)
    if e is not None:
        _check_edge(e, slot_edge, eq.shape[1], ek.dtype, slot_src, device)
    return device, row_key.shape[0], eq.shape[1], w.shape[1]


def _edge_ptrs(e, slot_edge) -> tuple:
    """(the edge table's pointer, slot_edge's pointer) as argument tuples
    of an edge form, or two empty tuples without an edge term."""
    if e is None:
        return (), ()
    return (_ptr(e),), (_ptr(slot_edge),)


def _max_fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, w, act,
             key_max=None, e=None, slot_edge=None):
    """#9 (``key_max`` None) or #10, with the edge term where ``e`` is
    given: the checks, the plain version on the CPU, else one launch of
    ``name``."""
    tables = {} if key_max is None else {"key_max": key_max}
    device, r, h, o = _check_max(eq, ek, slot_src, scale, row_key, row_ptr,
                                 w, tables, e, slot_edge)
    if not on_cuda(device):
        if key_max is None:
            return ell_max_fwd_plain(eq, ek, slot_src, scale, row_key,
                                     row_ptr, w, act, e=e,
                                     slot_edge=slot_edge)
        return ell_max_wincount_plain(eq, ek, slot_src, scale, row_key,
                                      row_ptr, w, key_max, act, e=e,
                                      slot_edge=slot_edge)
    out = torch.empty((r, o), dtype=torch.float32, device=device)
    edge_tbl, edge_slots = _edge_ptrs(e, slot_edge)
    _launch(name, device, _ptr(eq), _ptr(ek), *edge_tbl,
            int(ek.dtype == torch.bfloat16), _ptr(slot_src), *edge_slots,
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), _ptr(w),
            *(() if key_max is None else (_ptr(key_max),)), r, h, o,
            act.kernel_id, float(act.param), _ptr(out))
    return out


def ell_max_fwd(eq, ek, slot_src, scale, row_key, row_ptr, w, act):
    """rows[r, o] = max over the valid slots s of row r (scale > 0) of
    (act(eq[row_key[r]] + ek[slot_src[s]]) @ w)[o], f32; the f32 min where
    row r has no valid slot. eq [N, H] f32, ek [N, H] f32 or bf16, w [H, O]
    f32; no bias. act is any sigma of the registry (a row-wise one over
    each slot's H features).

    Replaces ``bucket_max_gemm_fwd`` (sir_gcn_tpu/ops/pallas/kernels.py),
    one launch for all buckets. Bound: tensor-core operations, 2 H O flops
    per slot three times over (the three-pass TF32 split of every product,
    which keeps m as accurate as f32); ``ell_max_layout`` tells the path."""
    return _max_fwd("ell_max_fwd", eq, ek, slot_src, scale, row_key,
                    row_ptr, w, act)


def ell_max_fwd_edge(eq, ek, slot_src, scale, row_key, row_ptr, w, act, e,
                     slot_edge):
    """``ell_max_fwd`` with an edge term: the key side of slot s is
    add_cast(ek[slot_src[s]], e[slot_edge[s]]), added in f32 and carried in
    ek's type. e [E_pad, H] in sorted-edge order shares ek's type.

    Replaces ``bucket_max_gemm_fwd`` on the ``with_edge`` inputs of
    ``make_ell_sir_aggregate_max_pallas`` (its ``slot_inputs``), the edge
    rows read by index in the kernel. Bound: operations, as
    ``ell_max_fwd``, plus one e row a slot."""
    return _max_fwd("ell_max_fwd_edge", eq, ek, slot_src, scale, row_key,
                    row_ptr, w, act, e=e, slot_edge=slot_edge)


def ell_max_wincount(eq, ek, slot_src, scale, row_key, row_ptr, w, key_max,
                     act):
    """counts[r, o] = the number of valid slots of row r whose product m
    equals key_max[row_key[r], o] exactly: the tie count of the backward.
    key_max [N, O] f32 must come from the same computation of m (its own
    ``ell_max_fwd`` and max finalize).

    Replaces ``bucket_max_wincount``. Bound: operations, as the forward,
    whose product it repeats bit for bit."""
    return _max_fwd("ell_max_wincount", eq, ek, slot_src, scale, row_key,
                    row_ptr, w, act, key_max=key_max)


def ell_max_wincount_edge(eq, ek, slot_src, scale, row_key, row_ptr, w,
                          key_max, act, e, slot_edge):
    """``ell_max_wincount`` with the edge term of ``ell_max_fwd_edge``, whose
    product it repeats bit for bit.

    Replaces ``bucket_max_wincount`` on the ``with_edge`` inputs. Bound:
    operations, as ``ell_max_wincount``."""
    return _max_fwd("ell_max_wincount_edge", eq, ek, slot_src, scale,
                    row_key, row_ptr, w, act, key_max=key_max, e=e,
                    slot_edge=slot_edge)


def _max_bwd(name, eq, ek, slot_src, scale, row_key, row_ptr, w, key_max,
             gsc, act, e=None, slot_edge=None):
    device, r, h, o = _check_max(eq, ek, slot_src, scale, row_key, row_ptr,
                                 w, {"key_max": key_max, "gsc": gsc}, e,
                                 slot_edge)
    if not on_cuda(device):
        return ell_max_bwd_plain(eq, ek, slot_src, scale, row_key, row_ptr,
                                 w, key_max, gsc, act, e=e,
                                 slot_edge=slot_edge)
    bf16 = int(ek.dtype == torch.bfloat16)
    edge = int(e is not None)
    key = (device.index, r, h, o, act.kernel_id, bf16, edge)
    if key not in _BWD_BLOCKS:
        with torch.cuda.device(device):
            _BWD_BLOCKS[key] = _library("ell_max_kernels").ell_max_bwd_blocks(
                r, h, o, act.kernel_id, bf16, edge)
    blocks = _BWD_BLOCKS[key]
    if blocks <= 0:
        raise ValueError(f"{name} cannot take H = {h}, O = {o}")
    geq = torch.empty((r, h), dtype=torch.float32, device=device)
    gz = torch.empty((slot_src.shape[0], h), dtype=ek.dtype, device=device)
    # the g_W partials and, on the wide path, a and g_m of every slot
    part = torch.empty(_library("ell_max_kernels").ell_max_bwd_scratch(
        slot_src.shape[0], blocks, h, o), dtype=torch.float32, device=device)
    gw = torch.empty((h, o), dtype=torch.float32, device=device)
    edge_tbl, edge_slots = _edge_ptrs(e, slot_edge)
    _launch(name, device, _ptr(eq), _ptr(ek), *edge_tbl, bf16,
            _ptr(slot_src), *edge_slots, _ptr(scale), _ptr(row_key),
            _ptr(row_ptr), _ptr(w), _ptr(key_max), _ptr(gsc), r, h, o,
            act.kernel_id, float(act.param), blocks, _ptr(geq), _ptr(gz),
            _ptr(part), _ptr(gw))
    return geq, gz, gw


def ell_max_bwd(eq, ek, slot_src, scale, row_key, row_ptr, w, key_max, gsc,
                act):
    """The max backward: with g_m[s, o] = gsc[key, o] where slot s is valid
    and m[s, o] == key_max[key, o] (else 0), returns

        geq_rows [R, H] f32   sum over row r's slots of g_z
        g_z      [S, H]       vjp(act, z)(g_m @ w.T), in ek's dtype
        g_w      [H, O] f32   sum over all slots of a^T g_m

    (vjp(act, z)(g) = act'(z) * g for an elementwise sigma). Replaces
    ``bucket_max_gemm_bwd``. Bound: tensor-core operations, 6 H O flops
    per slot three times over (m, g_a and g_W, each split in three TF32
    passes). g_w is summed per block and then over blocks in a fixed
    order, so it is the same from run to run. On the wide path
    (``ell_max_layout``) the scratch also holds a and g_m of every slot,
    from which a split-K kernel forms g_w: S (round8(H) + round8(O))
    floats, which grow with the slots (at H = O = 512, 327 MB at
    roman-empire's plan of 79,952 slots, 10.9 GB at the ogbn-arxiv plan's
    2,654,864), where the first design's scratch is the partials alone,
    blocks H O floats. A graph whose 4 S (round8(H) + round8(O)) bytes do
    not fit on the card beside the model cannot take the wide path's
    backward."""
    return _max_bwd("ell_max_bwd", eq, ek, slot_src, scale, row_key,
                    row_ptr, w, key_max, gsc, act)


def ell_max_bwd_edge(eq, ek, slot_src, scale, row_key, row_ptr, w, key_max,
                     gsc, act, e, slot_edge):
    """``ell_max_bwd`` with the edge term of ``ell_max_fwd_edge``. Its g_z
    (in ek's dtype) gives the per-edge cotangent through the edge -> dst
    slot map (``ops.ell.edge_cotangent``), as JAX's ``_edge_cotangent``
    takes it from the Pallas kernel's g_z.

    Replaces ``bucket_max_gemm_bwd`` on the ``with_edge`` inputs. Bound:
    operations, as ``ell_max_bwd``."""
    return _max_bwd("ell_max_bwd_edge", eq, ek, slot_src, scale, row_key,
                    row_ptr, w, key_max, gsc, act, e=e, slot_edge=slot_edge)


def ell_scaled_reduce_plain(values, slot_idx, scale, row_ptr, buckets=None):
    """Plain version of ``ell_scaled_reduce``, bucket by bucket; slots with
    scale 0 contribute 0 whatever they read."""
    buckets = _buckets(row_ptr) if buckets is None else buckets
    h = values.shape[1]
    v = values.index_select(0, slot_idx).float() * scale[:, None]
    v = torch.where(scale[:, None] != 0, v, 0.0)
    return torch.cat([v[so:so + b * nr].reshape(nr, b, h).sum(1)
                      for b, nr, so, _ in bucket_offsets(buckets)])


def ell_scaled_reduce(values, slot_idx, scale, row_ptr):
    """out[r] = sum over the slots s of row r of scale[s] *
    values[slot_idx[s]], f32. values [*, H] f32 or bf16 (the dst-slot g_z
    of ``ell_max_bwd``), slot_idx [S] int32 (``src_slot_from_dst_slot``),
    scale [S] f32 (the src plan's slot validity).

    Replaces ``bucket_scaled_reduce`` and the ``jnp.take`` that permuted
    g_z into src-slot order before it. Bound: bytes."""
    device = values.device
    _check("values", values, _EDGE, 2, device)
    _check("slot_idx", slot_idx, _I32, 1, device)
    _check("scale", scale, _F32, 1, device)
    _check("row_ptr", row_ptr, _I32, 1, device)
    if scale.shape != slot_idx.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and slot_idx "
                         f"{tuple(slot_idx.shape)} differ")
    if not on_cuda(device):
        return ell_scaled_reduce_plain(values, slot_idx, scale, row_ptr)
    r, h = row_ptr.shape[0] - 1, values.shape[1]
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch("ell_scaled_reduce", device, _ptr(values),
            int(values.dtype == torch.bfloat16), _ptr(slot_idx), _ptr(scale),
            _ptr(row_ptr), r, h, _ptr(out))
    return out


# ----------------------------------------------------------------------
# #1r, #3, #4r, #5, #6: the general route and the full-vjp backwards
# ----------------------------------------------------------------------
#
# These take any sigma of the registry at any width. A row-wise one
# (centered_relu, softmax) couples a slot's H features, so its kernels hold
# the whole row in a warp's registers, and past H = 512 take its
# statistics by passes over it (the wide path); an elementwise one walks
# the row in chunks. For an elementwise sigma each vjp is act'(z) *
# cotangent, the arithmetic of #4. #1r, #3 and #4r, and their edge-term
# forms (``*_edge``), take a lane-group path for a row-wise sigma, #5 for
# any sigma, #6 for a row-wise sigma where its g_slots has ek's type
# (``ell_general_layout``): up to H = 256, and #1r and #4r (and their edge
# forms) up to H = 512 on groups of the whole warp.

# the kernels of csrc/ell_general_kernels.cu with a lane-group path, by the
# id ell_general_layout takes (the source's MODE), and the edge forms' by
# the id ell_general_edge_layout takes
_GENERAL_LAYOUT_KERNEL = {"ell_geq_reduce": 0, "ell_src_bwd_rowwise": 1,
                          "ell_act_reduce_rowwise": 2,
                          "ell_src_bwd_fused": 3, "ell_act_reduce_bwd": 4}
_GENERAL_EDGE_LAYOUT_KERNEL = {"ell_geq_reduce_edge": 0,
                               "ell_src_bwd_rowwise_edge": 1,
                               "ell_act_reduce_rowwise_edge": 2}
# the row width past which a row-wise sigma takes the wide path in #3, #5
# and #6 (in #1r and #4r past 512, or past 256 where the lane-group path
# does not go)
ROW_MAX = 256


class GeneralLayout(NamedTuple):
    """The lane-group path of #1r ``ell_act_reduce_rowwise``, #3
    ``ell_geq_reduce``, #4r ``ell_src_bwd_rowwise`` (and their edge
    forms), #5 ``ell_src_bwd_fused`` and #6 ``ell_act_reduce_bwd``
    (``csrc/ell_general_kernels.cu``) for rows of
    width H: a gathered row is ``chunks`` chunks of 16 bytes, spread over a
    group of ``group_width`` lanes (a power of two), ``chunks_per_lane``
    chunks a lane; a warp's ``groups`` groups each work on their own slot,
    ``inflight`` slots a group to a batch of gathers, the next batch in
    flight while one is worked. Up to H = ``ROW_MAX`` groups of 1 to 16
    lanes; #1r and #4r (and their edge forms) take H up to 512 on groups
    of 32 lanes, one slot a warp: at 512
    ``GeneralLayout(64, 32, 1, 2, 1)`` in bf16 and ``(128, 32, 1, 4, 1)``
    in f32."""

    chunks: int
    group_width: int
    groups: int
    chunks_per_lane: int
    inflight: int


class WideLayout(NamedTuple):
    """The wide path of the first design, for a row-wise sigma past H =
    ``ROW_MAX`` where the lane-group path does not go (#3, #5 and #6; #1r
    and #4r past 512 or on rows that are not whole 16-byte chunks or
    tables off 16-byte alignment), one warp a row,
    ``features_per_lane`` features of a slot's
    row in each lane's registers at once: up to H = 512 the whole row (16 a
    lane, ``chunks`` 1); past it 8 a lane, the features walked in
    ``chunks`` chunks of 256, and for each chunk every slot's
    statistics (the mean; the max and the sum; the vjps' second sum or dot)
    taken by passes over the slot's whole row."""

    features_per_lane: int
    chunks: int


def decode_general_layout(code: int):
    """The ``GeneralLayout`` of a code from the library's
    ``ell_general_layout`` (bits 16-23 the chunks of a row, 8-15 the group
    width, 0-7 the slots in flight), the ``WideLayout`` of a code whose
    bits 24-31 are 0x40 (bits 16-23 its features a lane, 0-15 its chunks);
    None for 0, the first design."""
    if code == 0:
        return None
    f, n = code >> 16 & 0xFF, code & 0xFFFF
    if code >> 24 == 0x40 and f in (8, 16) and n:
        return WideLayout(f, n)
    c, gw, u = code >> 16 & 0xFF, code >> 8 & 0xFF, code & 0xFF
    if code < 0 or code >> 24 or not c or not u or gw not in (1, 2, 4, 8,
                                                              16, 32):
        raise ValueError(f"layout code {code:#x} names no lane-group path")
    return GeneralLayout(c, gw, 32 // gw, -(-c // gw), u)


def ell_general_layout(name: str, h: int, dtype, act, *tensors, lib=None):
    """The path a launch of ``name`` (a kernel of
    ``csrc/ell_general_kernels.cu``) takes for rows of width ``h``, the
    gathered table in ``dtype`` (f32 or bf16: ek for
    ``ell_act_reduce_rowwise``, ``ell_geq_reduce`` and
    ``ell_act_reduce_bwd``, eq and g for ``ell_src_bwd_rowwise``, the
    [N, 2H] table for ``ell_src_bwd_fused``; the same for the edge forms),
    the sigma ``act`` and the CUDA tensors it reads and writes whole rows of
    (at most five: its node tables and its outputs, in the order the
    wrapper takes and returns them; for ``ell_src_bwd_fused`` the [N, 2H]
    table first; for an edge form at most six, its e and g_e among them): a
    ``GeneralLayout`` for the lane-group path (up to H = ``ROW_MAX``, in
    #1r and #4r and their edge forms up to 512), a
    ``WideLayout`` for the wide path (a row-wise sigma past H = ``ROW_MAX``
    that the lane-group path does not take: the row in registers, or past
    H = 512 passes over it), None for the first design
    (an elementwise sigma but in ``ell_src_bwd_fused``, rows that are not
    whole 16-byte chunks, a table off 16-byte alignment, or an
    ``ell_act_reduce_bwd`` whose g_slots, its fourth tensor, is not in
    ``dtype``). The entry decides from the same H, types and pointers.
    Needs a card: it asks the built library, or ``lib``, another build of
    the same source (``tools/ell_ab.py``)."""
    if name not in _GENERAL:
        raise ValueError(f"{name!r} is not a kernel of the general route "
                         f"({', '.join(_GENERAL)})")
    if h < 1:
        raise ValueError(f"the width must be positive, got H = {h}")
    edge = name in _GENERAL_EDGE_LAYOUT_KERNEL
    most = 6 if edge else 5
    if len(tensors) > most:
        raise ValueError(f"at most {'six' if edge else 'five'} tensors, got "
                         f"{len(tensors)}")
    wide = not act.diagonal and h > ROW_MAX
    if (name == "ell_act_reduce_bwd" and len(tensors) > 3
            and tensors[3].dtype != dtype and not wide):
        return None  # g_slots in another type than ek: the first design
    ptrs = [_ptr(t) for t in tensors] + [None] * (most - len(tensors))
    if lib is None:
        lib = _library("ell_general_kernels")
    query = lib.ell_general_edge_layout if edge else lib.ell_general_layout
    kernels = _GENERAL_EDGE_LAYOUT_KERNEL if edge else _GENERAL_LAYOUT_KERNEL
    code = query(kernels[name], h, int(dtype == torch.bfloat16),
                 act.kernel_id, *ptrs)
    return decode_general_layout(code)


def ell_act_reduce_rowwise(eq, ek, slot_src, scale, row_key, row_ptr, act):
    """``ell_act_reduce`` for any sigma of the registry: rows[r] = sum_s
    scale[s] * act(eq[row_key[r]] + ek[slot_src[s]]), act applied to a
    slot's whole row. Its plain version is ``ell_act_reduce_plain``.

    Replaces ``bucket_bcast_act_reduce`` on the JAX general route
    (``make_ell_sir_aggregate_pallas(act_elementwise=False)``, training
    forward and eval). Bound: bytes, as ``ell_act_reduce``."""
    return _fwd("ell_act_reduce_rowwise", eq, ek, slot_src, scale, row_key,
                row_ptr, act, derivative=False)


def ell_act_reduce_rowwise_edge(eq, ek, slot_src, scale, row_key, row_ptr,
                                act, e, slot_edge):
    """``ell_act_reduce_rowwise`` with the edge term of
    ``ell_act_reduce_edge``: the key side of slot s is
    add_cast(ek[slot_src[s]], e[slot_edge[s]]), added in f32 and carried in
    ek's type; e [E_pad, H] in sorted-edge order shares ek's type. Its
    plain version is ``ell_act_reduce_plain`` with ``e`` and ``slot_edge``.

    Replaces ``bucket_bcast_act_reduce`` on the JAX general route's
    ``with_edge`` inputs (``dst_slot_inputs``), the edge rows read by index
    in the kernel. Bound: bytes, as ``ell_act_reduce_rowwise`` plus one e
    row per slot."""
    return _fwd("ell_act_reduce_rowwise_edge", eq, ek, slot_src, scale,
                row_key, row_ptr, act, derivative=False, e=e,
                slot_edge=slot_edge)


def ell_src_bwd_rowwise(eq, g, ek, slot_dst, scale, row_key, row_ptr, act):
    """``ell_src_bwd`` for any sigma of the registry: out[r] = sum_s
    vjp(act, eq[slot_dst[s]] + ek[row_key[r]])(scale[s] * g[slot_dst[s]]).
    Its plain version is ``ell_src_bwd_plain``.

    Replaces ``bucket_src_bwd`` with the full vjp, the general route's
    key-side backward (``src_pass``). Bound: bytes, as ``ell_src_bwd``."""
    return _src_bwd("ell_src_bwd_rowwise", eq, g, ek, slot_dst, scale,
                    row_key, row_ptr, act)


def ell_src_bwd_rowwise_edge(eq, g, ek, slot_dst, scale, row_key, row_ptr,
                             act, e, slot_edge, edge2slot, edge_mask):
    """``ell_src_bwd_edge`` for any sigma of the registry: the dst side of
    slot s is add_cast(eq[slot_dst[s]], e[slot_edge[s]]) and g_z[s] =
    vjp(act, z)(scale[s] * g[slot_dst[s]]). Returns (rows [R, H] f32, g_e
    [E_pad, H] f32), g_e = ``edge_cotangent(g_z rounded to eq's type,
    edge2slot, edge_mask)``; its plain version is ``ell_src_bwd_plain``
    with the edge arguments.

    Replaces ``bucket_src_bwd`` with the full vjp and its per-slot g_z
    output on the JAX general route's ``with_edge`` inputs, and the take
    of ``_edge_cotangent`` after it (``src_pass(need_gz=True)``): the
    kernel writes each slot's g_z straight into row slot_edge[s] of a
    zeroed g_e. Bound: bytes, the f32 g_e write the largest part."""
    return _src_bwd_edge("ell_src_bwd_rowwise_edge", eq, g, ek, slot_dst,
                         scale, row_key, row_ptr, act, e, slot_edge,
                         edge2slot, edge_mask)


def ell_act_reduce_bwd_plain(eq, ek, slot_src, scale, row_key, row_ptr, act,
                             g, gz_dtype=torch.float32, buckets=None, e=None,
                             slot_edge=None):
    """Plain version of ``ell_act_reduce_bwd``, bucket by bucket: z as in
    ``ell_act_reduce_plain`` (with the edge term where ``e`` and
    ``slot_edge`` are given), g_z = vjp(act, z)(g[row_key[r]] * scale[s]).
    Returns (g_slots [S, H] in ``gz_dtype``, geq_rows [R, H] f32), the row
    sums taken before the rounding to ``gz_dtype``."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = eq.shape[1]
    ekg = ek.index_select(0, slot_src)
    if e is not None:
        ekg = add_cast(ekg, e.index_select(0, slot_edge))
    eq_rows = eq.index_select(0, row_key)
    g_rows = g.index_select(0, row_key)
    gzs, rows = [], []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (ekg[so:so + b * nr].float().reshape(nr, b, h)
             + eq_rows[ro:ro + nr, None, :])
        g_m = g_rows[ro:ro + nr, None, :] * scale[so:so + b * nr].reshape(
            nr, b, 1)
        g_z = act.vjp(z, g_m)
        rows.append(g_z.sum(1))
        gzs.append(g_z.reshape(nr * b, h))
    return torch.cat(gzs).to(gz_dtype), torch.cat(rows)


def ell_geq_reduce_plain(eq, ek, slot_src, scale, row_key, row_ptr, act, g,
                         buckets=None, e=None, slot_edge=None):
    """Plain version of ``ell_geq_reduce`` (of ``ell_geq_reduce_edge`` with
    ``e`` and ``slot_edge``): the row sums of ``ell_act_reduce_bwd_plain``."""
    return ell_act_reduce_bwd_plain(eq, ek, slot_src, scale, row_key,
                                    row_ptr, act, g, buckets=buckets, e=e,
                                    slot_edge=slot_edge)[1]


def _check_geq(name, eq, ek, slot_src, scale, row_key, row_ptr, act, g):
    device = _check_fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, act)
    _check("g", g, _F32, 2, device)
    if g.shape != eq.shape:
        raise ValueError(f"g {tuple(g.shape)} and eq {tuple(eq.shape)} "
                         f"differ")
    return device, row_key.shape[0], eq.shape[1]


def _geq(name, eq, ek, slot_src, scale, row_key, row_ptr, act, g, e=None,
         slot_edge=None):
    device, r, h = _check_geq(name, eq, ek, slot_src, scale, row_key,
                              row_ptr, act, g)
    edge = e is not None
    if edge:
        _check_edge(e, slot_edge, h, ek.dtype, slot_src, device)
    if not on_cuda(device):
        return ell_geq_reduce_plain(eq, ek, slot_src, scale, row_key,
                                    row_ptr, act, g, e=e,
                                    slot_edge=slot_edge)
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    tables = (_ptr(eq), _ptr(ek)) + ((_ptr(e),) if edge else ())
    slots = (_ptr(slot_src),) + ((_ptr(slot_edge),) if edge else ())
    _launch(name, device, *tables, int(ek.dtype == torch.bfloat16), _ptr(g),
            *slots, _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h,
            act.kernel_id, float(act.param), _ptr(out))
    return out


def ell_geq_reduce(eq, ek, slot_src, scale, row_key, row_ptr, act, g):
    """The dst-side backward of ``ell_act_reduce_rowwise``: geq_rows[r] =
    sum_s vjp(act, z_s)(scale[s] * g[row_key[r]]) with z_s =
    eq[row_key[r]] + ek[slot_src[s]], f32 [R, H]. eq and g [N, H] f32 (g
    the cotangent of the aggregate), ek [N, H] f32 or bf16.

    Replaces ``bucket_geq_reduce`` (sir_gcn_tpu/ops/pallas/kernels.py), the
    general route's g_eq, with ek gathered by index in the kernel instead
    of the saved [S, H] gather. Bound: bytes, eq, g and ek rows in, one f32
    [R, H] out."""
    return _geq("ell_geq_reduce", eq, ek, slot_src, scale, row_key, row_ptr,
                act, g)


def ell_geq_reduce_edge(eq, ek, slot_src, scale, row_key, row_ptr, act, g,
                        e, slot_edge):
    """``ell_geq_reduce`` with the edge term of
    ``ell_act_reduce_rowwise_edge``: z_s = eq[row_key[r]] +
    add_cast(ek[slot_src[s]], e[slot_edge[s]]); e [E_pad, H] shares ek's
    type.

    Replaces ``bucket_geq_reduce`` on the JAX general route's
    ``with_edge`` inputs (the saved ``add_cast(ek_b, e_b)`` gather, here
    both rows read by index in the kernel). Bound: bytes, as
    ``ell_geq_reduce`` plus one e row per slot."""
    return _geq("ell_geq_reduce_edge", eq, ek, slot_src, scale, row_key,
                row_ptr, act, g, e=e, slot_edge=slot_edge)


def ell_act_reduce_bwd(eq, ek, slot_src, scale, row_key, row_ptr, act, g,
                       gz_dtype=torch.float32):
    """The dst-major backward: ``ell_geq_reduce``'s rows plus each slot's
    g_z = vjp(act, z_s)(scale[s] * g[row_key[r]]), the cotangent of the
    gathered ek row. Returns (g_slots [S, H] in ``gz_dtype``, f32 or bf16;
    geq_rows [R, H] f32, summed before the rounding). A zero-scale slot's
    g_slots row is 0. g_slots reduced by src through
    ``src_slot_from_dst_slot`` (``ell_scaled_reduce``) gives g_ek.

    Replaces ``bucket_bcast_act_reduce_bwd`` (sir_gcn_tpu/ops/pallas/
    kernels.py). As in the JAX package, no route of the library calls it.
    Where g_slots has ek's type it takes ``ell_geq_reduce``'s lane-group
    walk, and its rows are that kernel's bits (``ell_general_layout``).
    Bound: bytes, the [S, H] g_slots write the largest part."""
    device, r, h = _check_geq("ell_act_reduce_bwd", eq, ek, slot_src, scale,
                              row_key, row_ptr, act, g)
    if gz_dtype not in _EDGE:
        raise TypeError(f"gz_dtype {gz_dtype} is not f32 or bf16")
    if not on_cuda(device):
        return ell_act_reduce_bwd_plain(eq, ek, slot_src, scale, row_key,
                                        row_ptr, act, g, gz_dtype)
    geq = torch.empty((r, h), dtype=torch.float32, device=device)
    gz = torch.empty((slot_src.shape[0], h), dtype=gz_dtype, device=device)
    _launch("ell_act_reduce_bwd", device, _ptr(eq), _ptr(ek),
            int(ek.dtype == torch.bfloat16), _ptr(g), _ptr(slot_src),
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h, act.kernel_id,
            float(act.param), int(gz_dtype == torch.bfloat16), _ptr(geq),
            _ptr(gz))
    return gz, geq


def ell_src_bwd_fused_plain(both, ek, slot_dst, scale, row_key, row_ptr, act,
                            buckets=None):
    """Plain version of ``ell_src_bwd_fused``: ``ell_src_bwd_plain`` on the
    table's two halves."""
    h = ek.shape[1]
    return ell_src_bwd_plain(both[:, :h], both[:, h:], ek, slot_dst, scale,
                             row_key, row_ptr, act, buckets=buckets)


def ell_src_bwd_fused(both, ek, slot_dst, scale, row_key, row_ptr, act):
    """``ell_src_bwd_rowwise`` with eq and g read as the two halves of one
    node table both [N, 2H] = cat([eq, g], 1), f32 or bf16: one row read
    per slot instead of two. ek [N, H] f32. Any sigma of the registry.

    Replaces ``bucket_src_bwd_fused`` (sir_gcn_tpu/ops/pallas/kernels.py),
    the backward under ``fuse_bwd_take=True``; the JAX kernel's H % 128 == 0
    is a TPU lane layout and is not asked here. Bound: bytes, the table's
    rows in, one f32 [R, H] out."""
    device = ek.device
    _check("ek", ek, _F32, 2, device)
    _check("both", both, _EDGE, 2, device)
    h = ek.shape[1]
    if both.shape != (ek.shape[0], 2 * h):
        raise ValueError(f"both {tuple(both.shape)} is not [N, 2H] = "
                         f"{(ek.shape[0], 2 * h)}")
    _check_plan(slot_dst, scale, row_key, row_ptr, device)
    if not on_cuda(device):
        return ell_src_bwd_fused_plain(both, ek, slot_dst, scale, row_key,
                                       row_ptr, act)
    r = row_key.shape[0]
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch("ell_src_bwd_fused", device, _ptr(both),
            int(both.dtype == torch.bfloat16), _ptr(ek), _ptr(slot_dst),
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h, act.kernel_id,
            float(act.param), _ptr(out))
    return out
