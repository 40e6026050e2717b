"""Wrappers of the ELL CUDA kernels (``csrc/ell_kernels.cu``) and their
plain PyTorch versions (port of ``sir_gcn_tpu/ops/pallas/kernels.py``).

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
The index arrays come from a plan built by ``ops/ell.py`` and are trusted
to lie in range; checking them would cost a device sync.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LAUNCHES = {"ell_act_reduce": 0, "ell_act_reduce2": 0, "ell_src_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ell_act_reduce": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP,
                       _VP],
    "ell_act_reduce2": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
                        _VP, _VP, _VP],
    "ell_src_bwd": [_VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
                    _VP, _VP],
}


_LIB = None


def _library() -> ctypes.CDLL:
    """The kernel library with typed entries, built at first use."""
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("ell_kernels")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ell_error_string.argtypes = [ctypes.c_int]
        lib.ell_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.ell_error_string(code).decode()
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

def ell_act_reduce_plain(eq, ek, slot_src, scale, row_key, row_ptr, act,
                         buckets=None, derivative=False):
    """Plain version of ``ell_act_reduce`` (and of ``ell_act_reduce2`` with
    ``derivative=True``): gather, apply sigma, scale and reduce per bucket
    with ``reshape(nr, b, H).sum(1)``, as the Pallas kernels do. ek is
    gathered in its own dtype and widened to f32 before the add.
    ``buckets`` defaults to the runs read from ``row_ptr``."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = eq.shape[1]
    ekg = ek.index_select(0, slot_src)
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


def _fwd(name, eq, ek, slot_src, scale, row_key, row_ptr, act, derivative):
    device = eq.device
    _check("eq", eq, _F32, 2, device)
    _check("ek", ek, _EDGE, 2, device)
    if ek.shape[1] != eq.shape[1]:
        raise ValueError(f"eq {tuple(eq.shape)} and ek {tuple(ek.shape)} "
                         f"differ in width")
    _check_plan(slot_src, scale, row_key, row_ptr, device)
    if not on_cuda(device):
        return ell_act_reduce_plain(eq, ek, slot_src, scale, row_key,
                                    row_ptr, act, derivative=derivative)
    r, h = row_key.shape[0], eq.shape[1]
    rows = torch.empty((r, h), dtype=torch.float32, device=device)
    outs = [rows]
    if derivative:
        outs.append(torch.empty((r, h), dtype=torch.float32, device=device))
    _launch(name, device, _ptr(eq), _ptr(ek),
            int(ek.dtype == torch.bfloat16), _ptr(slot_src), _ptr(scale),
            _ptr(row_key), _ptr(row_ptr), r, h, act.kernel_id,
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


# ----------------------------------------------------------------------
# #4: the src-major backward for the key-side gradient
# ----------------------------------------------------------------------

def ell_src_bwd_plain(eq, g, ek, slot_dst, scale, row_key, row_ptr, act,
                      buckets=None):
    """Plain version of ``ell_src_bwd``, bucket by bucket. eq and g are
    gathered in their own dtype and widened to f32."""
    if buckets is None:
        buckets = _buckets(row_ptr)
    h = ek.shape[1]
    eqg = eq.index_select(0, slot_dst)
    gg = g.index_select(0, slot_dst)
    ek_rows = ek.index_select(0, row_key)
    rows = []
    for b, nr, so, ro in bucket_offsets(buckets):
        z = (eqg[so:so + b * nr].float().reshape(nr, b, h)
             + ek_rows[ro:ro + nr, None, :])
        g_m = (gg[so:so + b * nr].float().reshape(nr, b, h)
               * scale[so:so + b * nr].reshape(nr, b, 1))
        rows.append((act.grad(z) * g_m).sum(1))
    return torch.cat(rows)


def ell_src_bwd(eq, g, ek, slot_dst, scale, row_key, row_ptr, act):
    """out[r] = sum_s act'(eq[slot_dst[s]] + ek[row_key[r]]) * scale[s]
    * g[slot_dst[s]] over the slots of src-plan row r, in f32. eq and g
    [N, H] share one dtype (f32 or bf16); ek [N, H] is f32.

    Replaces ``bucket_src_bwd`` without its per-slot g_z output
    (sir_gcn_tpu/ops/pallas/kernels.py). Bound: bytes, eq and g rows in,
    one f32 [R, H] out."""
    device = ek.device
    _check("ek", ek, _F32, 2, device)
    _check("eq", eq, _EDGE, 2, device)
    _check("g", g, (eq.dtype,), 2, device)
    if eq.shape != g.shape or eq.shape[1] != ek.shape[1]:
        raise ValueError(f"eq {tuple(eq.shape)}, g {tuple(g.shape)} and ek "
                         f"{tuple(ek.shape)} do not match")
    _check_plan(slot_dst, scale, row_key, row_ptr, device)
    if not on_cuda(device):
        return ell_src_bwd_plain(eq, g, ek, slot_dst, scale, row_key,
                                 row_ptr, act)
    r, h = row_key.shape[0], ek.shape[1]
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch("ell_src_bwd", device, _ptr(eq), _ptr(g),
            int(eq.dtype == torch.bfloat16), _ptr(ek), _ptr(slot_dst),
            _ptr(scale), _ptr(row_key), _ptr(row_ptr), r, h, act.kernel_id,
            float(act.param), _ptr(out))
    return out
