"""Wrappers of the timing-lab kernels (``csrc/lab_kernels.cu``) and their
plain PyTorch versions: the port of the Pallas kernels of
``tools/kernel_lab.py`` (``make_v1`` .. ``make_v6``, ``make_copy``,
``make_copy32``, ``make_pass``, ``make_pass2``) and ``tools/gather_dma.py``
(its gather kernel and ``copy_kernel``).

A wrapper checks its inputs and on CUDA tensors launches its kernel on the
current stream; on CPU tensors it runs the plain version, which the tests
hold against the Pallas kernel in interpret mode. A CUDA tensor never takes
the plain version: a failed build or launch raises. Each wrapper counts its
launches in the shared ``LAUNCHES``.

Shapes (R rows of B slots, S = R*B slots, width H; the lab's sigma is
leaky_relu(SLOPE)):
  ekg  [S, H] bf16   slot rows, row r owning slots r*B .. r*B+B-1
  eq   [R, H] f32    the query row of each row
  sc   [S] f32       each slot's scale (the JAX tool's [S, 1])
  ekg3 [B, R, H] bf16, sc3 [B, R] f32: the plane-major layout (the JAX
                     tool's [B, R, 1] and [B, R] scales are the same bytes)
A row's H * itemsize / 16 sixteen-byte chunks must be a power of two of at
most 32 (H = 8 .. 256 in bf16, 4 .. 128 in f32). The knobs are the Hopper
counterparts of the Pallas variants' tile sizes; ``csrc/lab_kernels.cu``
names each mapping.
"""

from __future__ import annotations

import torch

from .kernels import _check, _launch, _ptr, on_cuda

SLOPE = 0.2
# the 8 rows each tile's sum is written to (the TPU's (8, 128) output block)
TILE_ROWS_OUT = 8
# a block's rows in lab_pass2's tiles
PASS2_TILE_ROWS = 256
# the dynamic shared memory a block can have on an H100 (lab_copy32's ring)
SMEM_BYTES = 232_448

_BF16 = (torch.bfloat16,)
_F32 = (torch.float32,)


def _check_width(name: str, t: torch.Tensor) -> int:
    h = t.shape[-1]
    chunks, rest = divmod(h * t.element_size(), 16)
    if rest or chunks < 1 or chunks > 32 or chunks & (chunks - 1):
        raise ValueError(f"{name}: a row of {h} {t.dtype} is not a power of "
                         f"two of 16-byte chunks, at most 32")
    return h


def _check_knob(name: str, value: int, choices) -> None:
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value}")


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


def act_reduce_plain(ekg, eq, sc):
    """Plain version of lab_v1, lab_v2 and lab_v3 (``make_v1`` .. ``make_v3``):
    out[r] = sum_b leaky(f32(ekg[r*B + b]) + eq[r]) * sc[r*B + b], f32."""
    r, h = eq.shape
    z = ekg.float().view(r, -1, h) + eq[:, None, :]
    return (leaky(z) * sc.view(r, -1, 1)).sum(1)


def act_reduce_bf16_plain(ekg, eq, sc):
    """Plain version of lab_v4 (``make_v4``), rounded to bf16 where the
    Pallas kernel computes in bf16: z = bf16(ekg + bf16(eq)), a = z or
    bf16(bf16(SLOPE) * z), m = bf16(a * bf16(sc)); the B terms summed in
    f32. jax.nn.leaky_relu on a bf16 z multiplies by the slope rounded to
    bf16 (0.2001953125)."""
    r, h = eq.shape
    bf = torch.bfloat16
    z = ekg.view(r, -1, h) + eq.to(bf)[:, None, :]
    a = torch.where(z >= 0, z, torch.tensor(SLOPE, dtype=bf) * z)
    return (a * sc.to(bf).view(r, -1, 1)).float().sum(1)


def plane_act_reduce_plain(ekg3, eq, sc3):
    """Plain version of lab_v5 and lab_v6 (``make_v5``, ``make_v6``): out[r]
    = sum_b leaky(f32(ekg3[b, r]) + eq[r]) * sc3[b, r], f32."""
    z = ekg3.float() + eq[None]
    return (leaky(z) * sc3[..., None]).sum(0)


def row_sum_plain(x, rows):
    """Plain version of lab_copy and lab_copy32 (``make_copy``,
    ``make_copy32``): out[r] = sum_b f32(x[r*B + b])."""
    return x.float().view(rows, -1, x.shape[1]).sum(1)


def pass_plain(x):
    """Plain version of lab_pass and lab_pass2 (``make_pass``,
    ``make_pass2``): x + 1 in bf16."""
    return x + 1


def _tiles_out(sums: torch.Tensor) -> torch.Tensor:
    """[G, H] tile sums broadcast over the 8 output rows: [G, 8, H]."""
    g, h = sums.shape
    return sums[:, None, :].expand(g, TILE_ROWS_OUT, h)


def gather_sum_plain(tbl, idx, tile):
    """Plain version of lab_gather (gather_dma.py's kernel): per tile of
    ``tile`` indices, the f32 sum of the indexed table rows, [G, 8, H]."""
    g = idx.shape[0] // tile
    rows = tbl.index_select(0, idx[:g * tile]).float()
    return _tiles_out(rows.view(g, tile, -1).sum(1))


def tile_sum_plain(v, tile):
    """Plain version of lab_tile_sum (gather_dma.py's ``copy_kernel``): per
    tile of ``tile`` rows, the f32 column sum, [G * 8, H]."""
    g = v.shape[0] // tile
    sums = v[:g * tile].float().view(g, tile, -1).sum(1)
    return _tiles_out(sums).reshape(g * TILE_ROWS_OUT, -1)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _act_inputs(ekg, eq, sc):
    device = eq.device
    _check("ekg", ekg, _BF16, 2, device)
    _check("eq", eq, _F32, 2, device)
    _check("sc", sc, _F32, 1, device)
    r, h = eq.shape
    if ekg.shape[1] != h or ekg.shape[0] % r or sc.shape[0] != ekg.shape[0]:
        raise ValueError(f"ekg {tuple(ekg.shape)}, eq {tuple(eq.shape)} and "
                         f"sc {tuple(sc.shape)} are not [R*B, H], [R, H], "
                         f"[R*B]")
    _check_width("ekg", ekg)
    return device, r, ekg.shape[0] // r, h


def _act(name, plain, knob, ekg, eq, sc):
    device, r, b, h = _act_inputs(ekg, eq, sc)
    if not on_cuda(device):
        return plain(ekg, eq, sc)
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch(name, device, _ptr(ekg), _ptr(eq), _ptr(sc), r, b, h,
            *(() if knob is None else (knob,)), SLOPE, _ptr(out))
    return out


V1_TILE_ROWS = (4, 8, 16)
INFLIGHT = (2, 4, 8)
PLANE_BLOCK_ROWS = (8, 16, 32)


def lab_v1(ekg, eq, sc, tile_rows=8):
    """act_reduce with each block's tile of ``tile_rows`` rows (tile_rows *
    B slot rows, 32 KB at B = 16, H = 128) staged in shared memory by
    cp.async first. Replaces ``make_v1`` (tools/kernel_lab.py). Bound:
    bytes."""
    _check_knob("tile_rows", tile_rows, V1_TILE_ROWS)
    return _act("lab_v1", act_reduce_plain, tile_rows, ekg, eq, sc)


def lab_v2(ekg, eq, sc, inflight=4):
    """act_reduce by one warp a row, ``inflight`` 16-byte loads a lane
    issued before use. Replaces ``make_v2``. Bound: bytes."""
    _check_knob("inflight", inflight, INFLIGHT)
    return _act("lab_v2", act_reduce_plain, inflight, ekg, eq, sc)


def lab_v3(ekg, eq, sc):
    """act_reduce by one thread a feature pair of a row, the B slots added
    in order. Replaces ``make_v3``. Bound: bytes."""
    return _act("lab_v3", act_reduce_plain, None, ekg, eq, sc)


def lab_v4(ekg, eq, sc, inflight=4):
    """``act_reduce_bf16_plain``'s function in lab_v2's design. Replaces
    ``make_v4``. Bound: bytes."""
    _check_knob("inflight", inflight, INFLIGHT)
    return _act("lab_v4", act_reduce_bf16_plain, inflight, ekg, eq, sc)


def _plane(name, ekg3, eq, sc3, block_rows):
    _check_knob("block_rows", block_rows, PLANE_BLOCK_ROWS)
    device = eq.device
    _check("ekg3", ekg3, _BF16, 3, device)
    _check("eq", eq, _F32, 2, device)
    _check("sc3", sc3, _F32, 2, device)
    b, r, h = ekg3.shape
    if eq.shape != (r, h) or sc3.shape != (b, r):
        raise ValueError(f"ekg3 {tuple(ekg3.shape)}, eq {tuple(eq.shape)} "
                         f"and sc3 {tuple(sc3.shape)} are not [B, R, H], "
                         f"[R, H], [B, R]")
    _check_width("ekg3", ekg3)
    if not on_cuda(device):
        return plane_act_reduce_plain(ekg3, eq, sc3)
    out = torch.empty((r, h), dtype=torch.float32, device=device)
    _launch(name, device, _ptr(ekg3), _ptr(eq), _ptr(sc3), r, b, h,
            block_rows, SLOPE, _ptr(out))
    return out


def lab_v5(ekg3, eq, sc3, block_rows=16):
    """act_reduce on the plane-major layout, each lane loading its row's
    scale of every plane. Replaces ``make_v5``. Bound: bytes."""
    return _plane("lab_v5", ekg3, eq, sc3, block_rows)


def lab_v6(ekg3, eq, sc3, block_rows=16):
    """lab_v5 with one scale load a row, passed to the row's lanes by
    ``__shfl_sync``. Replaces ``make_v6``. Bound: bytes."""
    return _plane("lab_v6", ekg3, eq, sc3, block_rows)


def _row_sum(name, dtypes, x, rows, inflight, max_slots=None):
    _check_knob("inflight", inflight, INFLIGHT)
    device = x.device
    _check("x", x, dtypes, 2, device)
    if rows <= 0 or x.shape[0] % rows:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"{rows}")
    h = _check_width("x", x)
    if max_slots is not None and x.shape[0] // rows > max_slots:
        raise ValueError(f"{name}: {x.shape[0] // rows} slots a row, at "
                         f"most {max_slots} with {inflight} in flight")
    if not on_cuda(device):
        return row_sum_plain(x, rows)
    out = torch.empty((rows, h), dtype=torch.float32, device=device)
    _launch(name, device, _ptr(x), rows, x.shape[0] // rows, h, inflight,
            _ptr(out))
    return out


def lab_copy(x, rows, inflight=4):
    """The sum-only stream: out[r] = sum_b f32(x[r*B + b]) for x [rows*B, H]
    bf16. Replaces ``make_copy``. Bound: bytes."""
    return _row_sum("lab_copy", _BF16, x, rows, inflight)


def lab_copy32(x, rows, inflight=8):
    """``lab_copy`` from f32 rows, by bulk copies: a block of ``inflight``
    warps keeps ``inflight`` slabs in flight while it sums as many more,
    two stages of shared memory of ``inflight`` slabs each, a slab the B
    slot rows of 32 / C rows (C = H / 4; one row at H = 128), 512 * B
    bytes; both stages fit in SMEM_BYTES. Each feature's B values are
    summed in slot order, so a launch repeats its bits. Replaces
    ``make_copy32``. Bound: bytes."""
    return _row_sum("lab_copy32", _F32, x, rows, inflight,
                    max_slots=SMEM_BYTES // (2 * 512 * inflight))


def _check_pass(x):
    _check("x", x, _BF16, 2, x.device)
    _check_width("x", x)


def lab_pass(x):
    """x + 1 for x [S, H] bf16, read once and written once. Replaces
    ``make_pass``. Bound: bytes."""
    _check_pass(x)
    if not on_cuda(x.device):
        return pass_plain(x)
    out = torch.empty_like(x)
    _launch("lab_pass", x.device, _ptr(x), x.numel(), _ptr(out))
    return out


def lab_pass2(x, persistent=False):
    """``lab_pass`` over tiles of PASS2_TILE_ROWS rows: one block a tile
    (the Pallas grid's "parallel" semantics), or with ``persistent`` a
    grid of as many blocks as fit on the card at once walking the tiles
    in turn ("arbitrary"). A thread issues all its 16-byte loads of a
    tile before any store, so x and the output must start 16-byte aligned
    (the launch raises otherwise). Replaces ``make_pass2``. Bound:
    bytes."""
    _check_pass(x)
    if not on_cuda(x.device):
        return pass_plain(x)
    out = torch.empty_like(x)
    _launch("lab_pass2", x.device, _ptr(x), x.numel(),
            PASS2_TILE_ROWS * x.shape[1], int(persistent), _ptr(out))
    return out


def _check_tiles(name, n, tile):
    if tile <= 0 or n % tile or n == 0:
        raise ValueError(f"{name}: {n} rows are not whole tiles of {tile}")
    return n // tile


def lab_gather(tbl, idx, tile):
    """Per tile of ``tile`` indices, the f32 sum of the rows tbl[idx[i]],
    written to 8 rows: [S / tile, 8, H] f32. tbl [N, H] bf16, idx [S] int32
    in [0, N), trusted (checking would cost a device sync). A persistent
    grid splits the indices evenly over its warps, 32 at a time; each
    warp's partial row of each tile it meets is added to the others in a
    fixed order, so a launch repeats its bits. The rows come in by 16-byte
    loads, so tbl must start 16-byte aligned (the launch raises
    otherwise). Replaces the
    gather kernel of tools/gather_dma.py. Bound: bytes (at the lab's size
    the table fits in the L2)."""
    device = tbl.device
    _check("tbl", tbl, _BF16, 2, device)
    _check("idx", idx, (torch.int32,), 1, device)
    h = _check_width("tbl", tbl)
    g = _check_tiles("idx", idx.shape[0], tile)
    if not on_cuda(device):
        return gather_sum_plain(tbl, idx, tile)
    out = torch.empty((g, TILE_ROWS_OUT, h), dtype=torch.float32,
                      device=device)
    _launch("lab_gather", device, _ptr(tbl), _ptr(idx), g, tile, h,
            _ptr(out))
    return out


def lab_gather_warps(h, tiles, tile) -> int:
    """The warps a launch of ``lab_gather`` on ``tiles`` tiles of ``tile``
    indices of width ``h`` splits the indices over: as many as the card
    holds at once, fewer where a tile would meet more than 7 of them. Needs
    a card: it asks the built library."""
    from .kernels import _library

    n = _library("lab_kernels").lab_gather_warps(tiles, tile, h)
    if n <= 0:
        raise ValueError(f"lab_gather takes no split of {tiles} tiles of "
                         f"{tile} rows of width {h}")
    return n


def lab_tile_sum(v, tile):
    """Per tile of ``tile`` rows of v [S, H] bf16, the f32 column sum,
    written to 8 rows: [S / tile * 8, H] f32. Replaces ``copy_kernel`` of
    tools/gather_dma.py. Bound: bytes."""
    device = v.device
    _check("v", v, _BF16, 2, device)
    h = _check_width("v", v)
    g = _check_tiles("v", v.shape[0], tile)
    if not on_cuda(device):
        return tile_sum_plain(v, tile)
    out = torch.empty((g * TILE_ROWS_OUT, h), dtype=torch.float32,
                      device=device)
    _launch("lab_tile_sum", device, _ptr(v), g, tile, h, _ptr(out))
    return out


# kernel -> its plain version, same positional inputs
PLAIN = {"lab_v1": act_reduce_plain, "lab_v2": act_reduce_plain,
         "lab_v3": act_reduce_plain, "lab_v4": act_reduce_bf16_plain,
         "lab_v5": plane_act_reduce_plain, "lab_v6": plane_act_reduce_plain,
         "lab_copy": row_sum_plain, "lab_copy32": row_sum_plain,
         "lab_pass": pass_plain, "lab_pass2": pass_plain,
         "lab_gather": gather_sum_plain, "lab_tile_sum": tile_sum_plain}
