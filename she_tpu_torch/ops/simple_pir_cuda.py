"""SimplePIR's response product: the kernel of csrc/simple_pir_matmul.cu
and its plain PyTorch version.

out[k, r] = sum_c D[r, c] * Q[k, c] mod 2^b, for the database D [R, C]
(entries below 2^p) and k request rows Q [k, C] of b-bit words. It
replaces she_tpu/pir/simple_pir.py:283, `self.database @ requests.T` on
numpy object arrays (a host product, not a Pallas kernel): PyTorch has no
integer matrix product on CUDA.

Both versions take D as ceil(p / 8) byte planes (`database_planes`, made
once when a server is built, as the kernel's tiles: 64 rows x 128 columns,
each the image of a 128-byte-swizzled shared-memory tile) and Q as
ceil(b / 8), and add the plane products Q_j D_i^T weighted by
2^(8 (i + j)) mod 2^b, skipping the pairs with 8 (i + j) >= b. The kernel
takes them as u8 x u8 -> s32 wgmma products over column segments short
enough that every s32 sum is exact; the plain version as one int64 matmul
(on the CPU) or float64 matmul (on the card, exact while 255^2 C < 2^53)
per pair.

`simple_pir_matmul` dispatches on the query's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
Each launch is counted in the tracer's registry as launch.simple_pir_matmul
and, while tracing is on, by (planes shape, rows, query shape, b), so a run
can time each shape it used.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from . import kernel_build


PLANE_BITS = 8
TILE_ROWS = 64  # rows of one wgmma and of a tile
BOX = 128  # columns of a tile: one 128-byte swizzled row
TILE_BYTES = TILE_ROWS * BOX
COLUMN_STEP = BOX  # C is padded to a multiple
CONSUMERS = 2  # consumer warpgroups a block: 128 rows
SEGMENT_BOXES = 256  # 32,768 columns: the most one s32 sum of one pair takes (32,768 * 255^2 < 2^31)
QUERY_TILE_ROWS = (8, 16, 32)  # request rows a query tile holds
ACC_COLUMNS = 256  # wgmma columns (sum of N) a block's D planes may hold sums of
PLANE_ROWS_PER_PASS = 4 * TILE_ROWS  # database rows split into planes at a time: whole tiles
MAX_BITS = 62  # the plain version adds two b-bit sums in int64
H100_SMS = 132
FLOAT64_EXACT = 1 << 53

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = [_VP] * 5 + [_INT, _INT, _LL, _INT, _LL] + [_INT] * 7 + [_VP]


def plane_count(bits: int) -> int:
    return -(-bits // PLANE_BITS)


def padded_columns(columns: int) -> int:
    return -(-columns // COLUMN_STEP) * COLUMN_STEP


def _swizzle(tiles: torch.Tensor) -> torch.Tensor:
    """[..., rows, 128] uint8 (rows a multiple of 8) -> [..., rows * 128]
    with the 16-byte chunk c of row r at chunk c ^ (r % 8): the 128-byte
    swizzle of wgmma's shared-memory tiles. Its own inverse."""
    *lead, rows, width = tiles.shape
    chunks = tiles.reshape(*lead, rows // 8, 8, width // 16, 16)
    r8 = torch.arange(8, device=tiles.device)[:, None]
    return chunks[..., r8, r8.T ^ r8, :].reshape(*lead, rows * width)


@dataclass(frozen=True)
class DatabasePlanes:
    """D's byte planes in the kernel's layout: `data` uint8 [P_D, R64, KB,
    8192], plane i, row tile t (64 rows, rows zero-padded to R64 * 64), box
    kb (128 columns, columns zero-padded to KB * 128 = padded_columns(C)):
    its 64 rows of 128 bytes, the 16-byte chunk c of row r at chunk
    c ^ (r % 8), the image of the shared-memory tile a bulk copy fills."""

    data: torch.Tensor
    rows: int
    columns: int

    def row_major(self) -> torch.Tensor:
        """uint8 [P_D, R, C]: plane i, entry (r, c) = bits 8i..8i+7 of D[r, c]."""
        pd, tiles, boxes = self.data.shape[:3]
        rows = _swizzle(self.data.view(pd, tiles, boxes, TILE_ROWS, BOX)).view(pd, tiles, boxes, TILE_ROWS, BOX)
        full = rows.permute(0, 1, 3, 2, 4).reshape(pd, tiles * TILE_ROWS, boxes * BOX)
        return full[:, : self.rows, : self.columns]


def database_planes(database: torch.Tensor, plaintext_bits: int) -> DatabasePlanes:
    """int database [R, C] with entries below 2^p -> its ceil(p / 8) byte
    planes in the kernel's tiles (DatabasePlanes), made on the database's
    device, PLANE_ROWS_PER_PASS rows at a time."""
    R, C = database.shape
    pd, tiles, kpad = plane_count(plaintext_bits), -(-R // TILE_ROWS), padded_columns(C)
    boxes = kpad // BOX
    data = torch.zeros((pd, tiles, boxes, TILE_BYTES), dtype=torch.uint8, device=database.device)
    for r0 in range(0, R, PLANE_ROWS_PER_PASS):
        rows = database[r0 : r0 + PLANE_ROWS_PER_PASS]
        t0, count = r0 // TILE_ROWS, -(-rows.shape[0] // TILE_ROWS)
        for i in range(pd):
            plane = torch.zeros((count * TILE_ROWS, kpad), dtype=torch.uint8, device=database.device)
            plane[: rows.shape[0], :C] = ((rows >> (PLANE_BITS * i)) & 0xFF).to(torch.uint8)
            data[i, t0 : t0 + count] = _swizzle(plane.view(count, TILE_ROWS, boxes, BOX).permute(0, 2, 1, 3))
    return DatabasePlanes(data, R, C)


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"the SimplePIR product takes 1 <= b <= {MAX_BITS}, got {bits}")


def simple_pir_matmul_plain(planes: DatabasePlanes, queries: torch.Tensor, bits: int) -> torch.Tensor:
    """planes (database_planes), queries int64 [k, C] -> int64 [k, R] in
    [0, 2^b): the plane products as int64 matmuls on the CPU, float64 on the
    card (exact while 255^2 C < 2^53), weighted and added mod 2^b."""
    _check_bits(bits)
    k, C = queries.shape
    if C != planes.columns:
        raise ValueError(f"queries of {C} columns for a database of {planes.columns}")
    if queries.device.type == "cpu":
        dtype = torch.int64
    elif 255 * 255 * C < FLOAT64_EXACT:
        dtype = torch.float64
    else:
        raise ValueError(f"the float64 plane products are not exact at C = {C}")
    mask = (1 << bits) - 1
    out = torch.zeros((k, planes.rows), dtype=torch.int64, device=queries.device)
    query_planes = [((queries >> (PLANE_BITS * j)) & 0xFF).to(dtype) for j in range(plane_count(bits))]
    row_major = planes.row_major()
    for i in range(row_major.shape[0]):
        a = row_major[i].to(dtype)
        for j, q in enumerate(query_planes):
            shift = PLANE_BITS * (i + j)
            if shift >= bits:
                continue
            partial = torch.matmul(q, a.T).to(torch.int64)
            out = (out + ((partial & ((1 << (bits - shift)) - 1)) << shift)) & mask
    return out


def _fits(ja: int, ni: int, kqt: int) -> bool:
    """ni D planes in one launch, the first meeting ja query planes: at most
    two, with at most ACC_COLUMNS pair sums a consumer thread's row pair."""
    return 1 <= ni <= min(2, ja) and ja <= 8 and (ni * ja - ni * (ni - 1) // 2) * kqt <= ACC_COLUMNS


@functools.lru_cache(maxsize=64)
def launch_plan(database_planes: int, query_planes: int, k: int, rows: int, kpad: int, sms: int = H100_SMS) -> dict:
    """The kernel's launches for these sizes: request rows a query tile
    (kqt) and their chunks; the groups (i0, ja, ni) of D planes, one
    persistent launch each (planes i >= query_planes are never read); the
    column segment in boxes of 128 columns and the segment count; the
    units of a launch; the grid.
    The segment count is the one, from the fewest that keep every s32 sum
    exact up to 32 more, whose units (segment, chunk, block of 128 rows),
    dealt round-robin to the grid, give the block with the most bytes the
    fewest."""
    kqt = next((t for t in QUERY_TILE_ROWS if t >= k), QUERY_TILE_ROWS[-1])
    chunks = -(-k // kqt)
    needed, groups, i0 = min(database_planes, query_planes), [], 0
    while i0 < needed:
        ja = query_planes - i0
        ni = 2 if needed - i0 >= 2 and _fits(ja, 2, kqt) else 1
        groups.append((i0, ja, ni))
        i0 += ni
    boxes, tiles = kpad // BOX, -(-rows // TILE_ROWS)
    row_blocks = -(-tiles // CONSUMERS)
    per_segment = chunks * row_blocks
    _, ja, ni = groups[0]  # the cost model's bytes a box
    present = np.minimum(CONSUMERS, tiles - CONSUMERS * np.arange(row_blocks))  # row tiles of each block
    best = None
    first = -(-boxes // SEGMENT_BOXES)
    for count in range(first, first + 33):
        segment = -(-boxes // count)
        segments = -(-boxes // segment)
        units = np.arange(segments * per_segment)
        grid = min(sms, units.size)
        length = np.minimum(segment, boxes - units // per_segment * segment) + 1  # a box's worth for the epilogue
        cost = length * (present[units % row_blocks] * ni * TILE_BYTES + ja * kqt * BOX)
        key = (int(np.bincount(units % grid, weights=cost).max()), segments)
        if best is None or key < best[0]:
            best = (key, dict(kqt=kqt, chunks=chunks, groups=tuple(groups), segment=segment, segments=segments,
                              units=units.size, grid=grid))
    return best[1]


def _library():
    lib = kernel_build.load("simple_pir_matmul")
    if lib.she_simple_pir_matmul.argtypes is None:
        lib.she_simple_pir_matmul.argtypes = _ARGS
        lib.she_simple_pir_matmul.restype = ctypes.c_int
        lib.she_simple_pir_ring.argtypes = [_INT, _INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)]
        lib.she_simple_pir_ring.restype = ctypes.c_int
    return lib


def ring(ja: int, ni: int, kqt: int) -> tuple[int, int]:
    """(stages, dynamic shared memory bytes) of the kernel's launch for a
    group (ja, ni) of launch_plan at kqt request rows, from the built
    library."""
    stages, shared = _INT(), _INT()
    if _library().she_simple_pir_ring(ja, ni, kqt, ctypes.byref(stages), ctypes.byref(shared)):
        raise ValueError(f"no launch of {ni} D planes against {ja} query planes at {kqt} request rows")
    return stages.value, shared.value


def _check(planes: DatabasePlanes, queries: torch.Tensor, bits: int) -> None:
    for name, x, dtype in (("planes", planes.data, torch.uint8), ("queries", queries, torch.int64)):
        if x.dtype != dtype:
            raise TypeError(f"simple_pir_matmul needs {dtype} {name}, got {x.dtype}")
        if x.device.type != "cuda":
            raise ValueError(f"simple_pir_matmul needs CUDA tensors, got {name} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"simple_pir_matmul needs a contiguous, 16-byte aligned {name} tensor")
    if planes.data.device != queries.device:
        raise ValueError(f"planes on {planes.data.device}, queries on {queries.device}")
    if queries.dim() != 2 or queries.shape[1] != planes.columns:
        raise ValueError(f"queries {tuple(queries.shape)} do not fit a database of {planes.columns} columns")
    _check_bits(bits)
    pd, tiles, boxes, tile = planes.data.shape
    if (tiles, boxes * BOX, tile) != (-(-planes.rows // TILE_ROWS), padded_columns(planes.columns), TILE_BYTES) \
            or not 1 <= pd <= 8:
        raise ValueError(f"planes {tuple(planes.data.shape)} are not the tiles of {planes.rows} x {planes.columns}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def simple_pir_matmul_cuda(planes: DatabasePlanes, queries: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel: as simple_pir_matmul_plain, for CUDA tensors only."""
    _check(planes, queries, bits)
    pd, R, kpad, (k, C) = planes.data.shape[0], planes.rows, padded_columns(planes.columns), queries.shape
    out = torch.empty((k, R), dtype=torch.int64, device=queries.device)
    if k == 0 or R == 0:
        return out
    if C == 0:
        return out.zero_()
    pq = plane_count(bits)
    plan = launch_plan(pd, pq, k, R, kpad, _sms(queries.device.index or 0))
    if plan["units"] >= 1 << 31:
        raise ValueError(f"simple_pir_matmul takes fewer than 2^31 units, got {plan['units']}")
    qtiles = torch.empty((plan["chunks"], kpad // BOX, pq * plan["kqt"] * BOX), dtype=torch.uint8,
                         device=queries.device)
    partials = torch.empty((len(plan["groups"]) * plan["segments"], k, R), dtype=torch.int64, device=queries.device)
    err = _library().she_simple_pir_matmul(
        planes.data.data_ptr(), queries.data_ptr(), qtiles.data_ptr(), partials.data_ptr(), out.data_ptr(),
        pd, R, kpad, k, C, bits, plan["kqt"], plan["chunks"], len(plan["groups"]), plan["segment"],
        plan["segments"], plan["grid"], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"she_simple_pir_matmul launch failed with CUDA error {err}")
    if trace.launch("simple_pir_matmul"):
        trace.count_shape("simple_pir_matmul", (tuple(planes.data.shape), R, tuple(queries.shape), bits))
    return out


def simple_pir_matmul(planes: DatabasePlanes, queries: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 [k, R] = (queries [k, C] . D^T) mod 2^b on the queries' device:
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if queries.device.type == "cuda":
        return simple_pir_matmul_cuda(planes, queries.contiguous(), bits)
    if queries.device.type == "cpu":
        return simple_pir_matmul_plain(planes, queries, bits)
    raise ValueError(f"no SimplePIR product for device {queries.device}")
