"""SimplePIR's response product: the kernel of csrc/simple_pir_matmul.cu
and its plain PyTorch version.

out[k, r] = sum_c D[r, c] * Q[k, c] mod 2^b, for the database D [R, C]
(entries below 2^p) and k request rows Q [k, C] of b-bit words. It
replaces she_tpu/pir/simple_pir.py:283, `self.database @ requests.T` on
numpy object arrays (a host product, not a Pallas kernel): PyTorch has no
integer matrix product on CUDA.

Both versions take D as ceil(p / 8) byte planes (`database_planes`, made
once when a server is built, in the kernel's tiles of 16 rows x 64
columns) and Q as ceil(b / 8), and add the plane products Q_j D_i^T
weighted by 2^(8 (i + j)) mod 2^b. The kernel takes them as u8 x u8 ->
int32 tensor-core products over column segments short enough that every
int32 sum is exact; the plain version as one int64 matmul (on the CPU) or
float64 matmul (on the card, exact while 255^2 C < 2^53) per pair.

`simple_pir_matmul` dispatches on the query's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
`launches` counts each launch; `launch_shapes` counts the same launches by
(planes shape, rows, query shape, b), so a run can time each shape it used.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass

import torch

from . import kernel_build

launches = {"simple_pir_matmul": 0}
launch_shapes: Counter = Counter()

PLANE_BITS = 8
TILE_ROWS, TILE_COLUMNS = 16, 64  # the kernel's tile of a plane: one warp's rows, one step's columns
COLUMN_STEP = 256  # C is padded to a multiple: four tiles' loads a step
SEGMENT = 32768  # columns one int32 sum of one product may take: 32,768 * 255^2 < 2^31
ROWS_PER_BLOCK = 128  # 8 warps of 16 rows
PLANE_ROWS_PER_PASS = 16 * TILE_ROWS  # database rows split into planes at a time: whole tiles
MAX_BITS = 62  # the plain version adds two b-bit sums in int64
TARGET_BLOCKS = 8 * 132  # eight blocks for each of the H100's 132 SMs
FLOAT64_EXACT = 1 << 53

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = [_VP] * 5 + [_INT, _INT, _LL, _INT, _LL, _INT, _INT, _INT, _INT, _LL, _INT, _VP]


def plane_count(bits: int) -> int:
    return -(-bits // PLANE_BITS)


def padded_columns(columns: int) -> int:
    return -(-columns // COLUMN_STEP) * COLUMN_STEP


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


@dataclass(frozen=True)
class DatabasePlanes:
    """D's byte planes in the kernel's layout: `data` uint8 [P_D, R16,
    Kpad / 64, 1024], tiles of 16 rows x 64 columns (rows zero-padded to
    R16 * 16, columns to Kpad = padded_columns(C)); in a tile rows 0-7 then
    8-15, each half as 32 runs of 16 bytes, run 4g + t holding columns
    16t..16t+15 of row g (the bytes lane 4g + t of a warp loads)."""

    data: torch.Tensor
    rows: int
    columns: int

    def row_major(self) -> torch.Tensor:
        """uint8 [P_D, R, C]: plane i, entry (r, c) = bits 8i..8i+7 of D[r, c]."""
        pd, r16, k64 = self.data.shape[:3]
        tiles = self.data.view(pd, r16, k64, 2, 8, 4, 16).permute(0, 1, 3, 4, 2, 5, 6)
        return tiles.reshape(pd, r16 * TILE_ROWS, k64 * TILE_COLUMNS)[:, : self.rows, : self.columns]


def database_planes(database: torch.Tensor, plaintext_bits: int) -> DatabasePlanes:
    """int database [R, C] with entries below 2^p -> its ceil(p / 8) byte
    planes in the kernel's tiles (DatabasePlanes), made on the database's
    device, PLANE_ROWS_PER_PASS rows at a time."""
    R, C = database.shape
    pd, r16, kpad = plane_count(plaintext_bits), -(-R // TILE_ROWS), padded_columns(C)
    data = torch.zeros((pd, r16, kpad // TILE_COLUMNS, TILE_ROWS * TILE_COLUMNS), dtype=torch.uint8,
                       device=database.device)
    for r0 in range(0, R, PLANE_ROWS_PER_PASS):
        rows = database[r0 : r0 + PLANE_ROWS_PER_PASS]
        for i in range(pd):
            plane = torch.zeros((-(-rows.shape[0] // TILE_ROWS) * TILE_ROWS, kpad), dtype=torch.uint8,
                                device=database.device)
            plane[: rows.shape[0], :C] = ((rows >> (PLANE_BITS * i)) & 0xFF).to(torch.uint8)
            tiles = plane.view(-1, 2, 8, kpad // TILE_COLUMNS, 4, 16).permute(0, 3, 1, 2, 4, 5)
            t0 = r0 // TILE_ROWS
            data[i, t0 : t0 + tiles.shape[0]] = tiles.reshape(tiles.shape[0], kpad // TILE_COLUMNS, -1)
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


def launch_plan(database_planes: int, query_planes: int, k: int, rows: int, kpad: int) -> dict:
    """The kernel's launch for these sizes: n tiles a block (NT), padded
    request rows (KQ), column segment and segment count (S). A block sums
    the products of two D planes of equal weight in one int32 (where there
    are two planes of each), so its segment is at most SEGMENT / 2 then.
    Segments are halved (rounded up to a column step) while the grid has
    fewer than TARGET_BLOCKS blocks and a segment has 8 column steps or
    more."""
    n_tiles = -(-k // 8)
    nt = 1 if n_tiles == 1 else 2 if n_tiles == 2 or query_planes > 4 else 4
    groups = -(-n_tiles // nt)
    shared = 1 if database_planes < 2 or query_planes < 2 else 2
    segment = min(SEGMENT // shared, kpad)
    row_blocks = -(-rows // ROWS_PER_BLOCK)
    while row_blocks * groups * -(-kpad // segment) < TARGET_BLOCKS and segment >= 8 * COLUMN_STEP:
        segment = padded_columns(segment // 2)
    return dict(nt=nt, kq=groups * nt * 8, segment=segment, segments=-(-kpad // segment))


def _library():
    lib = kernel_build.load("simple_pir_matmul")
    if lib.she_simple_pir_matmul.argtypes is None:
        lib.she_simple_pir_matmul.argtypes = _ARGS
        lib.she_simple_pir_matmul.restype = ctypes.c_int
    return lib


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
    pd, r16, k64, tile = planes.data.shape
    if (r16, k64 * TILE_COLUMNS, tile) != (-(-planes.rows // TILE_ROWS), padded_columns(planes.columns),
                                           TILE_ROWS * TILE_COLUMNS) or not 1 <= pd <= 8:
        raise ValueError(f"planes {tuple(planes.data.shape)} are not the tiles of {planes.rows} x {planes.columns}")


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
    plan = launch_plan(pd, pq, k, R, kpad)
    qplanes = torch.empty((pq, plan["kq"], kpad), dtype=torch.uint8, device=queries.device)
    partials = torch.empty((plan["segments"], plan["kq"], R), dtype=torch.int64, device=queries.device)
    err = _library().she_simple_pir_matmul(
        planes.data.data_ptr(), queries.data_ptr(), qplanes.data_ptr(), partials.data_ptr(), out.data_ptr(),
        pd, R, kpad, k, C, bits, pq, plan["nt"], plan["kq"], plan["segment"], plan["segments"],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"she_simple_pir_matmul launch failed with CUDA error {err}")
    launches["simple_pir_matmul"] += 1
    launch_shapes[(tuple(planes.data.shape), R, tuple(queries.shape), bits)] += 1
    return out


def simple_pir_matmul(planes: DatabasePlanes, queries: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 [k, R] = (queries [k, C] . D^T) mod 2^b on the queries' device:
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if queries.device.type == "cuda":
        return simple_pir_matmul_cuda(planes, queries.contiguous(), bits)
    if queries.device.type == "cpu":
        return simple_pir_matmul_plain(planes, queries, bits)
    raise ValueError(f"no SimplePIR product for device {queries.device}")
