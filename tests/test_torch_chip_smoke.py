"""chip_smoke.py's phase selection, its cells (the mesh phase's too) and
its table of served int8 dim-0 shapes, on the CPU: the script is imported
(its top level needs only the standard library) and its arguments
parsed; nothing runs on a card."""

import pytest

import chip_smoke


def test_default_run_selects_every_phase():
    """The default run drives every serving phase (run() iterates
    serving_phases after the kernel phase, then runs the CLI phase; --only
    dim0 and --only simple_pir return first)."""
    args = chip_smoke.parse_args([])
    assert (args.only, args.batches) == (None, 3)
    names = [name for name, _ in chip_smoke.serving_phases(args)]
    assert names == ["w32", "w64", "keyword", "keyword_large", "spir",
                     "pnns_4096x128_w32_b16", "pnns_4096x128_w64_b16", "simplepir_256k_x_4KiB_b32", "mesh",
                     "ntt_mxu"]
    assert names[:2] == list(chip_smoke.PATHS)
    assert names[-5:-3] == list(chip_smoke.PNNS_PATHS)
    assert names[-3] == chip_smoke.SIMPLE_PIR_CELL


def test_pnns_cells():
    """The PNNS phases serve bench.py's bench_pnns and bench_pnns_w64: a
    4,096 x 128 database at n_4096_logq_27_28_28_logt_17, 32- and 64-bit
    scalars, 16 queries a batch."""
    assert chip_smoke.PNNS_PATHS == {
        "pnns_4096x128_w32_b16": ("n_4096_logq_27_28_28_logt_17", 32),
        "pnns_4096x128_w64_b16": ("n_4096_logq_27_28_28_logt_17", 64),
    }
    assert (chip_smoke.PNNS_DB, chip_smoke.PNNS_BATCH) == ((4096, 128), 16)


def test_only_dim0_selects_the_dim0_cases():
    assert chip_smoke.parse_args(["--only", "dim0"]).only == "dim0"


def test_only_simple_pir_selects_the_simple_pir_cell():
    assert chip_smoke.parse_args(["--only", "simple_pir"]).only == "simple_pir"


def test_only_mesh_selects_the_mesh_phase():
    assert chip_smoke.parse_args(["--only", "mesh"]).only == "mesh"


def test_only_ntt_mxu_selects_the_matrix_ntt_phase():
    assert chip_smoke.parse_args(["--only", "ntt_mxu"]).only == "ntt_mxu"


def test_ntt_mxu_cells():
    """The matrix NTT serves the w32 cell for --batches batches and one
    batch of the w64 cell (8 digits), and checks its kernel at 60-bit
    moduli (9 digits), [2, 3, 8192]."""
    from she_tpu_torch import params
    from she_tpu_torch.ops import digits

    assert chip_smoke.NTT_MXU_PATHS == {"ntt_mxu_w32": ("w32", None), "ntt_mxu_w64": ("w64", 1)}
    name, batch, degree = chip_smoke.NTT_MXU_D9
    moduli = params.from_predefined(name, scalar_bits=64).coefficient_moduli
    assert (name, batch, degree, len(moduli), digits.digit_count(moduli)) == (
        "n_8192_logq_28_60_60_logt_20", (2,), 8192, 3, 9)


def test_kernels_line_names_every_kernel():
    """The kernels line (run() checks its names against KERNEL_SOURCES)
    covers all four sources the package builds: the NTT's two kernels,
    dim0_int8, simple_pir_matmul and ntt_mxu."""
    from she_tpu_torch.ops import kernel_build

    assert set(chip_smoke.KERNEL_SOURCES) == {"ntt_forward", "ntt_inverse", "dim0_int8", "simple_pir_matmul",
                                              "ntt_mxu"}
    assert set(chip_smoke.KERNEL_SOURCES.values()) == {
        f"she_tpu_torch/csrc/{source}" for source in kernel_build.SOURCES.values()}
    assert len(kernel_build.SOURCES) == 4


def test_mxu_bound():
    """The fused kernel's bounds for a direction: bytes bind the w32 cell's
    widest launch, int8 operations the w64 cell's; the bound is the larger
    of the two, and no count of the build's instructions enters it."""
    w32 = chip_smoke.mxu_bound((32, 128, 2, 3, 4096), (1, 2, 3), 4)
    numel = 32 * 128 * 2 * 3 * 4096
    assert w32["bytes"] == 2 * numel * 8 + 3 * 4 * (64 * 64 + 64 * 64) + 3 * 64 * 64 * 8
    assert w32["operations"] == 2 * 16 * (64 + 64) * numel and w32["bound_by"] == "bytes"
    assert w32["bound_ms"] == w32["bytes_ms"] == 1e3 * w32["bytes"] / chip_smoke.HBM_BYTES_PER_S
    w64 = chip_smoke.mxu_bound((7, 128, 2, 3, 8192), (1, 2, 3), 8)
    assert w64["bound_by"] == "operations" and w64["operations"] == 2 * 64 * (128 + 64) * 7 * 128 * 2 * 3 * 8192
    assert w64["bound_ms"] == w64["operations_ms"] == 1e3 * w64["operations"] / chip_smoke.INT8_OPS_PER_S
    assert set(w64) == {"bytes", "operations", "bytes_ms", "operations_ms", "bound_ms", "bound_by"}


def test_sass_integer_opcodes():
    """The build's integer SASS is counted by pipe: the multiplies on the
    FMA pipe, the other CUDA-core integer opcodes on the ALU pipe, and no
    memory, control, uniform-datapath or tensor instruction; its issue time
    is the larger of each pipe over 64 lanes an SM a clock and both over
    the 128 an SM issues."""
    for op in ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "SEL", "ISETP"):
        assert op in chip_smoke.ALU_INT_OPCODES and op not in chip_smoke.FMA_INT_OPCODES
    assert "IMAD" in chip_smoke.FMA_INT_OPCODES and "IMAD" not in chip_smoke.ALU_INT_OPCODES
    for op in ("LDG", "STG", "LDS", "STS", "BAR", "BRA", "HGMMA", "UIMAD", "UMOV", "FFMA"):
        assert op not in chip_smoke.ALU_INT_OPCODES | chip_smoke.FMA_INT_OPCODES
    clock = 1e3 / (132 * 1.98e9)
    assert chip_smoke.sass_issue_ms({"alu": 100, "fma": 100}, 1) == 200 / 128 * clock
    assert chip_smoke.sass_issue_ms({"alu": 150, "fma": 50}, 2) == 2 * 150 / 64 * clock
    assert chip_smoke.sass_issue_ms({"alu": 10, "fma": 90}, 1) == 90 / 64 * clock


def test_mesh_cells():
    """The mesh phase: (a) the 1M x 1 B main path and (b) 2,097,152 x 1 B,
    whose dims (32, 32) a db axis of 2 divides (the 1M database's (55, 9)
    and the keyword cell's (97, 31) are odd), 128 queries each, 64 a rank;
    (c) at 64-bit scalars on random residues with d0 = 32; (e) limb
    NTTs of 4 moduli, which 2 and 4 ranks divide."""
    assert chip_smoke.MESH_BATCH == chip_smoke.BATCH == 128
    assert (chip_smoke.MESH_TWO_AXIS_ENTRIES, chip_smoke.MESH_TWO_AXIS_DIMS) == (1 << 21, (32, 32))
    assert chip_smoke.MESH_PSUM_W64 == (4, 32, 16, 8192)
    assert chip_smoke.MESH_LIMB_MODULI % 4 == 0
    assert chip_smoke.MESH_PATHS == ("mesh_batch_w32", "mesh_two_axis_w32", "mesh_pnns_w32", "mesh_dim0_psum",
                                     "mesh_sharded")


@pytest.mark.parametrize("name", ["mesh_world2", "mesh_world4"])
def test_mesh_rank_functions_pickle_by_name(name):
    """Spawned ranks get their function by module and name, so it must be
    a module-level function of the script."""
    import pickle

    fn = getattr(chip_smoke, name)
    assert pickle.loads(pickle.dumps(fn)) is fn


def test_simple_pir_cell():
    """1 GiB of 4 KiB entries (the SimplePIR paper's 1 GB database), 32
    queries a batch, at p = 9 (she_tpu's tool default), b = 32, n = 2048;
    the CLI phase runs the tool at its defaults (p = 9: 3,641 rows)."""
    import math

    assert chip_smoke.SIMPLE_PIR_DB == (262_144, 4096)
    assert math.prod(chip_smoke.SIMPLE_PIR_DB) == 1 << 30
    assert (chip_smoke.SIMPLE_PIR_PARAMS, chip_smoke.SIMPLE_PIR_BATCH) == ((9, 32, 2048), 32)
    assert chip_smoke.CLI_SIMPLE_PIR_ROWS == -(-8 * chip_smoke.CLI_SIMPLE_PIR_DB[1] // 9)


@pytest.mark.parametrize("argv", [["--only", "keyword"], ["--only"], ["--batches", "2"], ["--only", "parallel"]])
def test_refused_arguments(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_served_dim0_shapes():
    """(C, d0, P, N) of every served int8 dim-0 launch: the keyword cell
    (dims 97 x 31, 2 polynomials a query, 128 queries), the w32 index cell
    (55 x 9), the two-plaintext keyword buckets (228 x 21, 32 queries),
    and the mesh phase's ranks: the w32 cell at 64 queries a rank, the
    two-axis cell's d0 slice of 16 of 32 hyper-rows (and of 8 at S = 4)."""
    assert chip_smoke.DIM0_SERVED_SHAPES == {
        "keyword": (31, 97, 256, 4096),
        "w32": (9, 55, 256, 4096),
        "keyword_large": (21, 228, 64, 4096),
        "mesh_batch": (9, 55, 128, 4096),
        "mesh_two_axis": (32, 16, 128, 4096),
        "mesh_psum_S4": (32, 8, 128, 4096),
    }
    assert chip_smoke.DIM0_W64_CHECK == (4, 11, 256, 8192)


def test_launch_rows():
    """The paths' launch counters as the JSON rows of --json-out: the NTT's
    by ntt_cuda.LaunchKey (a sharded NTT's block tables too), the int8
    dim-0 kernel's by (digits shape, query shape, moduli)."""
    import json
    from collections import Counter

    from she_tpu_torch.ops.ntt_cuda import LaunchKey

    path = dict(launch_shapes=Counter({LaunchKey("ntt_forward", (3, 2048), (17, 97), (4096, 2, 1)): 2}),
                dim0_shapes=Counter({((2, 8, 4, 32), (8, 4, 2, 8), (17, 97)): 1}))
    chip_smoke.launch_rows(path)
    assert json.loads(json.dumps(path)) == dict(
        launch_shapes=[dict(name="ntt_forward", shape=[3, 2048], moduli=[17, 97], block=[4096, 2, 1], launches=2)],
        dim0_shapes=[dict(digits_shape=[2, 8, 4, 32], query_shape=[8, 4, 2, 8], moduli=[17, 97], launches=1)])
