"""chip_smoke.py's phase selection, its cells (the mesh phase's too), its
table of served int8 dim-0 shapes and its byte bounds, on the CPU: the script is imported
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


def test_only_key_switch_selects_the_key_switch_cells():
    assert chip_smoke.parse_args(["--only", "key_switch"]).only == "key_switch"


def test_only_behz_selects_the_behz_cells():
    assert chip_smoke.parse_args(["--only", "behz"]).only == "behz"


def test_only_dim0_mac_selects_the_mac_and_leaf_cells():
    assert chip_smoke.parse_args(["--only", "dim0_mac"]).only == "dim0_mac"


def test_only_ntt_selects_the_ntt_cells():
    """--only ntt serves the w32 and w64 cells (PATHS) and times the
    32-bit route at the keyword cell's widest shape, [128, 128, 2, 3,
    4096] on its three key-switching moduli, without serving that cell."""
    assert chip_smoke.parse_args(["--only", "ntt"]).only == "ntt"
    assert set(chip_smoke.PATHS) == {"w32", "w64"}
    keys = chip_smoke.keyword_widest_ntt_keys()
    assert sorted(k.name for k in keys) == sorted(chip_smoke.NTT_KERNELS)
    for key, launches in keys.items():
        assert key.shape == (128, 128, 2, 3, 4096) and key.block is None and launches == 0
        assert len(key.moduli) == 3 and max(key.moduli) < 1 << 30


def test_dim0_mac_byte_bounds():
    """At the w64 cell A [4, 11, 3, 8192], B [11, 256, 3, 8192] and the
    output [4, 256, 3, 8192] are 8.7, 553.6 and 201.3 MB: 0.228 ms at 3.35
    TB/s; a broadcast axis of an operand is read once, and PNNS's
    permuted diagonals count as many words as the packed ones; the leaves'
    level moves what expand_combine moves."""
    from she_tpu_torch.ops.dim0_mac_cuda import MacKey
    from she_tpu_torch.ops.key_switch_cuda import KsKey

    n, L = 8192, 3
    w64 = MacKey((4, 11, L, n), (11 * L * n, L * n, n, 1), (11, 256, L, n), (256 * L * n, L * n, n, 1), (1, 2, 3))
    assert chip_smoke.mac_bytes(w64) == 8 * L * n * (44 + 11 * 256 + 4 * 256)
    assert 1e3 * chip_smoke.mac_bytes(w64) / chip_smoke.HBM_BYTES_PER_S == pytest.approx(0.228, abs=5e-4)
    pnns = MacKey((11, 1, 12, 2, 4096), (12 * 8192, 8192, 8192, 4096, 1), (12, 16, 2, 2, 4096),
                  (16 * 2 * 8192, 2 * 8192, 8192, 4096, 1), (1, 2))
    assert chip_smoke.mac_bytes(pnns) == 8 * 2 * 4096 * (11 * 12 + 12 * 32 + 11 * 32)
    broadcast = MacKey((5, 7, 2, 8), (0, 16, 8, 1), (7, 6, 2, 8), (16, 0, 8, 1), (1, 2))
    assert chip_smoke.mac_bytes(broadcast) == 8 * 16 * (7 + 7 + 30)
    unit = 128 * 128 * 4096 * 8
    assert chip_smoke.ks_bytes(KsKey("expand_leaves", (128, 128, 2, 2, 4096), (1, 2), (64, 255, 256, False))) == 16 * unit


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
    covers all seven sources the package builds: the NTT's two kernels,
    dim0_int8, simple_pir_matmul, ntt_mxu, the key switch's four,
    expand_combine's leaf instance, the mod switch and the fused route's
    pair, the BEHZ product's three and dim0_mac."""
    from she_tpu_torch.ops import kernel_build

    assert set(chip_smoke.KERNEL_SOURCES) == {"ntt_forward", "ntt_inverse", "dim0_int8", "simple_pir_matmul",
                                              "ntt_mxu", "ks_digits", "ks_mac", "ks_finish", "expand_combine",
                                              "expand_leaves", "mod_switch", "ks_digits_ntt_mac", "ks_intt_finish",
                                              "behz_lift", "behz_tensor_mac", "behz_floor", "dim0_mac"}
    assert set(chip_smoke.KERNEL_SOURCES.values()) == {
        f"she_tpu_torch/csrc/{source}" for source in kernel_build.SOURCES.values()}
    assert len(kernel_build.SOURCES) == 7
    assert set(chip_smoke.PTXAS_LABELS) == set(chip_smoke.KS_KERNELS) | {"dim0_mac"}
    assert set(chip_smoke.KS_REPLACES) == set(chip_smoke.KS_KERNELS) == set(chip_smoke.KS_LIBRARY)
    assert set(chip_smoke.BEHZ_REPLACES) == set(chip_smoke.BEHZ_KERNELS)


def test_key_switch_byte_bounds():
    """At the keyword cell's widest expansion level (16,384 target
    polynomials, L_t = 2, L_ks = 3, N = 4096; U = 16,384 x 4096 x 8 bytes)
    ks_digits moves 8 U, ks_mac 12 U and the key, ks_finish 12 U (c0 read,
    c1 not) and expand_combine 16 U; a relinearization's ks_finish reads c1
    too."""
    from she_tpu_torch.ops.key_switch_cuda import KsKey

    moduli, unit = (1, 2, 3), 128 * 128 * 4096 * 8
    assert chip_smoke.ks_bytes(KsKey("ks_digits", (128, 128, 2, 4096), moduli, (3, 511))) == 8 * unit
    key_bytes = 2 * 2 * 3 * 4096 * 8
    assert chip_smoke.ks_bytes(KsKey("ks_mac", (128, 128, 2, 3, 4096), moduli, ())) == 12 * unit + key_bytes
    galois, relin = (3, True, False, 511), (None, True, True, None)
    assert chip_smoke.ks_bytes(KsKey("ks_finish", (128, 128, 2, 3, 4096), moduli, galois)) == 12 * unit
    assert chip_smoke.ks_bytes(KsKey("ks_finish", (128, 128, 2, 3, 4096), moduli, relin)) == 14 * unit
    assert chip_smoke.ks_bytes(KsKey("expand_combine", (128, 128, 2, 2, 4096), moduli[:2], (64, 511))) == 16 * unit
    assert 1e3 * 8 * unit / chip_smoke.HBM_BYTES_PER_S == pytest.approx(1.282, abs=5e-4)


def test_fused_key_switch_byte_bounds():
    """The fused pair at the keyword cell's widest level moves 14 U (U as
    above) and the 32-bit key rows: ks_digits_ntt_mac reads c1 (2 U) and
    writes the products as 32-bit words (3 U), ks_intt_finish reads them
    (3 U) and c0 (2 U) and writes 4 U; a relinearization's reads c1 too.
    The split chain moved 56 U."""
    from she_tpu_torch.ops.key_switch_cuda import KsKey

    moduli, unit = (1, 2, 3), 128 * 128 * 4096 * 8
    key_bytes = 2 * 2 * 3 * 4096 * 4
    mac = chip_smoke.ks_bytes(KsKey("ks_digits_ntt_mac", (128, 128, 2, 4096), moduli, (33, 257)))
    assert mac == 5 * unit + key_bytes
    galois, relin = (33, True, False, 257), (None, True, True, None)
    finish = chip_smoke.ks_bytes(KsKey("ks_intt_finish", (128, 128, 2, 3, 4096), moduli, galois))
    assert finish == 9 * unit
    assert chip_smoke.ks_bytes(KsKey("ks_intt_finish", (128, 128, 2, 3, 4096), moduli, relin)) == 11 * unit
    assert 1e3 * (mac + finish - key_bytes) / chip_smoke.HBM_BYTES_PER_S == pytest.approx(2.2436, abs=5e-4)


def test_mod_switch_byte_bounds():
    """Each input row read once, each output row written once: the w64
    cell's [128, 2, 2, 8192] -> one modulus moves 50.3 MB (0.0150 ms at
    3.35 TB/s), w32's and keyword's [128, 2, 2, 4096] 25.2 MB (0.0075 ms),
    PNNS's [1, 16, 2, 2, 4096] 3.1 MB."""
    from she_tpu_torch.ops.key_switch_cuda import KsKey

    def bound(shape, target=1):
        key = KsKey("mod_switch", shape, (1, 2, 3)[: shape[-2]], (target, ()))
        return chip_smoke.ks_bytes(key), 1e3 * chip_smoke.ks_bytes(key) / chip_smoke.HBM_BYTES_PER_S

    assert bound((128, 2, 2, 8192))[0] == 8 * 256 * 8192 * 3
    assert bound((128, 2, 2, 8192))[1] == pytest.approx(0.0150, abs=5e-5)
    assert bound((128, 2, 2, 4096))[1] == pytest.approx(0.0075, abs=5e-5)
    assert bound((1, 16, 2, 2, 4096))[0] == pytest.approx(3.1e6, rel=0.02)
    assert bound((4, 2, 3, 8192), 2)[0] == 8 * 8 * 8192 * 5


def test_only_mod_switch_selects_the_mod_switch_cells():
    assert chip_smoke.parse_args(["--only", "mod_switch"]).only == "mod_switch"


def test_behz_byte_bounds():
    """At the keyword cell (128 queries, K = 31 pairs, L = 2, L_bsk = 3,
    N = 4096) the lift of both sides moves 3.641 GB (1.087 ms at 3.35
    TB/s), the MAC 2.663 GB and the floor 0.088 GB; at w64 (K = 4,
    N = 8192) 0.940, 0.797 and 0.176 GB."""
    from she_tpu_torch.ops.behz_cuda import BehzKey

    q, bsk = (1, 2), (3, 4, 5)
    ext = q + bsk
    for (K, n), (lift, mac, floor) in (((31, 4096), (3.641, 2.663, 0.088)), ((4, 8192), (0.940, 0.797, 0.176))):
        both_sides = 2 * chip_smoke.behz_bytes(BehzKey("behz_lift", (128, K, 2, 2, n), (q, bsk), (1 << 16, ())))
        assert both_sides / 1e9 == pytest.approx(lift, abs=5e-4)
        assert chip_smoke.behz_bytes(BehzKey("behz_tensor_mac", (128, K, 2, 5, n), ext, (17,))) / 1e9 == pytest.approx(
            mac, abs=5e-4)
        assert chip_smoke.behz_bytes(BehzKey("behz_floor", (128, 3, 7, n), (q, bsk), (1, ()))) / 1e9 == pytest.approx(
            floor, abs=5e-4)
    keyword_lift = 2 * chip_smoke.behz_bytes(BehzKey("behz_lift", (128, 31, 2, 2, 4096), (q, bsk), (1 << 16, ())))
    assert 1e3 * keyword_lift / chip_smoke.HBM_BYTES_PER_S == pytest.approx(1.087, abs=5e-4)


def test_strided_like_keeps_the_layout():
    """A launch's input made again with its recorded strides (a transposed
    view, a block of columns) holds the same values at the same strides."""
    import torch

    base = torch.arange(2 * 3 * 4 * 8).reshape(2, 3, 4, 8)
    for view in (base.transpose(0, 1), base[..., 4:], base.transpose(0, 1)[:, :, 1:3]):
        again = chip_smoke.strided_like(view.contiguous(), view.stride())
        assert again.stride() == view.stride() and torch.equal(again, view)


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
    dim-0 kernel's by (digits shape, query shape, moduli), the key switch's
    by key_switch_cuda.KsKey."""
    import json
    from collections import Counter

    from she_tpu_torch.ops.ntt_cuda import LaunchKey

    from she_tpu_torch.ops.behz_cuda import BehzKey
    from she_tpu_torch.ops.key_switch_cuda import KsKey

    path = dict(launch_shapes=Counter({LaunchKey("ntt_forward", (3, 2048), (17, 97), (4096, 2, 1)): 2}),
                dim0_shapes=Counter({((2, 8, 4, 32), (8, 4, 2, 8), (17, 97)): 1}),
                ks_shapes=Counter({KsKey("ks_digits", (4, 1, 8), (17, 97), (3, None)): 5}),
                behz_shapes=Counter({BehzKey("behz_floor", (4, 3, 8), ((17,), (97, 113)), (5, (24, 8, 1))): 2}))
    chip_smoke.launch_rows(path)
    assert json.loads(json.dumps(path)) == dict(
        launch_shapes=[dict(name="ntt_forward", shape=[3, 2048], moduli=[17, 97], block=[4096, 2, 1], launches=2)],
        dim0_shapes=[dict(digits_shape=[2, 8, 4, 32], query_shape=[8, 4, 2, 8], moduli=[17, 97], launches=1)],
        ks_shapes=[dict(name="ks_digits", shape=[4, 1, 8], moduli=[17, 97], variant=[3, None], launches=5)],
        behz_shapes=[dict(name="behz_floor", shape=[4, 3, 8], moduli=[[17], [97, 113]], variant=[5, [24, 8, 1]],
                          launches=2)])
