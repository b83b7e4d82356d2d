"""chip_smoke.py's phase selection and its table of served int8 dim-0
shapes, on the CPU: the script is imported (its top level needs only the
standard library) and its arguments parsed; nothing runs on a card."""

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
                     "pnns_4096x128_w32_b16", "pnns_4096x128_w64_b16", "simplepir_256k_x_4KiB_b32"]
    assert names[:2] == list(chip_smoke.PATHS)
    assert names[-3:-1] == list(chip_smoke.PNNS_PATHS)
    assert names[-1] == chip_smoke.SIMPLE_PIR_CELL


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


def test_simple_pir_cell():
    """1 GiB of 4 KiB entries (the SimplePIR paper's 1 GB database), 32
    queries a batch, at p = 9 (she_tpu's tool default), b = 32, n = 2048;
    the CLI phase runs the tool at its defaults (p = 9: 3,641 rows)."""
    import math

    assert chip_smoke.SIMPLE_PIR_DB == (262_144, 4096)
    assert math.prod(chip_smoke.SIMPLE_PIR_DB) == 1 << 30
    assert (chip_smoke.SIMPLE_PIR_PARAMS, chip_smoke.SIMPLE_PIR_BATCH) == ((9, 32, 2048), 32)
    assert chip_smoke.CLI_SIMPLE_PIR_ROWS == -(-8 * chip_smoke.CLI_SIMPLE_PIR_DB[1] // 9)


@pytest.mark.parametrize("argv", [["--only", "keyword"], ["--only"], ["--batches", "2"]])
def test_refused_arguments(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_served_dim0_shapes():
    """(C, d0, P, N) of every served int8 dim-0 launch: the keyword cell
    (dims 97 x 31, 2 polynomials a query, 128 queries), the w32 index cell
    (55 x 9) and the two-plaintext keyword buckets (228 x 21, 32 queries)."""
    assert chip_smoke.DIM0_SERVED_SHAPES == {
        "keyword": (31, 97, 256, 4096),
        "w32": (9, 55, 256, 4096),
        "keyword_large": (21, 228, 64, 4096),
    }
    assert chip_smoke.DIM0_W64_CHECK == (4, 11, 256, 8192)
