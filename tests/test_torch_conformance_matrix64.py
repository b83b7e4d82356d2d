"""test_torch_conformance_matrix.py's matrix at 64-bit scalars: every
predefined parameter set (17 combos, 14 at production N), on the CPU on
the default route and, at insecure_n_512_logq_4x60_logt_20, on the matrix
route too; the `gpu` cases under both routes on the card."""

import pytest

from test_torch_conformance_matrix import (
    ALL_COMBOS,
    ROTATION_COMBOS,
    card,
    card_cases,
    case_ids,
    combos,
    cpu_cases,
    one_torch_thread,  # noqa: F401  (the autouse fixture, for this file's tests too)
    op_battery,
    run_rotation,
    serialization_roundtrips,
    set_route,
)

BITS = 64


def test_combo_counts():
    assert len(combos(ALL_COMBOS, BITS)) == 17 and len(combos(ROTATION_COMBOS, BITS)) == 14
    assert [c[2] for c in cpu_cases(ALL_COMBOS, BITS)].count("mxu") == 1


@pytest.mark.parametrize("name,bits,route", cpu_cases(ALL_COMBOS, BITS), ids=case_ids(cpu_cases(ALL_COMBOS, BITS)))
def test_scheme_op_battery(monkeypatch, name, bits, route):
    set_route(monkeypatch, route)
    op_battery(name, bits, "cpu")


@pytest.mark.parametrize("name,bits,route", cpu_cases(ALL_COMBOS, BITS), ids=case_ids(cpu_cases(ALL_COMBOS, BITS)))
def test_serialization_roundtrips(monkeypatch, name, bits, route):
    set_route(monkeypatch, route)
    serialization_roundtrips(name, bits, "cpu")


@pytest.mark.parametrize("name,bits", combos(ROTATION_COMBOS, BITS), ids=case_ids(combos(ROTATION_COMBOS, BITS)))
def test_rotation_and_relinearization_at_production_n(monkeypatch, name, bits):
    set_route(monkeypatch, "kernel")
    run_rotation(name, bits, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ALL_COMBOS, BITS), ids=case_ids(card_cases(ALL_COMBOS, BITS)))
def test_scheme_op_battery_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    op_battery(name, bits, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ALL_COMBOS, BITS), ids=case_ids(card_cases(ALL_COMBOS, BITS)))
def test_serialization_roundtrips_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    serialization_roundtrips(name, bits, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,bits,route", card_cases(ROTATION_COMBOS, BITS), ids=case_ids(card_cases(ROTATION_COMBOS, BITS)))
def test_rotation_and_relinearization_on_card(monkeypatch, name, bits, route):
    device = card()
    set_route(monkeypatch, route)
    run_rotation(name, bits, device)
