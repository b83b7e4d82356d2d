"""Each stage's byte floor, against a hand count: at the keyword
configuration, and at an index MulPIR shape with 64-bit words (N = 8192,
3 x 55-bit moduli, dims (11, 4): 1,000,000 x 1 B) that pins the
arithmetic a 64-bit configuration would read."""

from __future__ import annotations

import json

import pytest

from hebench import floor
from hebench.tests.conftest import REPO


def shape(name: str) -> dict:
    return json.loads((REPO / "hebench" / "configs" / f"{name}.json").read_text())["shape"]


def test_keyword_floor():
    got = floor.floor_bytes(shape("keyword_1m_x_1B_w32"), 128)
    # P = 4096 (27 + 28) / 8 = 28,160; K = 2 x 2 x 4096 (55 + 28) / 8 = 169,984; 8 levels
    assert got["expand"] == 128 * 1 * 2 * 28_160 + 8 * 169_984 + 128 * 256 * 2 * 28_160 == 1_854_062_592
    assert got["dim0"] == 6014 * 28_160 == 169_354_240
    assert got["behz"] == 169_984
    assert got["mod_switch"] == 128 * 2 * 1 * 2 * 4096 * 27 / 8 == 7_077_888
    assert got["total"] == 2_030_664_704


W64_SHAPE = {"degree": 8192, "ciphertext_moduli_bits": [55, 55], "key_switch_modulus_bits": 55, "dimensions": [11, 4],
             "indices": 1, "chunks": 1, "plaintexts": 44, "query_ciphertexts": 1, "expanded_per_query": 15}


@pytest.mark.parametrize("batch", [128, 512])
def test_w64_floor(batch):
    got = floor.floor_bytes(W64_SHAPE, batch)
    # P = 8192 x 110 / 8 = 112,640; K = 2 x 2 x 8192 x 165 / 8 = 675,840; 4 levels
    assert got["expand"] == batch * 2 * 112_640 + 4 * 675_840 + batch * 15 * 2 * 112_640
    assert got["dim0"] == 44 * 112_640 == 4_956_160
    assert got["behz"] == 675_840
    assert got["mod_switch"] == batch * 2 * 8192 * 55 / 8
    if batch == 128:
        assert got["expand"] == 464_076_800
        assert got["mod_switch"] == 14_417_920
        assert got["total"] == 484_126_720
    else:
        assert got["expand"] == 1_848_197_120
        assert got["mod_switch"] == 57_671_680
        assert got["total"] == 1_911_500_800

