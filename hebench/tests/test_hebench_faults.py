"""`correct` comes out false under the control and under each fault a PIR
cell on one card can have, planted in the timed path of a whole run
(the look for a card skipped, tiny cells on the CPU)."""

from __future__ import annotations

import time

import pytest
import torch

from hebench import checks, harness
from hebench.tests.conftest import TINY_SEED

CELLS = ["keyword_tiny.b4", "mulpir_tiny.b4"]


def run(root, cell, patch=None):
    return harness.run_cell(root, cell, TINY_SEED, 0.3, False, "cpu", time.perf_counter(), patch=patch)[0]


def wrap(transform):
    """A patch that passes every batch's answers through transform(served,
    queries, responses)."""

    def patch(served):
        serve = served.serve

        def broken(queries, on_stage=None):
            return transform(served, queries, serve(queries, on_stage))

        served.serve = broken

    return patch


def answers_unchanged(served, queries, responses):
    """The state returned unchanged: each answer is its query's own
    ciphertext, on the answer's modulus."""
    for query, response in zip(queries, responses):
        source = query.ciphertexts[0]
        for reply in response.ciphertexts:
            for ct in reply:
                for poly, src in zip(ct.polys, source.polys):
                    poly.data.copy_(src.data[..., :1, :])
    return responses


def half_left_out(served, queries, responses):
    """Half of the batch left out: the first half served, its answers sent
    again for the rest."""
    half = responses[: len(responses) // 2]
    return half + half


def one_answer_altered(served, queries, responses):
    """An answer altered where it is produced: one coefficient of the
    first answer's c0 moved by a third of q."""
    poly = responses[0].ciphertexts[0][0].polys[0]
    poly.data[..., 0] = torch.remainder(poly.data[..., 0] + served.q // 3, served.q)
    return responses


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = run(tiny_root, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    bits = 32 if cell.startswith("keyword") else 64
    result = run(tiny_root, cell, checks.control_patch(bits))
    assert not result["correct"], result["checks"]
    assert result["checks"]["noise_share"]["value"] > result["checks"]["noise_share"]["limit"]


@pytest.mark.parametrize("fault", [answers_unchanged, half_left_out, one_answer_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    result = run(tiny_root, cell, wrap(fault))
    assert not result["correct"], result["checks"]
