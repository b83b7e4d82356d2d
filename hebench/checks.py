"""The comparison that decides `correct`, and its control.

The answers of a sample of the window's batches, drawn from the seed, are
decrypted by the plain reference (reference/bfv.py) with the secret the
benchmark drew, and judged by what the protocol says they hold
(reference/pir.py, through the server kind's `judge`). Two numbers are
compared, each with its limit:

- wrong: answers that do not hold what they should; limit 0.
- noise_share: the largest noise of any sampled answer, as a share of
  q / (2 t), the most an answer can carry and still decrypt; its limit
  sits between what sound runs read and what the control reads
  (the configuration's `limits`).

The control keeps each answer's residues at the next lower word width than
the configuration's scalars (64 -> 32 bits, 32 -> 16 bits: the low bits of
each residue rounded away), the step a change that narrows the answers'
words would take.
"""

from __future__ import annotations

import torch

from hebench.reference import bfv as refbfv

WRONG_LIMIT = 0


def answer_tensor(responses: list) -> torch.Tensor:
    """int64 [B, R, 2, N]: every reply ciphertext (R = query indices x
    chunks) of every PIR answer, each over one modulus."""
    return torch.stack([
        torch.stack([ct.stacked()[:, 0] for reply in r.ciphertexts for ct in reply]) for r in responses
    ])


def control(answers: torch.Tensor, q: int, scalar_bits: int) -> torch.Tensor:
    """The answers' residues (< q) rounded to scalar_bits / 2 significant bits."""
    drop = q.bit_length() - scalar_bits // 2
    if drop <= 0:
        return answers
    half = 1 << (drop - 1)
    return torch.remainder(((answers + half) >> drop) << drop, q)


def control_patch(scalar_bits: int):
    """A `patch` for harness.run_cell that puts the control in the
    program's place: every answer the served cell produces is rounded as
    `control` rounds it, where it is produced."""

    def patch(served) -> None:
        serve = served.serve

        def rounded(queries, on_stage=None):
            responses = serve(queries, on_stage)
            for response in responses:
                for reply in response.ciphertexts:
                    for ct in reply:
                        for poly in ct.polys:
                            poly.data.copy_(control(poly.data, served.q, scalar_bits))
            return responses

        served.serve = rounded

    return patch


def judge(served, sample: list, limits: dict, device=None, scalar_bits: int | None = None) -> dict:
    """sample: (pool index, answer tensor [B, R, 2, N]) pairs. Returns the
    numbers compared with their limits, and the count checked. With
    `scalar_bits`, judges the control's answers instead."""
    device = device or sample[0][1].device
    secret = refbfv.ternary_secret(served.secret, served.degree)
    matrix = refbfv.negacyclic_matrix(secret, device)
    q, t = served.q, served.t
    wrong = checked = 0
    share = 0.0
    for pool_index, answers in sample:
        if scalar_bits is not None:
            answers = control(answers, q, scalar_bits)
        b, r, _, n = answers.shape
        flat = answers.reshape(b * r, 2, n).to(device)
        v = refbfv.dot_with_secret(flat[:, 0], flat[:, 1], matrix, q)
        plain, noise = refbfv.decrypt(v, q, t)
        share = max(share, refbfv.noise_share(noise, q, t))
        verdicts = served.judge(pool_index, plain.reshape(b, r, n))
        wrong += sum(not ok for ok in verdicts)
        checked += len(verdicts)
    return dict(
        checked=checked,
        numbers={
            "wrong": {"value": wrong, "limit": WRONG_LIMIT},
            "noise_share": {"value": share, "limit": limits["noise_share"]},
        },
    )


def passes(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
