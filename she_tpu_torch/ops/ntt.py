"""Negacyclic NTT over int64 RNS tensors [..., L, N].

Twiddles come from the minimal primitive 2N-th root of unity in the
bit-reversed order of utils/refimpl.ntt_root_tables, exactly as in
she_tpu/ops/ntt.py, so outputs land in the same element order (seeded `a`
polynomials and the processed database are stored in Eval form, so the
order itself must match, not only the multiset of values).

`forward_ntt` / `inverse_ntt` dispatch on the tensor's device: a CPU tensor
takes the plain PyTorch version below, a CUDA tensor the hand-written
kernel of ops/ntt_cuda.py, and anything else raises. The plain version runs
the radix-2 stage order of she_tpu's forward_ntt_arrays /
inverse_ntt_arrays, including the n^-1 fold of inv_final_stage, with every
stage fully reduced (so it needs q < 2^31: a product of residues must fit
int64). `plain_calls_on_cuda` counts plain transforms of CUDA tensors,
which only a comparison against the kernel should make.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils import nt
from ..utils.refimpl import ntt_root_tables
from . import ntt_cuda
from .modarith import add_mod, sub_mod

PLAIN_MAX_MODULUS = 1 << 31

plain_calls_on_cuda = {"forward": 0, "inverse": 0}


@dataclass(frozen=True)
class NttTables:
    """Per-(moduli, degree, device) tables, int64 on the device.

    roots / inv_roots and their Shoup constants floor(w * 2^64 / q) are
    [L, N] (the constants stored as the bit pattern of a u64); the scalars
    q, n^-1 and n^-1 * w^-1 (with Shoup constants) are [L, 1]."""

    degree: int
    moduli: tuple[int, ...]
    roots: torch.Tensor
    roots_shoup: torch.Tensor
    inv_roots: torch.Tensor
    inv_roots_shoup: torch.Tensor
    n_inv: torch.Tensor
    n_inv_shoup: torch.Tensor
    n_inv_w: torch.Tensor
    n_inv_w_shoup: torch.Tensor
    q: torch.Tensor


def shoup64(w: int, q: int) -> int:
    """floor(w * 2^64 / q) for 0 <= w < q."""
    if not 0 <= w < q:
        raise ValueError(f"Shoup constant needs 0 <= w < q, got {w}, {q}")
    return (w << 64) // q


def _u64_tensor(values, device) -> torch.Tensor:
    """Python ints in [0, 2^64) -> int64 tensor holding their bit patterns."""
    arr = np.array(values, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(arr).to(device)


@lru_cache(maxsize=None)
def build_ntt_tables(moduli: tuple[int, ...], degree: int, device: torch.device) -> NttTables:
    rows = {k: [] for k in ("r", "rs", "ir", "irs")}
    scal = {k: [] for k in ("ni", "nis", "nw", "nws", "q")}
    for q in moduli:
        if not nt.is_ntt_modulus(q, degree):
            raise ValueError(f"{q} is not NTT-friendly for N={degree}")
        r, ir = ntt_root_tables(q, degree)
        rows["r"].append(r)
        rows["rs"].append([shoup64(v, q) for v in r])
        rows["ir"].append(ir)
        rows["irs"].append([shoup64(v, q) for v in ir])
        ninv = nt.inverse_mod(degree, q)
        ninvw = (ninv * ir[1]) % q
        for key, v in (("ni", ninv), ("nis", shoup64(ninv, q)), ("nw", ninvw),
                       ("nws", shoup64(ninvw, q)), ("q", q)):
            scal[key].append([v])
    return NttTables(
        degree=degree,
        moduli=tuple(moduli),
        roots=_u64_tensor(rows["r"], device),
        roots_shoup=_u64_tensor(rows["rs"], device),
        inv_roots=_u64_tensor(rows["ir"], device),
        inv_roots_shoup=_u64_tensor(rows["irs"], device),
        n_inv=_u64_tensor(scal["ni"], device),
        n_inv_shoup=_u64_tensor(scal["nis"], device),
        n_inv_w=_u64_tensor(scal["nw"], device),
        n_inv_w_shoup=_u64_tensor(scal["nws"], device),
        q=_u64_tensor(scal["q"], device),
    )


def _check_plain(x: torch.Tensor, tables: NttTables, direction: str) -> None:
    L, n = len(tables.moduli), tables.degree
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"NTT expects [..., {L}, {n}], got {tuple(x.shape)}")
    if max(tables.moduli) >= PLAIN_MAX_MODULUS:
        raise ValueError("the plain NTT takes moduli below 2^31")
    if x.device.type == "cuda":
        plain_calls_on_cuda[direction] += 1


def forward_ntt_plain(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Plain PyTorch forward NTT: int64 [..., L, N] in [0, q) -> Eval."""
    _check_plain(x, tables, "forward")
    n, L = tables.degree, len(tables.moduli)
    batch = tuple(x.shape[:-2])
    q = tables.q.view(L, 1, 1)
    log2n = nt.log2_exact(n)
    for log2m in range(log2n):
        m, t = 1 << log2m, n >> (log2m + 1)
        v = x.reshape(batch + (L, m, 2, t))
        a, b = v[..., 0, :], v[..., 1, :]
        wb = torch.remainder(b * tables.roots[:, m : 2 * m, None], q)
        x = torch.stack((add_mod(a, wb, q), sub_mod(a, wb, q)), dim=-2)
    return x.reshape(batch + (L, n))


def inverse_ntt_plain(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Plain PyTorch inverse NTT: int64 [..., L, N] in [0, q) -> Coeff."""
    _check_plain(x, tables, "inverse")
    n, L = tables.degree, len(tables.moduli)
    batch = tuple(x.shape[:-2])
    q = tables.q.view(L, 1, 1)
    log2n = nt.log2_exact(n)
    for log2m in range(log2n - 1, 0, -1):
        m, t = 1 << log2m, n >> (log2m + 1)
        v = x.reshape(batch + (L, m, 2, t))
        a, b = v[..., 0, :], v[..., 1, :]
        d = torch.remainder(sub_mod(a, b, q) * tables.inv_roots[:, m : 2 * m, None], q)
        x = torch.stack((add_mod(a, b, q), d), dim=-2)
    # final stage (m = 1): n^-1 on the x half, n^-1 * w^-1 on the y half
    v = x.reshape(batch + (L, 2, n // 2))
    a, b = v[..., 0, :], v[..., 1, :]
    q1 = tables.q
    lo = torch.remainder(add_mod(a, b, q1) * tables.n_inv, q1)
    hi = torch.remainder(sub_mod(a, b, q1) * tables.n_inv_w, q1)
    return torch.cat((lo, hi), dim=-1)


def forward_ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form in [0, q)."""
    if x.device.type == "cuda":
        return ntt_cuda.forward(x.contiguous(), tables)
    if x.device.type == "cpu":
        return forward_ntt_plain(x, tables)
    raise ValueError(f"no NTT for device {x.device}")


def inverse_ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Coeff form in [0, q)."""
    if x.device.type == "cuda":
        return ntt_cuda.inverse(x.contiguous(), tables)
    if x.device.type == "cpu":
        return inverse_ntt_plain(x, tables)
    raise ValueError(f"no NTT for device {x.device}")
