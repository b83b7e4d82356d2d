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
stage fully reduced by ops/modarith.mul_mod: the int64 route for moduli
below 2^31, the exact wide route (ops/wide.py) up to the kernel's 2^62.
The tracer's registry counts plain transforms of CUDA tensors
(plain_on_cuda.ntt_forward, plain_on_cuda.ntt_inverse), which only a
comparison against the kernel should make. Before either, she_tpu's
opt-in (SHE_TPU_NTT_MXU=1, ops/ntt_mxu.use_mxu) sends the transform to the
matrix NTT of ops/ntt_mxu.py, as she_tpu's ops/ntt.py:356-361,377-382 do;
a sharded NTT's block tables never take it.

The kernel's word follows the moduli (`ntt_word_bits`): 32 bits when every
q < 2^30, she_tpu's one-limb rule, with the 32-bit Shoup tables of
`NttTables.w32`; 64 bits otherwise, with the 64-bit Shoup tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import trace
from ..utils import nt
from ..utils.refimpl import ntt_root_tables
from . import ntt_cuda, ntt_mxu
from . import wide
from .modarith import add_mod, mul_mod, sub_mod

PLAIN_MAX_MODULUS = 1 << 62
W32_MAX_MODULUS = 1 << 30  # Harvey's lazy range [0, 4q) fits one 32-bit word


@dataclass(frozen=True)
class ShoupTables:
    """Twiddles and scalars of one word width, on the device.

    roots / inv_roots and their Shoup constants floor(w * 2^bits / q) are
    [L, N]; the scalars q, n^-1 and n^-1 * w^-1 (with Shoup constants) are
    [L, 1]. Each value is stored as the bit pattern of an unsigned word:
    int64 for 64 bits, int32 for 32 bits."""

    roots: torch.Tensor
    roots_shoup: torch.Tensor
    inv_roots: torch.Tensor
    inv_roots_shoup: torch.Tensor
    n_inv: torch.Tensor
    n_inv_shoup: torch.Tensor
    n_inv_w: torch.Tensor
    n_inv_w_shoup: torch.Tensor
    q: torch.Tensor


@dataclass(frozen=True, kw_only=True)
class NttTables(ShoupTables):
    """Per-(moduli, degree, device) tables: the 64-bit ones (which the plain
    version reads too) as fields, and the 32-bit ones in `w32` where
    `word_bits` is 32, else None. `block` is None, or (full degree,
    blocks, block) for the tables of build_block_tables."""

    degree: int
    moduli: tuple[int, ...]
    word_bits: int
    w32: ShoupTables | None
    block: tuple[int, int, int] | None = None


def ntt_word_bits(moduli) -> int:
    """The kernel's word for these moduli: 32 bits when every q < 2^30
    (she_tpu's ops/word.py:nlimbs_for_modulus gives one limb), else 64."""
    return 32 if max(moduli) < W32_MAX_MODULUS else 64


def shoup_const(w: int, q: int, bits: int) -> int:
    """floor(w * 2^bits / q) for 0 <= w < q."""
    if not 0 <= w < q:
        raise ValueError(f"Shoup constant needs 0 <= w < q, got {w}, {q}")
    return (w << bits) // q


def _word_tensor(values, bits: int, device) -> torch.Tensor:
    """Python ints in [0, 2^bits) -> int64 / int32 tensor of their bit patterns."""
    unsigned, signed = (np.uint64, np.int64) if bits == 64 else (np.uint32, np.int32)
    arr = np.array(values, dtype=unsigned).view(signed)
    return torch.from_numpy(arr).to(device)


def _shoup_tables(rows, bits, device) -> dict:
    """rows: per modulus (q, roots, inverse roots, n^-1, n^-1 * w^-1)."""
    cols = {k: [] for k in ShoupTables.__dataclass_fields__}
    for q, r, ir, ninv, ninvw in rows:
        cols["roots"].append(r)
        cols["roots_shoup"].append([shoup_const(v, q, bits) for v in r])
        cols["inv_roots"].append(ir)
        cols["inv_roots_shoup"].append([shoup_const(v, q, bits) for v in ir])
        for key, v in (("n_inv", ninv), ("n_inv_shoup", shoup_const(ninv, q, bits)),
                       ("n_inv_w", ninvw), ("n_inv_w_shoup", shoup_const(ninvw, q, bits)),
                       ("q", q)):
            cols[key].append([v])
    return {k: _word_tensor(v, bits, device) for k, v in cols.items()}


def _tables(rows, moduli, degree, device, block=None) -> NttTables:
    bits = ntt_word_bits(moduli)
    w32 = ShoupTables(**_shoup_tables(rows, 32, device)) if bits == 32 else None
    return NttTables(
        **_shoup_tables(rows, 64, device),
        degree=degree, moduli=tuple(moduli), word_bits=bits, w32=w32, block=block,
    )


@lru_cache(maxsize=None)
def build_ntt_tables(moduli: tuple[int, ...], degree: int, device: torch.device) -> NttTables:
    for q in moduli:
        if not nt.is_ntt_modulus(q, degree):
            raise ValueError(f"{q} is not NTT-friendly for N={degree}")
    rows = []
    for q in moduli:
        r, ir = ntt_root_tables(q, degree)
        ninv = nt.inverse_mod(degree, q)
        rows.append((q, r, ir, ninv, (ninv * ir[1]) % q))
    return _tables(rows, moduli, degree, device)


@lru_cache(maxsize=None)
def build_block_tables(moduli: tuple[int, ...], degree: int, blocks: int, block: int,
                       device: torch.device) -> NttTables:
    """Tables of the transform that block `block` of `blocks` contiguous
    N/blocks-blocks of a length-`degree` NTT undergoes once the first
    log2(blocks) stages are done: a negacyclic NTT of length
    n = degree / blocks whose twiddle j = m + i (m a power of two, i < m)
    is the full table's (blocks + block) * m + i, forward and inverse (she_tpu
    parallel/sharded.py:130,151 index m + block * m_local with
    m = blocks * m_local). The inverse leaves n^-1 out of its last stage
    (n_inv = 1, n_inv_w = its twiddle 1), so that the remaining stages and
    the division by `degree` can follow."""
    if blocks < 1 or blocks & (blocks - 1) or degree < 2 * blocks or not 0 <= block < blocks:
        raise ValueError(f"block {block} of {blocks} of a length-{degree} transform")
    n = degree // blocks
    # twiddle j = m + i of the block is the full table's (blocks + block - 1) * m + j
    idx = [0] + [(blocks + block - 1) * (1 << (j.bit_length() - 1)) + j for j in range(1, n)]
    rows = []
    for q in moduli:
        r, ir = ntt_root_tables(q, degree)
        rb, irb = [r[k] for k in idx], [ir[k] for k in idx]
        rows.append((q, rb, irb, 1, irb[1]))
    return _tables(rows, moduli, n, device, (degree, blocks, block))


def _check_plain(x: torch.Tensor, tables: NttTables, direction: str) -> None:
    L, n = len(tables.moduli), tables.degree
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"NTT expects [..., {L}, {n}], got {tuple(x.shape)}")
    if max(tables.moduli) >= PLAIN_MAX_MODULUS:
        raise ValueError("the plain NTT takes moduli below 2^62")
    if x.device.type == "cuda":
        trace.count("plain_on_cuda.ntt_" + direction)


def forward_ntt_plain(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Plain PyTorch forward NTT: int64 [..., L, N] in [0, q) -> Eval."""
    _check_plain(x, tables, "forward")
    n, L = tables.degree, len(tables.moduli)
    batch = tuple(x.shape[:-2])
    q = wide.tag(tables.q.view(L, 1, 1), tables.moduli)
    log2n = nt.log2_exact(n)
    for log2m in range(log2n):
        m, t = 1 << log2m, n >> (log2m + 1)
        v = x.reshape(batch + (L, m, 2, t))
        a, b = v[..., 0, :], v[..., 1, :]
        wb = mul_mod(b, tables.roots[:, m : 2 * m, None], q)
        x = torch.stack((add_mod(a, wb, q), sub_mod(a, wb, q)), dim=-2)
    return x.reshape(batch + (L, n))


def inverse_ntt_plain(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Plain PyTorch inverse NTT: int64 [..., L, N] in [0, q) -> Coeff."""
    _check_plain(x, tables, "inverse")
    n, L = tables.degree, len(tables.moduli)
    batch = tuple(x.shape[:-2])
    q = wide.tag(tables.q.view(L, 1, 1), tables.moduli)
    log2n = nt.log2_exact(n)
    for log2m in range(log2n - 1, 0, -1):
        m, t = 1 << log2m, n >> (log2m + 1)
        v = x.reshape(batch + (L, m, 2, t))
        a, b = v[..., 0, :], v[..., 1, :]
        d = mul_mod(sub_mod(a, b, q), tables.inv_roots[:, m : 2 * m, None], q)
        x = torch.stack((add_mod(a, b, q), d), dim=-2)
    # final stage (m = 1): n^-1 on the x half, n^-1 * w^-1 on the y half
    v = x.reshape(batch + (L, 2, n // 2))
    a, b = v[..., 0, :], v[..., 1, :]
    q1 = wide.tag(tables.q.view(L, 1), tables.moduli)
    lo = mul_mod(add_mod(a, b, q1), tables.n_inv, q1)
    hi = mul_mod(sub_mod(a, b, q1), tables.n_inv_w, q1)
    return torch.cat((lo, hi), dim=-1)


def forward_ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form in [0, q)."""
    if ntt_mxu.use_mxu(tables):
        return ntt_mxu.forward_ntt(x, ntt_mxu.tables_for(tables.moduli, tables.degree, x.device))
    if x.device.type == "cuda":
        return ntt_cuda.forward(x.contiguous(), tables)
    if x.device.type == "cpu":
        return forward_ntt_plain(x, tables)
    raise ValueError(f"no NTT for device {x.device}")


def inverse_ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Coeff form in [0, q)."""
    if ntt_mxu.use_mxu(tables):
        return ntt_mxu.inverse_ntt(x, ntt_mxu.tables_for(tables.moduli, tables.degree, x.device))
    if x.device.type == "cuda":
        return ntt_cuda.inverse(x.contiguous(), tables)
    if x.device.type == "cpu":
        return inverse_ntt_plain(x, tables)
    raise ValueError(f"no NTT for device {x.device}")
