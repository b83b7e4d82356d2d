"""The key switch's four passes around its two NTTs, and the expansion's combine.

she_tpu compiles a key switch as one jitted program that XLA fuses
(she_tpu/bfv/keys.py:270-363 _compute_key_switching_update, and the
row-vectorized _compute_key_switching_update_w32 :184-267); bfv.py:814-840
applies a Galois element around it and :796-811 relinearizes with it, and
pir/serving.py:160-167 combines each expansion level. The port runs a key
switch of a target [..., L_t, N] (Coeff, over L_t ciphertext moduli) over
the key-switching context ks_ctx (the L_t moduli and q_ks, L_ks = L_t + 1)
as

    ks_digits -> forward NTT -> ks_mac -> inverse NTT -> ks_finish

and an expansion level as one or more of those, then expand_combine. Each
function dispatches on its data's device: a CPU tensor takes the plain
PyTorch version below, a CUDA tensor the hand-written kernel of
ops/key_switch_cuda.py (csrc/key_switch.cu), and anything else raises.
`plain_calls_on_cuda` counts plain calls on CUDA tensors, which only a
comparison against the kernels should make. Every output is fully reduced,
so the kernels equal the plain versions bit for bit.

* ks_digits: out[..., j, i, k] = (g(c1)[..., j, k] mod q_j) mod q_i, where
  g is the signed Galois gather +-c1[..., j, src[k]] (the negation taken
  mod q_j, then the value reduced mod q_i: where q_j > q_i,
  (q_j - a) mod q_i is not q_i - (a mod q_i)), or the identity.
* ks_mac: out[..., c, i, k] = sum_j fwd[..., j, i, k] * key[j, c, i, k]
  mod q_i against KeySwitchKey.key_rows(L_t).
* ks_finish: the divide-and-round by q_ks of every component (as
  core/poly.divide_and_round_q_last_data), then the add into the
  ciphertext: out0 = g(c0) + u0 (c0 given; g the gather where an element
  is given), out1 = c1 + u1 (c1 given) or u1.
* expand_combine: per level node r, p0 = c'_r + parent_r and
  p1 = (parent_r - c'_r) * x^-shift, the parents read from the slot pool
  and both children written: an inner node into its slot, a leaf (where
  the level writes leaves: `out` given) into the output at its position,
  doubled (2 p mod q, she_tpu/pir/serving.py:168-171) where the plan's
  mask says. On the card a level that writes leaves launches the
  kernel's leaf instance, counted as expand_leaves.

`index`: where given, the operand's axis 0 is gathered by it (the slot
pool of the expansion, read in place).
"""

from __future__ import annotations

import torch

from ..core import poly as polymod
from . import galois as galoismod
from . import key_switch_cuda
from . import modarith as ma

plain_calls_on_cuda = {"ks_digits": 0, "ks_mac": 0, "ks_finish": 0, "expand_combine": 0, "expand_leaves": 0}


def _count_plain(name: str, x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        plain_calls_on_cuda[name] += 1


def _select(x: torch.Tensor, index) -> torch.Tensor:
    return x if index is None else x.index_select(0, index)


def _target_q(ks_ctx) -> torch.Tensor:
    """The target's moduli (all of ks_ctx's but q_ks) as a tagged column."""
    return ks_ctx.column(ks_ctx.moduli[:-1])


def _route(name: str, x: torch.Tensor, kernel, plain):
    if x.device.type == "cuda":
        return kernel()
    if x.device.type == "cpu":
        return plain()
    raise ValueError(f"no {name} for device {x.device}")


# -- plain versions -----------------------------------------------------------


def ks_digits_plain(c1: torch.Tensor, ks_ctx, element: int | None = None, index=None) -> torch.Tensor:
    """c1 [..., L_t, N] (index: its axis 0 gathered) -> [..., L_t, L_ks, N]."""
    _count_plain("ks_digits", c1)
    x = _select(c1, index)
    if element is not None:
        x = galoismod.apply_galois_coeff(x, _target_q(ks_ctx), element)
    return torch.remainder(x.unsqueeze(-2), ks_ctx.q_col)


def ks_mac_plain(fwd: torch.Tensor, key: torch.Tensor, ks_ctx) -> torch.Tensor:
    """fwd [..., L_t, L_ks, N], key [L_t, comps, L_ks, N] -> [..., comps, L_ks, N]."""
    _count_plain("ks_mac", fwd)
    terms = ((fwd[..., j, None, :, :], key[j]) for j in range(fwd.shape[-3]))
    return ma.sum_products_mod(terms, ks_ctx.q_col, ks_ctx.max_signed_lazy_product_count())


def ks_finish_plain(inv: torch.Tensor, ks_ctx, c0=None, c1=None, element: int | None = None,
                    index=None) -> torch.Tensor:
    """inv [..., comps, L_ks, N] -> [..., comps, L_t, N]."""
    _count_plain("ks_finish", inv)
    out = polymod.divide_and_round_q_last_data(inv, ks_ctx)
    q = _target_q(ks_ctx)
    comps = list(out.unbind(-3))
    if c0 is not None:
        x0 = _select(c0, index)
        if element is not None:
            x0 = galoismod.apply_galois_coeff(x0, q, element)
        comps[0] = ma.add_mod(x0, comps[0], q)
    if c1 is not None:
        comps[1] = ma.add_mod(_select(c1, index), comps[1], q)
    return torch.stack(comps, dim=-3)


def check_level_slots(parents, child0, child1) -> None:
    """An expansion level's slots as expand_combine needs them: its kernel
    writes the children in place while other blocks still read parents,
    so the children must be distinct and none may be a parent slot (a
    negative child, a leaf's output position, differs from every slot).
    Plain ints, checked on the host once per plan."""
    children = list(child0) + list(child1)
    if len(set(children)) != len(children) or not set(children).isdisjoint(parents):
        raise ValueError(f"a level's child slots must be distinct and apart from its parents: parents {list(parents)}, "
                         f"children {list(child0)} and {list(child1)}")


def expand_combine_plain(pool: torch.Tensor, update: torch.Tensor, parents: torch.Tensor, child0: torch.Tensor,
                         child1: torch.Tensor, shift: int, ct_ctx, out=None, doubled=None) -> None:
    """pool [slots, ..., L, N], update [n, ..., L, N]: writes
    p0 = update + pool[parents] to child0 and
    p1 = (pool[parents] - update) * x^-shift to child1, in place. Without
    `out` every child is a pool slot; with it (out [outputs, ..., L, N]) a
    negative child c is the leaf at output position -c - 1, written there
    as 2 p mod q where `doubled` (bool [2, n]: the first children, then
    the second; None: no leaf doubled) says so."""
    _count_plain("expand_leaves" if out is not None else "expand_combine", update)
    q = ct_ctx.q_col
    par = pool.index_select(0, parents)
    p0 = ma.add_mod(update, par, q)
    p1 = polymod.multiply_power_of_x_data(ma.sub_mod(par, update, q), -shift, ct_ctx)
    if out is None:
        pool[child0] = p0
        pool[child1] = p1
        return
    for row, (children, p) in enumerate(((child0, p0), (child1, p1))):
        if doubled is not None:
            twice = doubled[row].view((-1,) + (1,) * (p.dim() - 1))
            p = torch.where(twice, ma.add_mod(p, p, q), p)
        leaf = children < 0
        pool[children[~leaf]] = p[~leaf]
        out[-children[leaf] - 1] = p[leaf]


# -- dispatch -----------------------------------------------------------------


def ks_digits(c1: torch.Tensor, ks_ctx, element: int | None = None, index=None) -> torch.Tensor:
    return _route("ks_digits", c1, lambda: key_switch_cuda.ks_digits(c1, ks_ctx.moduli, element, index),
                  lambda: ks_digits_plain(c1, ks_ctx, element, index))


def ks_mac(fwd: torch.Tensor, key: torch.Tensor, ks_ctx) -> torch.Tensor:
    return _route("ks_mac", fwd, lambda: key_switch_cuda.ks_mac(fwd, key, ks_ctx.moduli),
                  lambda: ks_mac_plain(fwd, key, ks_ctx))


def ks_finish(inv: torch.Tensor, ks_ctx, c0=None, c1=None, element: int | None = None, index=None) -> torch.Tensor:
    return _route("ks_finish", inv,
                  lambda: key_switch_cuda.ks_finish(inv, ks_ctx.moduli, c0, c1, element, index),
                  lambda: ks_finish_plain(inv, ks_ctx, c0, c1, element, index))


def expand_combine(pool: torch.Tensor, update: torch.Tensor, parents: torch.Tensor, child0: torch.Tensor,
                   child1: torch.Tensor, shift: int, ct_ctx, out=None, doubled=None) -> None:
    _route("expand_combine", update,
           lambda: key_switch_cuda.expand_combine(pool, update, parents, child0, child1, shift, ct_ctx.moduli, out,
                                                  doubled),
           lambda: expand_combine_plain(pool, update, parents, child0, child1, shift, ct_ctx, out, doubled))
