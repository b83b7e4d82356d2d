#!/usr/bin/env python3
"""Time every tile of the dim-0 MAC kernel (csrc/dim0_mac.cu) at the served shapes, on one NVIDIA card.

The kernel is built for the tiles of ops/dim0_mac_cuda.TILES (mt rows of
A by m2t rows of B a thread); ops/dim0_mac_cuda.tile picks one by the
shape. This script calls the kernel with each tile at the w64 cell's
widest launch (A [4, 11, 2, 8192] x B [11, 256, 2, 8192]) and PNNS's (A
[11, 1, 12, 2, 4096], the diagonals as a view, x B [12, 16, 2, 2, 4096]), on uniform
residues drawn on the card, checks every tile's output equal to the
chosen tile's, and prints the mean ms of 20 launches after a warm-up
(CUDA events) beside the byte bound and the card's name and power limit.

Run from the repository root, on a machine with the card:
  python3 tools/dim0_mac_tiles.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from she_tpu_torch import params as paramsmod  # noqa: E402
from she_tpu_torch.ops import dim0_mac_cuda as dc  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def residues(moduli, shape, n, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.stack([torch.randint(0, q, tuple(shape) + (n,), generator=g, device="cuda") for q in moduli], dim=-2)


def ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("dim0_mac_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    w64 = tuple(paramsmod.from_predefined("n_8192_logq_3x55_logt_24", scalar_bits=64).coefficient_moduli[:2])
    pnns = tuple(paramsmod.from_predefined("n_4096_logq_27_28_28_logt_17", scalar_bits=32).coefficient_moduli[:2])
    cases = {"w64": (residues(w64, (4, 11), 8192, 1), residues(w64, (11, 256), 8192, 2), w64),
             "pnns": (residues(pnns, (11, 12, 1), 4096, 3).permute(0, 2, 1, 3, 4), residues(pnns, (12, 16, 2), 4096, 4),
                      pnns)}
    for label, (a, b, moduli) in cases.items():
        m1, m2 = a.shape[:-3].numel(), b.shape[1:-2].numel()
        want = dc.dim0_mac(a, b, moduli)
        nbytes = 8 * (a.numel() + b.numel() + want.numel())
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"[{label}] a {tuple(a.shape)} x b {tuple(b.shape)}: byte bound {bound:.4f} ms; the wrapper's tile "
              f"{dc.tile(m1, m2)}")
        for mt, m2t in dc.TILES:
            if not torch.equal(dc.dim0_mac(a, b, moduli, (mt, m2t)), want):
                raise AssertionError(f"[{label}] tile ({mt}, {m2t}) differs")
            t = ms(lambda mt=mt, m2t=m2t: dc.dim0_mac(a, b, moduli, (mt, m2t)))
            print(f"[{label}] tile ({mt}, {m2t}): {t:.4f} ms, {100 * bound / t:.1f}% of the byte bound, on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
