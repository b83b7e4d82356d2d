#!/usr/bin/env python3
"""Time the butterfly NTT kernels of two trees in turns, on one NVIDIA card.

Builds csrc/ntt.cu of this tree and of `--parent` (another checkout, e.g.
an older commit unpacked with git archive) with nvcc into one library each,
then, at each shape of SHAPES, times both directions of every library in
turns (parent, this, this, parent, ... for --turns rounds: CUDA events, the
mean of 20 launches after a warm-up), through ops/ntt_cuda with its
library swapped, and holds every library's output bit-equal to the plain
version on the same input. Prints each build's registers and spills (ptxas
-v) of its 64-bit N = 8192 and 32-bit N = 4096 instances, the integer SASS
instruction counts of its 64-bit N = 8192 instances,
the card's name and power limit, and one JSON line of the times.

A library without she_ntt_lazy (built from ntt.cu before the row walk)
takes the older C interface, which has no modulus_bits argument.

Run from the repository root, on a machine with the card:
  python3 tools/ntt_turns.py --parent DIR [--turns 2] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

W64_MODULI = (36028797018652673, 36028797017571329, 36028797017456641)  # n_8192_logq_3x55_logt_24
# (label, moduli, batch shape, degree): the w64 cell's widest NTT launch, its
# widest [q, B_sk] launch (2 of q and 3 of B_sk, 61 bits) and the keyword
# cell's widest, on the 32-bit route
SHAPES = (
    ("w64 [7, 128, 2, 3, 8192]", W64_MODULI, (7, 128, 2), 8192),
    ("w64 [q, B_sk] [128, 4, 2, 5, 8192]", None, (128, 4, 2), 8192),
    ("keyword [128, 128, 2, 3, 4096]", None, (128, 128, 2), 4096),
)


class OlderInterface:
    """A library built before the row walk: the calls without modulus_bits."""

    def __init__(self, lib, fwd_args, inv_args):
        self.lib = lib
        lib.she_ntt_forward.argtypes = fwd_args[:6] + fwd_args[7:]
        lib.she_ntt_inverse.argtypes = inv_args[:6] + inv_args[7:]

    def she_ntt_forward(self, *args):
        return self.lib.she_ntt_forward(*(args[:6] + args[7:]))

    def she_ntt_inverse(self, *args):
        return self.lib.she_ntt_inverse(*(args[:6] + args[7:]))


def build(label: str, source: Path, out_dir: Path):
    """nvcc with the package's flags; returns (library, ptxas lines of the
    64-bit N = 8192 instances and the 32-bit N = 4096 ones)."""
    from she_tpu_torch.ops import kernel_build, ntt_cuda

    out = out_dir / f"libntt_{label}.so"
    log = subprocess.run([kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-o", str(out), str(source)],
                         capture_output=True, text=True, check=True).stderr.splitlines()
    ptxas, keep = [], False
    for line in log:
        if "Compiling entry function" in line:
            name = re.search(r"(ntt_(?:forward|inverse)_kernel)I(?:yLi13E(Lb1E)?|(j)Li12E)", line)
            keep = bool(name)
            current = name and name.group(1) + (" lazy" if name.group(2) else "") + (" u32 N=4096" if name.group(3)
                                                                                      else "")
        elif keep and ("Used" in line or "spill" in line):
            ptxas.append(f"{current}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "she_ntt_lazy"):
        lib.she_ntt_forward.argtypes = ntt_cuda._FWD_ARGS
        lib.she_ntt_inverse.argtypes = ntt_cuda._INV_ARGS
    else:
        lib = OlderInterface(lib, ntt_cuda._FWD_ARGS, ntt_cuda._INV_ARGS)
    return lib, ptxas, out


def sass_counts(path: Path) -> dict:
    """Integer SASS instructions of each 64-bit N = 8192 instance (ALU and
    FMA pipes, as chip_smoke.sass_integer_counts splits them) and in all."""
    import chip_smoke as cs
    from she_tpu_torch.ops import kernel_build

    tool = os.path.join(os.path.dirname(kernel_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    out, function = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            f = re.search(r"(ntt_(?:forward|inverse)_kernel)IyLi13E(Lb1E)?", m.group(1))
            function = f and f.group(1) + (" lazy" if f.group(2) else "")
            if function:
                out[function] = {"alu": 0, "fma": 0, "all": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", line)
        if function and m:
            out[function]["all"] += 1
            op = m.group(1)
            if op in cs.FMA_INT_OPCODES:
                out[function]["fma"] += 1
            elif op in cs.ALU_INT_OPCODES:
                out[function]["alu"] += 1
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="the other tree, whose she_tpu_torch/csrc/ntt.cu is timed")
    parser.add_argument("--turns", type=int, default=2, help="rounds of (parent, this, this, parent)")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ntt_turns: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.core import rns
    from she_tpu_torch.ops import ntt, ntt_cuda

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "she_tpu_torch" / "csrc" / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, builds = {}, {}
    for label, tree in (("parent", Path(args.parent)), ("this", ROOT)):
        lib, ptxas, path = build(label, tree / "she_tpu_torch" / "csrc" / "ntt.cu", out_dir)
        libs[label] = lib
        builds[label] = dict(ptxas=ptxas, sass=sass_counts(path))
        for line in ptxas:
            print(f"{label} {line}", flush=True)
        for function, counts in builds[label]["sass"].items():
            print(f"{label} {function}: integer SASS {counts}", flush=True)

    keyword = paramsmod.from_predefined(cs.PARAMS, scalar_bits=32)
    moduli_of = {SHAPES[1][0]: W64_MODULI[:2] + tuple(rns.bsk_prime_pool(8192, 3, 64))[:3],
                 SHAPES[2][0]: tuple(keyword.coefficient_moduli)}
    order = ["parent", "this", "this", "parent"] * args.turns
    results = {}
    original = ntt_cuda._library
    try:
        for label, moduli, batch, degree in SHAPES:
            moduli = moduli or moduli_of[label]
            tables = ntt.build_ntt_tables(tuple(moduli), degree, torch.device("cuda"))
            x = cs.random_rows(moduli, batch, degree, 7)
            bound = cs.kernel_bound_ms(tuple(batch) + (len(moduli), degree), moduli, degree)
            row = {name: {tree: [] for tree in libs} for name in ("ntt_forward", "ntt_inverse")}
            for tree in order:
                ntt_cuda._library = lambda lib=libs[tree]: lib
                row["ntt_forward"][tree].append(cs.cuda_ms(lambda: ntt_cuda.forward(x, tables), 20))
                row["ntt_inverse"][tree].append(cs.cuda_ms(lambda: ntt_cuda.inverse(x, tables), 20))
            want = {"ntt_forward": ntt.forward_ntt_plain(x, tables), "ntt_inverse": ntt.inverse_ntt_plain(x, tables)}
            for tree, lib in libs.items():
                ntt_cuda._library = lambda lib=lib: lib
                for name, kern in (("ntt_forward", ntt_cuda.forward), ("ntt_inverse", ntt_cuda.inverse)):
                    if not torch.equal(kern(x, tables), want[name]):
                        raise AssertionError(f"{tree} {name} at {label} differs from the plain version")
            results[label] = dict(moduli=list(moduli), bound_ms=bound, ms=row)
            for name, times in row.items():
                print(f"{label} {name}: " + "; ".join(
                    f"{tree} {min(ts):.4f} ms ({100 * bound / min(ts):.1f}% of the {bound:.4f} ms byte bound; "
                    f"turns {[round(t, 4) for t in ts]})" for tree, ts in times.items())
                      + f"; this / parent {min(times['this']) / min(times['parent']):.3f}; bit-equal to plain; "
                      f"on {card}", flush=True)
            del x, want
            torch.cuda.empty_cache()
    finally:
        ntt_cuda._library = original
    summary = dict(card=card, builds=builds, shapes=results)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({label: {name: {tree: min(ts) for tree, ts in times.items()} for name, times in r["ms"].items()}
                      for label, r in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
