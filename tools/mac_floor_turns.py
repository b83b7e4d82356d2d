#!/usr/bin/env python3
"""Time the dim-0 MAC and BEHZ floor kernels of two trees in turns, on one NVIDIA card.

Loads `--parent` (another checkout, e.g. an older commit unpacked with git
archive) as a second copy of the port under another package name, builds
its csrc/dim0_mac.cu and csrc/behz.cu and this tree's with nvcc (each
tree's ops/kernel_build, flags and all), then at each shape of SHAPES times
each tree's kernel through its own wrapper in turns (parent, this, this,
parent, ... for --turns rounds: CUDA events, the mean of 20 launches after
a warm-up) and holds both outputs bit-equal to this tree's plain version on
the same input. The shapes are the widest each kernel is served with:
dim0_mac at the w64 cell's dim-0 (A [4, 11, 2, 8192] x B [11, 256, 2,
8192]) and PNNS's BSGS MAC (A [11, 1, 12, 2, 4096], the diagonals as a
view, x B [12, 16, 2, 2, 4096]; both PNNS cells serve it at the same
moduli), behz_floor at the keyword and w32 cells' [128, 3, 5, 4096] and
the w64 cell's [128, 3, 5, 8192]. Each turn also replays 20 calls from a
CUDA graph, the kernel's time without the host's cost of a call (about
0.07 ms for the wrapper of a short MAC). Prints each build's registers and spills
(ptxas -v) and integer SASS instructions by pipe (cuobjdump) of the
instances these shapes take, each shape's byte bound, the card's name and
power limit, and one JSON line of the least time of each tree.

`--rates` also builds and times a microbenchmark of the multiply-adds a
kernel can use (mad.wide.u32, mad.lo.u32, mad.hi.u32, fma.rn.f64: eight
independent chains a thread, one instruction each an iteration) and
prints the rate of each, a clock an SM.
`--plans` also times this tree's dim0_mac at both MAC shapes under other
launch plans (ops/dim0_mac_cuda.MacPlan: lanes, the m2 each lane walks
and the depth of the rings), in a graph, each held
bit-equal to the default plan's output: the sweep that chose plan()'s
defaults.

Run from the repository root, on a machine with the card:
  python3 tools/mac_floor_turns.py --parent DIR [--turns 2] [--plans] [--rates] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

W64 = "n_8192_logq_3x55_logt_24"
W32 = "n_4096_logq_27_28_28_logt_5"
PNNS = "n_4096_logq_27_28_28_logt_17"
# label -> (kernel, parameters, scalar bits, A batch (MAC) or y batch (floor), B batch, degree)
SHAPES = {
    "dim0_mac w64 [4, 11] x [11, 256]": ("dim0_mac", W64, 64, (4, 11), (11, 256), 8192),
    "dim0_mac pnns [11, 1, 12] x [12, 16, 2]": ("dim0_mac", PNNS, 32, (11, 12, 1), (12, 16, 2), 4096),
    "behz_floor keyword/w32 [128, 3, 5, 4096]": ("behz_floor", W32, 32, (128, 3), None, 4096),
    "behz_floor w64 [128, 3, 5, 8192]": ("behz_floor", W64, 64, (128, 3), None, 8192),
}
# (lanes, m2 each lane walks, depth of the rings of B) tried by --plans
PLAN_SWEEP = [(y, s, d) for y in (2, 4, 8) for s in (1, 2, 4, 8, 16) for d in (1, 2) if d <= s]


RATES_SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
typedef unsigned long long u64;
// eight independent chains a thread, each one instruction of one kind an iteration
template <int KIND>
__global__ void rate(u64* out, unsigned x, unsigned y, int iters) {
  u64 acc[8];
  unsigned lo[8];
  double d[8];
  for (int i = 0; i < 8; ++i) {
    acc[i] = threadIdx.x + i;
    lo[i] = threadIdx.x + i;
    d[i] = threadIdx.x + i;
  }
  const unsigned a = x + threadIdx.x, b = y ^ blockIdx.x;
  const double da = a, db = 1.0 / (b + 1);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (KIND == 0) asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc[i]) : "r"(a), "r"(b));
      if (KIND == 1) asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(lo[i]) : "r"(a), "r"(b));
      if (KIND == 2) asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(lo[i]) : "r"(a), "r"(b));
      if (KIND == 3) asm volatile("fma.rn.f64 %0, %0, %1, %2;" : "+d"(d[i]) : "d"(db), "d"(da));
    }
  }
  u64 s = 0;
  for (int i = 0; i < 8; ++i) s += acc[i] + lo[i] + static_cast<u64>(d[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  const int iters = 4096, blocks = 132 * 8, threads = 256;
  u64* out;
  cudaMalloc(&out, sizeof(u64) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[] = {"mad.wide.u32 (IMAD.WIDE.U32)", "mad.lo.u32 (IMAD)", "mad.hi.u32 (IMAD.HI)", "fma.rn.f64 (DFMA)"};
  for (int kind = 0; kind < 4; ++kind) {
    float ms = 0;
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (kind == 0) rate<0><<<blocks, threads>>>(out, 3, 5, iters);
      if (kind == 1) rate<1><<<blocks, threads>>>(out, 3, 5, iters);
      if (kind == 2) rate<2><<<blocks, threads>>>(out, 3, 5, iters);
      if (kind == 3) rate<3><<<blocks, threads>>>(out, 3, 5, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      cudaEventElapsedTime(&ms, e0, e1);
    }
    printf("%s: %.3f ms, %.1f a clock an SM at 132 SMs x 1.98 GHz\n", names[kind], ms,
           8.0 * iters * blocks * threads / (ms * 1e-3) / 132 / 1.98e9);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def rates(build) -> str:
    """Builds RATES_SOURCE with the package's nvcc and flags (an executable)
    and returns what it prints: the instructions issued a clock an SM of
    each kind the kernels' multiply-adds can take."""
    src = build.BUILD_DIR / "rates.cu"
    exe = build.BUILD_DIR / "rates"
    src.write_text(RATES_SOURCE)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build.nvcc_path(), *flags, "-o", str(exe), str(src)], capture_output=True, text=True, check=True)
    return subprocess.run([str(exe)], capture_output=True, text=True, check=True, timeout=120).stdout


def load_tree(root: Path, name: str):
    """The port under `root` imported as package `name`: its dim0_mac_cuda,
    behz_cuda and kernel_build modules."""
    pkg = root / "she_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in ("dim0_mac_cuda", "behz_cuda", "kernel_build"))


def residues(moduli, batch, degree, seed):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.stack([torch.randint(0, q, tuple(batch) + (degree,), generator=g, device="cuda") for q in moduli],
                       dim=-2)


def ptxas(build, names) -> list[str]:
    """ptxas -v's registers and spills of every dim0_mac and behz_floor
    instance in the build logs, by mangled name."""
    out = []
    for name in names:
        path = build.log_path(name)
        current = None
        for line in path.read_text(errors="replace").splitlines() if path.exists() else []:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1) if re.search(r"dim0_mac_kernel|behz_floor_kernel", m.group(1)) else None
            elif current and ("Used" in line or "spill" in line):
                out.append(f"{current}: {line.strip()}")
    return out


def sass(build, name) -> dict:
    """Integer SASS instructions by pipe (chip_smoke's split) of every
    dim0_mac and behz_floor instance of the library `name`."""
    import chip_smoke as cs

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    out, function = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            function = m.group(1) if re.search(r"dim0_mac_kernel|behz_floor_kernel", m.group(1)) else None
            if function:
                out[function] = {"alu": 0, "fma": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", line)
        if function and m:
            op = m.group(1)
            if op in cs.FMA_INT_OPCODES:
                out[function]["fma"] += 1
            elif op in cs.ALU_INT_OPCODES:
                out[function]["alu"] += 1
    return out


def cases():
    """Each shape's inputs and byte bound, and its plain output as a
    function of no arguments (run after the timing): label -> dict."""
    import chip_smoke as cs
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.core import rns
    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import behz, dim0_mac

    out = {}
    for i, (label, (kernel, params, bits, a_batch, b_batch, degree)) in enumerate(SHAPES.items()):
        q = tuple(paramsmod.from_predefined(params, scalar_bits=bits).coefficient_moduli[:2])
        if kernel == "dim0_mac":
            a = residues(q, a_batch, degree, 10 + i)
            if len(a_batch) == 3:  # PNNS: the packed [G, J, R] diagonals read as [G, R, J]
                a = a.permute(0, 2, 1, 3, 4)
            b = residues(q, b_batch, degree, 20 + i)
            nbytes = 8 * (a.numel() + b.numel() + a.shape[:-3].numel() * b.shape[1:-2].numel() * 2 * degree)
            ctx = get_poly_context(degree, q, 64, torch.device("cuda"))
            out[label] = dict(kernel=kernel, args=(a, b, q), bytes=nbytes,
                              plain=lambda a=a, b=b, ctx=ctx: dim0_mac.dim0_mac_plain(a, b, ctx))
        else:
            bsk = tuple(rns.bsk_prime_pool(degree, len(q), bits))
            tool = rns.RnsTool(get_poly_context(degree, q, bits, torch.device("cuda")), 2, bsk)
            y = residues(q + bsk, a_batch, degree, 30 + i)
            nbytes = 8 * (y.numel() + y.shape[:-2].numel() * len(q) * degree)
            out[label] = dict(kernel=kernel, args=(y, q, bsk), bytes=nbytes,
                              plain=lambda y=y, tool=tool: behz.behz_floor_plain(y, tool))
        out[label]["bound_ms"] = 1e3 * out[label]["bytes"] / cs.HBM_BYTES_PER_S
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="the other tree, whose dim0_mac.cu and behz.cu are timed")
    parser.add_argument("--turns", type=int, default=2, help="rounds of (parent, this, this, parent)")
    parser.add_argument("--plans", action="store_true", help="also sweep this tree's dim0_mac launch plans")
    parser.add_argument("--rates", action="store_true",
                        help="also time the integer and FP64 multiply-add instructions' issue rates")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mac_floor_turns: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    trees = {"parent": load_tree(Path(args.parent).resolve(), "parent_she_tpu_torch"),
             "this": tuple(importlib.import_module(f"she_tpu_torch.ops.{m}")
                           for m in ("dim0_mac_cuda", "behz_cuda", "kernel_build"))}
    names = ("dim0_mac", "behz")
    builds = [threading.Thread(target=t[2].build, args=(names,)) for t in trees.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    report = {}
    if args.rates:
        report["rates"] = rates(trees["this"][2])
        print(report["rates"], end="", flush=True)
    for label, (_, _, build) in trees.items():
        for name in names:
            build.load(name)  # raises with nvcc's output if the build failed
        report[label] = dict(ptxas=ptxas(build, names), sass={n: sass(build, n) for n in names})
        for line in report[label]["ptxas"]:
            print(f"{label} {line}", flush=True)
        for name in names:
            for function, counts in report[label]["sass"][name].items():
                print(f"{label} {function}: integer SASS {counts}", flush=True)

    def call(tree, case, plan=None):
        mac, floor, _ = trees[tree]
        if case["kernel"] == "dim0_mac":
            a, b, q = case["args"]
            return mac.dim0_mac(a, b, q) if plan is None else mac.dim0_mac(a, b, q, plan)
        return floor.behz_floor(*case["args"])

    # every kernel is timed before any plain version runs in the process
    shapes = cases()
    order = ["parent", "this", "this", "parent"] * args.turns
    results = {}
    for label, case in shapes.items():
        times, graphs = {tree: [] for tree in trees}, {tree: [] for tree in trees}
        for tree in order:
            times[tree].append(cs.cuda_ms(lambda tree=tree: call(tree, case), 20))
            graphs[tree].append(cs.graph_ms(lambda tree=tree: call(tree, case)))
        results[label] = dict(bound_ms=case["bound_ms"], ms=times, graph_ms=graphs)
        if case["kernel"] == "dim0_mac":
            a, b, q = case["args"]
            results[label]["plan"] = tuple(trees["this"][0].plan(a.shape[:-3].numel(), b.shape[1:-2].numel(),
                                                                 a.shape[-3], q))
    if args.plans:
        mac = trees["this"][0]
        for label, case in shapes.items():
            if case["kernel"] != "dim0_mac":
                continue
            a, b, q = case["args"]
            m1, m2, j = a.shape[:-3].numel(), b.shape[1:-2].numel(), a.shape[-3]
            base, want = mac.plan(m1, m2, j, q), call("this", case)
            sweep = {}
            for lanes, steps, depth in PLAN_SWEEP:
                p = base._replace(lanes=lanes, run=min(lanes * steps, m2), depth=depth)
                if mac._shared_bytes(p, j) > mac.MAX_SHARED_BYTES:
                    continue
                if not torch.equal(call("this", case, p), want):
                    raise AssertionError(f"{label} plan {p} differs from the default plan's output")
                sweep[str(tuple(p))] = cs.graph_ms(lambda p=p: call("this", case, p))
                print(f"{label} plan {tuple(p)}: {sweep[str(tuple(p))]:.4f} ms in a graph "
                      f"({100 * case['bound_ms'] / sweep[str(tuple(p))]:.1f}%), on {card}", flush=True)
            results[label]["plans"] = sweep
    for label, case in shapes.items():
        want = case["plain"]()
        for tree in trees:
            if not torch.equal(call(tree, case), want):
                raise AssertionError(f"{tree} {label} differs from the plain version")
        times, graphs, bound = results[label]["ms"], results[label]["graph_ms"], case["bound_ms"]
        print(f"{label}: " + "; ".join(
            f"{tree} {min(ts):.4f} ms ({100 * bound / min(ts):.1f}% of the {bound:.4f} ms byte bound; turns "
            f"{[round(t, 4) for t in ts]}; in a graph {min(graphs[tree]):.4f} ms)" for tree, ts in times.items())
              + f"; this / parent {min(times['this']) / min(times['parent']):.3f}"
              + (f"; this tree's plan {results[label]['plan']}" if "plan" in results[label] else "")
              + f"; both bit-equal to plain; on {card}", flush=True)
        del want
        torch.cuda.empty_cache()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(card=card, builds=report, shapes=results), f, indent=1)
    print(json.dumps({label: {tree: min(ts) for tree, ts in r["ms"].items()} for label, r in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
