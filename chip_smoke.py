#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and check every kernel.

Batched MulPIR serving (she_tpu_torch.pir.serving.BatchedMulPirServer)
against a 1,000,000-entry x 1-byte database, 128 queries per batch, on two
paths: w32 (n_4096_logq_27_28_28_logt_5 at 32-bit scalars) and w64
(n_8192_logq_3x55_logt_24 at 64-bit scalars, exact wide arithmetic); then
keyword PIR (BatchedKeywordPirServer) over a 1,000,000-keyword cuckoo table
of 1-byte values, 128 keyword queries per batch, through the wire format:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from she_tpu_torch/csrc with nvcc;
3. hold each kernel bit-equal to its plain PyTorch version at the w32
   path's shapes on the 32-bit route, and at N=4096 on the 64-bit route
   (moduli in [2^30, 2^31));
4. per path: process the database, generate keys and queries with the
   port's client, serve the batches, check that every answer decrypts to
   its entry, print the smallest noise budget of the responses, and check
   that one batched response equals the per-query server's bit for bit,
   with the kernels' launch counts (and launch shapes) read around the
   serving run, then profile one more batch (device time by kernel, idle
   share);
5. keyword PIR (keyword_path): process the database through
   process_database.process (cuckoo table, then one batched NTT), send
   each batch's queries as seeded ciphertext bytes, deserialize, serve and
   serialize the answers for decryption (skip LSBs); the client reads and
   decrypts them: every present keyword must come back with its value,
   every absent one as None; serve the same batches again through
   compute_response_stream, which must answer the same; check one answer
   (and its bytes) against the per-query KeywordPirServer and the noise
   budget, split one batch's device time by stage with CUDA events, and
   profile one more; then serve 32 keywords whose 3,000-byte values take
   two plaintexts a bucket (large_value_path);
6. at every shape a serving run launched a kernel with: hold the kernel
   bit-equal to its plain version, and time both with CUDA events; the
   int8 dim-0 kernel (served by default on the w32 index and keyword
   paths; the w64 path keeps the wide MAC, as she_tpu does) also against
   the int64 MAC and a torch.bmm yardstick of its digit products, and once
   at the w64 shape (8 digits);
7. the PIR service (service_phase): the keyword cell's 1M-keyword
   database behind PirService, a config request, an evaluation-key upload
   and 8 PIR requests (one for an absent keyword) as protobuf bytes; then
   Symmetric PIR (spir_phase): 512 keywords sealed through
   process(..., symmetric_pir_config=...) and 16 lookups (2 absent)
   through OPRF and PIR requests, each value unsealed with the port's
   AES-GCM;
8. print one JSON line with every kernel's numbers, and as the last line
   {"ok": true, "device": {...}}.

Any failure exits non-zero without the last line. Run from the repository
root:  python3 chip_smoke.py [--batches 3] [--seed 0] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
ENTRY_COUNT = 1_000_000
BATCH = 128
# name -> (parameters, scalar bits, fresh queries per batch?): the w64 path
# serves the same 128 queries in each batch (each query takes about 0.2 s
# of host AES-CTR sampling at N=8192)
PATHS = {
    "w32": ("n_4096_logq_27_28_28_logt_5", 32, True),
    "w64": ("n_8192_logq_3x55_logt_24", 64, False),
}
PARAMS = PATHS["w32"][0]
KEYWORD_CELL = "keyword_1m_x_1B_w32_b128"
KEYWORD_COUNT = 1_000_000  # distinct 8-byte keywords, 1-byte values
ABSENT_EVERY = 8  # one query in 8 asks for a keyword that is not in the table
# the multi-chunk route: (keywords, value bytes, queries in one batch)
LARGE_VALUES = (4096, 3000, 32)
SERVICE_REQUESTS = 8  # PIR requests through the service, the last for an absent keyword
SPIR = (512, 16, 2)  # Symmetric PIR: keywords sealed, lookups, of which absent
DIM0_CUT_N = 64  # the n positions of the plain digit form's check at every served shape


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` runs after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_rows(moduli, shape, degree, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = np.zeros(tuple(shape) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        rows[..., i, :] = rng.integers(0, q, size=tuple(shape) + (degree,))
    return torch.from_numpy(rows).cuda()


def ptxas_lines(name: str) -> list[str]:
    """ptxas -v's registers, spills and shared memory of the N=4096
    instantiations of the NTT kernels on both routes, and of the dim-0
    kernel."""
    import re

    from she_tpu_torch.ops import kernel_build

    path = kernel_build.log_path(name)
    lines = path.read_text(errors="replace").splitlines() if path.exists() else []
    out, label = [], None
    for line in lines:
        m = re.search(r"(ntt_(?:forward|inverse)_kernel)I([jy])Li(\d+)E", line)
        if m:
            word = "u32" if m.group(2) == "j" else "u64"
            label = f"{m.group(1)}<{word}, log2n={m.group(3)}>" if m.group(3) == "12" else None
        elif "Compiling entry function" in line and "dim0_int8_kernel" in line:
            label = "dim0_int8_kernel"
        elif label and ("Used" in line or "spill" in line):
            out.append(f"{label}: {line.strip()}")
    return out


def prod(shape) -> int:
    p = 1
    for d in shape:
        p *= d
    return p


def reset_counts() -> None:
    """Every kernel's launch count and launch shapes, and the plain NTT's
    count on CUDA tensors, set to 0: just before a path is driven."""
    from she_tpu_torch.ops import dim0_cuda, ntt, ntt_cuda

    ntt_cuda.reset_launches()
    dim0_cuda.reset_launches()
    for k in ntt.plain_calls_on_cuda:
        ntt.plain_calls_on_cuda[k] = 0


def read_counts(label: str, use_dim0_int8: bool) -> dict:
    """The counts of the path just driven. Fails if a kernel of the path
    never launched, if the int8 dim-0 kernel launched on a path that serves
    the MAC form, or if the plain NTT ran on CUDA tensors."""
    from she_tpu_torch.ops import dim0_cuda, ntt, ntt_cuda

    launches = dict(ntt_cuda.launches) | dict(dim0_cuda.launches)
    plain_on_cuda = dict(ntt.plain_calls_on_cuda)
    path_kernels = ["ntt_forward", "ntt_inverse"] + (["dim0_int8"] if use_dim0_int8 else [])
    if any(launches[k] == 0 for k in path_kernels):
        raise AssertionError(f"[{label}] a kernel of the path never launched: {launches}")
    if not use_dim0_int8 and launches["dim0_int8"]:
        raise AssertionError(f"[{label}] the int8 dim-0 kernel ran on a MAC path: {launches}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"[{label}] the plain NTT ran on CUDA tensors: {plain_on_cuda}")
    return dict(launches=launches, launch_shapes=dict(ntt_cuda.launch_shapes),
                dim0_shapes=dict(dim0_cuda.launch_shapes))


def kernel_bound_ms(shape, moduli, degree) -> float:
    """Bytes over the memory rate: every int64 row read and written once,
    plus the int64 root and Shoup tables of its moduli (counted as in PR 1)."""
    return 1e3 * (2 * prod(shape) * 8 + 2 * len(moduli) * degree * 8) / HBM_BYTES_PER_S


def kernel_phase(seed: int) -> dict:
    """Kernels against their plain versions at the main path's shapes, and
    the 64-bit route against its plain version at N=4096."""
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.core import rns
    from she_tpu_torch.ops import ntt, ntt_cuda
    from she_tpu_torch.utils import nt

    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    q_ct = ep.coefficient_moduli[:2]
    q_ks = ep.coefficient_moduli
    q_bsk = q_ct + rns.bsk_prime_pool(ep.poly_degree, len(q_ct), 32)
    n = ep.poly_degree
    nodes = 32 * BATCH  # widest expansion level: 32 nodes x 128 queries
    # (name, moduli, batch shape of the forward input, of the inverse input)
    cases = [
        ("ciphertext moduli (dim-0 query to Eval, dim-0 results)", q_ct, (55, BATCH, 2), (9, 2 * BATCH)),
        ("key-switching moduli (widest expansion level)", q_ks, (nodes, 2), (nodes, 2)),
        ("q + B_sk (BEHZ lift and floor)", q_bsk, (BATCH, 9, 2), (BATCH, 3)),
    ]
    max_err = {"ntt_forward": 0, "ntt_inverse": 0}
    for i, (label, moduli, fshape, ishape) in enumerate(cases):
        tables = ntt.build_ntt_tables(tuple(moduli), n, torch.device("cuda"))
        if tables.word_bits != 32:
            raise AssertionError(f"main-path moduli {moduli} did not take the 32-bit route")
        x = random_rows(moduli, fshape, n, seed + i)
        k = ntt_cuda.forward(x, tables)
        p = ntt.forward_ntt_plain(x, tables)
        max_err["ntt_forward"] = max(max_err["ntt_forward"], int((k - p).abs().max()))
        y = random_rows(moduli, ishape, n, seed + 10 + i)
        ki = ntt_cuda.inverse(y, tables)
        pi = ntt.inverse_ntt_plain(y, tables)
        max_err["ntt_inverse"] = max(max_err["ntt_inverse"], int((ki - pi).abs().max()))
        if not torch.equal(ntt_cuda.inverse(k, tables), x):
            raise AssertionError(f"kernel round trip failed: {label}")
        log(f"kernel check {label}: moduli {tuple(moduli)}, forward {tuple(x.shape)}, "
            f"inverse {tuple(y.shape)}: bit-equal to plain = {torch.equal(k, p) and torch.equal(ki, pi)}")
        del x, y, k, p, ki, pi
    if any(max_err.values()):
        raise AssertionError(f"kernels disagree with the plain version: {max_err}")

    # the 64-bit route at the widest main-path shape, with moduli in
    # [2^30, 2^31) that the plain version takes
    w64_route = tuple(nt.generate_primes([31] * 3, preferring_small=True, ntt_degree=n))
    tables = ntt.build_ntt_tables(w64_route, n, torch.device("cuda"))
    if tables.word_bits != 64:
        raise AssertionError(f"moduli {w64_route} did not take the 64-bit route")
    x = random_rows(w64_route, (nodes, 2), n, seed + 40)
    k = ntt_cuda.forward(x, tables)
    ki = ntt_cuda.inverse(x, tables)
    route64 = {}
    for name, got, plain in (("ntt_forward", k, ntt.forward_ntt_plain),
                             ("ntt_inverse", ki, ntt.inverse_ntt_plain)):
        err = int((got - plain(x, tables)).abs().max())
        max_err[name] = max(max_err[name], err)
        kern = ntt_cuda.forward if name == "ntt_forward" else ntt_cuda.inverse
        ms = cuda_ms(lambda: kern(x, tables), 20)
        bound = kernel_bound_ms(x.shape, w64_route, n)
        route64[name] = dict(shape=list(x.shape), moduli=list(w64_route), ms=ms, bound_ms=bound,
                             share_of_bound=bound / ms, max_abs_err=err)
        log(f"{name} 64-bit route: moduli {w64_route}, shape {tuple(x.shape)}: max |kernel - plain| "
            f"= {err}; kernel {ms:.4f} ms, byte bound {bound:.4f} ms ({100 * bound / ms:.1f}% of bound)")
    if not torch.equal(ntt_cuda.inverse(k, tables), x):
        raise AssertionError("64-bit route round trip failed")
    if any(max_err.values()):
        raise AssertionError(f"kernels disagree with the plain version: {max_err}")
    del x, k, ki
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, route64=route64)


def shape_timing(path: str, launch_shapes, batches: int) -> dict:
    """Each kernel at every shape one path's serving run launched it with:
    held bit-equal to its plain version on random residues, then timed:
    ms (mean of 20 launches after a warm-up; plain: of 3 on the int64
    route, of 1 on the wide route, whose plain NTT is far slower), ns per
    row, byte bound and its share, launches per batch; and, as a yardstick
    of the memory rate, one copy_ of the same tensor."""
    import torch

    from she_tpu_torch.ops import modarith, ntt, ntt_cuda

    kernels = {"ntt_forward": (ntt_cuda.forward, ntt.forward_ntt_plain),
               "ntt_inverse": (ntt_cuda.inverse, ntt.inverse_ntt_plain)}
    out = {name: [] for name in kernels}
    for (name, shape, moduli), count in sorted(launch_shapes.items(), key=lambda kv: (kv[0][0], -prod(kv[0][1]))):
        kern, plain = kernels[name]
        n = shape[-1]
        tables = ntt.build_ntt_tables(moduli, n, torch.device("cuda"))
        x = random_rows(moduli, shape[:-2], n, 50 + len(out[name]))
        err = int((kern(x, tables) - plain(x, tables)).abs().max())
        if err:
            raise AssertionError(f"{name} at {tuple(shape)}, moduli {moduli}: max |kernel - plain| = {err}")
        y = torch.empty_like(x)
        rows = x.numel() // n
        plain_iters = 1 if modarith.is_wide(max(moduli)) else 3
        ms = cuda_ms(lambda: kern(x, tables), 20)
        plain_ms = cuda_ms(lambda: plain(x, tables), plain_iters)
        copy_ms = cuda_ms(lambda: y.copy_(x), 20)
        bound = kernel_bound_ms(shape, moduli, n)
        row = dict(path=path, shape=list(shape), moduli=list(moduli), rows=rows, word_bits=tables.word_bits,
                   launches_per_batch=count / batches, max_abs_err=err, ms=ms, ns_per_row=1e6 * ms / rows,
                   plain_ms=plain_ms, plain_iters=plain_iters, copy_ms=copy_ms, bound_ms=bound,
                   share_of_bound=bound / ms)
        out[name].append(row)
        log(f"{path} {name} {tuple(shape)} ({rows} rows, {count / batches:g} per batch, {tables.word_bits}-bit "
            f"words): bit-equal to plain; kernel {ms:.4f} ms ({row['ns_per_row']:.2f} ns/row), plain "
            f"{plain_ms:.4f} ms (x{plain_iters}), copy_ {copy_ms:.4f} ms, byte bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f}% of bound)")
        del x, y
    torch.cuda.empty_cache()
    for name, rows in out.items():
        per_batch = sum(r["launches_per_batch"] * r["ms"] for r in rows)
        log(f"{path} {name}: launches x ms summed over the shapes of one batch = {per_batch:.4f} ms")
    return out


def random_residues(moduli, shape, degree, seed):
    """int64 [*shape, L, N] uniform residues, drawn on the card."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = [torch.randint(0, q, tuple(shape) + (degree,), generator=g, device="cuda") for q in moduli]
    return torch.stack(rows, dim=-2)


def dim0_bound(L, N, rows, d0, P, C, D) -> dict:
    """The least time of one dim-0 launch: the bytes it must move (the
    rows x d0 int8 digits of each (l, n), without the kernel's padding of
    d0, the int64 query read once, the int64 result written once) over the
    memory rate, and its int8 operations (2 D^2 C d0 P per (l, n)) over the
    int8 tensor-core rate; the larger bounds it."""
    nbytes = L * N * rows * d0 + d0 * P * L * N * 8 + C * P * L * N * 8
    ops = 2 * D * D * C * d0 * P * L * N
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
    return dict(bytes=nbytes, operations=ops, bytes_ms=bytes_ms, operations_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def digit_bmm_ms(digits, query, D: int) -> float:
    """The yardstick: the digit products alone as one torch.bmm over
    float32 digit operands [L*N, C*D, d0] x [L*N, d0, P*D] with TF32 off
    (every sum is an integer below 2^24, so float32 holds it exactly; held
    equal to a float64 bmm on 64 of the (l, n) before it is timed). It
    leaves out the digit split of the query and the recombination mod q."""
    import torch

    from she_tpu_torch.pir import serving

    L, N, rows, _ = digits.shape
    d0, P = query.shape[:2]
    a = digits[..., :d0].reshape(L * N, rows, d0).float()
    b = serving._query_digits(query, D).permute(1, 2, 3, 0, 4).reshape(L * N, d0, D * P).float()
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.bmm(a, b)
        exact = torch.bmm(a[:64].double(), b[:64].double())
        if not (torch.equal(out[:64].double(), exact) and float(exact.max()) < 2**24):
            raise AssertionError("the float32 digit bmm is not exact")
        del out, exact
        return cuda_ms(lambda: torch.bmm(a, b), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def dim0_case(label: str, moduli, C: int, d0: int, P: int, N: int, seed: int) -> dict:
    """The int8 dim-0 kernel at one shape on random residues: equal to the
    int64 / wide MAC (dim0_inner_products) bit for bit at the full shape
    and to the plain digit form on the first DIM0_CUT_N n; then timed
    (CUDA events: the kernel over 20 launches, the MAC over 3, the plain
    digit form once) beside the digit-bmm yardstick and the bound."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import digits as dg
    from she_tpu_torch.ops import dim0_cuda
    from she_tpu_torch.pir import serving

    D, L = dg.digit_count(moduli), len(moduli)
    db = random_residues(moduli, (C, d0), N, seed)
    query = random_residues(moduli, (d0, P), N, seed + 1)
    ctx = get_poly_context(N, tuple(moduli), 64, db.device)
    digits = serving.pack_database_chunk_digits(db, ctx)
    got = dim0_cuda.dim0_int8(digits, query, ctx)
    err_mac = int((got - serving.dim0_inner_products(db, query, ctx)).abs().max())
    del got
    cut = min(DIM0_CUT_N, N)
    cut_digits = serving.pack_database_chunk_digits(db[..., :cut].contiguous(), ctx)
    cut_query = query[..., :cut].contiguous()
    err_plain = int((dim0_cuda.dim0_int8(cut_digits, cut_query, ctx)
                     - serving.dim0_inner_products_int8(cut_digits, cut_query, ctx)).abs().max())
    if err_mac or err_plain:
        raise AssertionError(f"{label} dim0_int8 at C={C}, d0={d0}, P={P}, N={N}: max |kernel - MAC| = {err_mac}, "
                             f"max |kernel - plain digit form| = {err_plain}")
    ms = cuda_ms(lambda: dim0_cuda.dim0_int8(digits, query, ctx), 20)
    mac_ms = cuda_ms(lambda: serving.dim0_inner_products(db, query, ctx), 3)
    plain_ms = cuda_ms(lambda: serving.dim0_inner_products_int8(digits, query, ctx), 1)
    library_ms = digit_bmm_ms(digits, query, D)
    bound = dim0_bound(L, N, digits.shape[2], d0, P, C, D)
    row = dict(path=label, digits_shape=list(digits.shape), query_shape=list(query.shape), moduli=list(moduli),
               digits=D, C=C, d0=d0, P=P, max_abs_err=max(err_mac, err_plain), plain_check_n=cut, ms=ms,
               mac_ms=mac_ms, plain_ms=plain_ms, library_ms=library_ms, **bound,
               share_of_bound=bound["bound_ms"] / ms)
    log(f"{label} dim0_int8 C={C} d0={d0} P={P} L={L} N={N} ({D} digits): equal to the MAC and (first {cut} n) "
        f"to the plain digit form; kernel {ms:.4f} ms, MAC {mac_ms:.4f} ms, plain digit form {plain_ms:.4f} ms, "
        f"digit bmm (float32, products only) {library_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['operations']} int8 operations), "
        f"{100 * bound['bound_ms'] / ms:.1f}% of bound")
    del db, query, digits, cut_digits, cut_query
    torch.cuda.empty_cache()
    return row


def dim0_shape_timing(path: str, dim0_shapes, batches: int) -> list:
    """dim0_case at every shape one path's serving run launched the int8
    dim-0 kernel with."""
    from she_tpu_torch.ops import digits as dg

    out = []
    for (digits_shape, query_shape, moduli), count in sorted(dim0_shapes.items(), key=lambda kv: -prod(kv[0][1])):
        L, N, rows, _ = digits_shape
        d0, P = query_shape[:2]
        row = dim0_case(path, moduli, rows // dg.digit_count(moduli), d0, P, N, 60 + len(out))
        row["launches_per_batch"] = count / batches
        out.append(row)
    return out


def profile_batch(path: str, server, queries, ek) -> dict:
    """One more batch under torch.profiler: device time by kernel name,
    kernel count, and the device's idle share of the batch's wall time
    (profiling slows the host, so this wall time exceeds the plain one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        by_name[evt.key] = by_name.get(evt.key, 0.0) + us
        launches += evt.count
    busy_us = sum(by_name.values())
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device work in the profiled batch")
    kernel_ms = {k: sum(us for name, us in by_name.items() if f"{k}_kernel" in name) / 1e3
                 for k in ("ntt_forward", "ntt_inverse", "dim0_int8")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    log(f"[{path}] profiled batch: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {launches} device kernels and copies")
    for name, us in top:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {name[:110]}")
    log(f"[{path}]  the port's kernels in the profiled batch: {kernel_ms} ms, "
        f"{100 * sum(kernel_ms.values()) * 1e3 / busy_us:.1f}% of device time")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us,
                device_launches=launches, top_ms={k: v / 1e3 for k, v in top}, kernel_ms=kernel_ms)


def main_path(path: str, seed: int, batches: int) -> dict:
    """One path of the port's batched MulPIR serving, as a user drives it."""
    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    params, scalar_bits, fresh_queries = PATHS[path]
    ep = paramsmod.from_predefined(params, scalar_bits=scalar_bits)
    ctx = bfv.get_bfv_context(ep)  # the CUDA card
    config = ip.IndexPirConfig(
        entry_count=ENTRY_COUNT, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    parameter = ip.generate_parameter(config, ctx)
    log(f"[{path}] {params} at {scalar_bits}-bit scalars, moduli {ep.coefficient_moduli}, "
        f"t = {ep.plaintext_modulus}")
    log(f"[{path}] PIR parameter: dims {parameter.dimensions}, {parameter.expanded_query_count} expanded "
        f"ciphertexts per query, Galois elements {parameter.evaluation_key_config.galois_elements}")
    rng = np.random.default_rng(seed)
    database = rng.integers(0, 256, size=(ENTRY_COUNT, 1), dtype=np.uint8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = ip.MulPirServer.process(database, ctx, parameter)
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    log(f"[{path}] database processed in {process_s:.3f} s: {processed.count} plaintexts, "
        f"{int(processed.present.sum())} non-zero")

    t0 = time.perf_counter()
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = ip.MulPirClient(parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    torch.cuda.synchronize()
    log(f"[{path}] keys and server ready in {time.perf_counter() - t0:.3f} s")

    all_indices, all_queries = [], []
    t0 = time.perf_counter()
    for b in range(batches):
        if fresh_queries or b == 0:
            indices = [int(i) for i in rng.integers(0, ENTRY_COUNT, size=BATCH)]
            queries = [client.generate_query([i], sk) for i in indices]
        all_indices.append(indices)
        all_queries.append(queries)
    torch.cuda.synchronize()
    distinct = batches * BATCH if fresh_queries else BATCH
    log(f"[{path}] {distinct} queries generated in {time.perf_counter() - t0:.3f} s "
        f"({'fresh queries in each batch' if fresh_queries else 'the same queries in each batch'})")

    # the main path, with the launch counts read around it
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s, all_responses = [], []
    for queries in all_queries:
        t0 = time.perf_counter()
        responses = server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        all_responses.append(responses)
    counts = read_counts(path, server.use_dim0_int8)
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()
    for i, s in enumerate(batch_s):
        log(f"[{path}] batch {i}: {s:.4f} s, {BATCH / s:.2f} queries/s")
    log(f"[{path}] dim-0 form: {'int8 digits (dim0_int8 kernel)' if server.use_dim0_int8 else 'MAC'}; "
        f"kernel launches over {batches} batches: {launches}, a batch: "
        f"{ {k: v / batches for k, v in launches.items()} }; plain NTT on CUDA: none")
    log(f"[{path}] peak device memory during serving: {peak} bytes ({peak / 2**30:.3f} GiB)")

    t0 = time.perf_counter()
    for indices, responses in zip(all_indices, all_responses):
        for index, response in zip(indices, responses):
            got = client.decrypt(response, [index], sk)
            if got != [database[index].tobytes()]:
                raise AssertionError(f"[{path}] query for entry {index} decrypted to {got}")
    log(f"[{path}] all {batches * BATCH} answers decrypt to their entries ({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    single_ctx = ctx.ciphertext_context.get_context(1)
    budgets = []
    for responses in all_responses:
        stacked = torch.stack([r.ciphertexts[0][0].stacked() for r in responses])  # [B, 2, 1, N]
        budgets.append(bfv.noise_budget(bfv.Ciphertext.from_stacked(ctx, stacked, single_ctx), sk))
    min_budget = min(budgets)
    if not min_budget > 0:
        raise AssertionError(f"[{path}] a response has no noise budget left: {min_budget}")
    log(f"[{path}] smallest noise budget of the {batches * BATCH} responses: {min_budget:.3f} bits "
        f"({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    reference = ip.MulPirServer(parameter, ctx, [processed])
    want = reference.compute_response(all_queries[0][0], ek)
    got = all_responses[0][0]
    for wc, gc in zip(want.ciphertexts[0], got.ciphertexts[0]):
        for wp, gp in zip(wc.polys, gc.polys):
            if not torch.equal(wp.data, gp.data):
                raise AssertionError(f"[{path}] batched response differs from the per-query server")
    log(f"[{path}] batched response of query 0 is bit-identical to the per-query server's "
        f"({time.perf_counter() - t0:.3f} s)")

    stages = stage_split(server, all_queries[0], ek, all_responses[0])
    log(f"[{path}] device ms by stage (CUDA events, one batch): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    steady = batch_s[1:] or batch_s
    profiled = profile_batch(path, server, all_queries[0], ek)
    # the profiler slows the host; against the unprofiled batch time the
    # same device work leaves this idle share
    profiled["idle_share_of_steady_batch"] = 1 - profiled["busy_ms"] / (1e3 * statistics.median(steady))
    log(f"[{path}] device idle share of the median unprofiled batch: {profiled['idle_share_of_steady_batch']:.3f}")
    return dict(
        path=path, params=params, scalar_bits=scalar_bits, fresh_queries=fresh_queries,
        dim0_form="int8" if server.use_dim0_int8 else "mac", stages_ms=stages,
        profile=profiled, min_noise_budget=min_budget,
        process_s=process_s, batch_s=batch_s, first_batch_s=batch_s[0],
        median_s_per_batch=statistics.median(steady), max_s_per_batch=max(steady),
        steady_batches=len(steady), queries_per_s=BATCH / statistics.median(steady),
        peak_bytes=peak, launches=launches,
        launches_per_batch={k: v / batches for k, v in launches.items()},
        launch_shapes=counts["launch_shapes"], dim0_shapes=counts["dim0_shapes"], batches=batches,
    )


def keyword_rows(seed: int, count: int, value_size: int, absent: int):
    """`count` distinct 8-byte keywords with `value_size`-byte values, and
    `absent` further distinct keywords that are not in the table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw = np.unique(rng.integers(0, 2**63 - 1, size=count + absent + 16, dtype=np.int64))
    raw = rng.permutation(raw)[: count + absent]
    if raw.size != count + absent:
        raise AssertionError("too few distinct keywords drawn")
    blob = raw.astype(">u8").tobytes()
    keywords = [blob[8 * i : 8 * i + 8] for i in range(count + absent)]
    values = rng.integers(0, 256, size=count * value_size, dtype=np.uint8).tobytes()
    rows = {keywords[i]: values[i * value_size : (i + 1) * value_size] for i in range(count)}
    return rows, keywords[count:]


def keyword_batches(rng, present: list, absent: list, batches: int, batch: int) -> list:
    """Per batch, `batch` keywords; every ABSENT_EVERY-th is absent."""
    out = []
    for _ in range(batches):
        kws = []
        for i in range(batch):
            pool = absent if i % ABSENT_EVERY == ABSENT_EVERY - 1 else present
            kws.append(pool[int(rng.integers(0, len(pool)))])
        out.append(kws)
    return out


def assert_same_responses(label: str, got: list, want: list) -> None:
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} responses, expected {len(want)}")
    for g, w in zip(got, want):
        for g_reply, w_reply in zip(g.ciphertexts, w.ciphertexts, strict=True):
            for gc, wc in zip(g_reply, w_reply, strict=True):
                if not torch.equal(gc.stacked(), wc.stacked()):
                    raise AssertionError(f"{label}: responses differ")


def serve_over_wire(ctx, server, wire_queries: list, ek, indices_count: int):
    """The server's side of one batch: query bytes in, answer bytes out.
    Returns (queries, responses, answer bytes, deserialize s, serve s,
    serialize s); the serve time ends in a synchronize."""
    import torch

    from she_tpu_torch.core.poly import COEFF
    from she_tpu_torch.io import serialize as ser
    from she_tpu_torch.pir import index_pir as ip

    t0 = time.perf_counter()
    flat = ser.deserialize_ciphertexts([s for q in wire_queries for s in q], ctx, COEFF)
    n = len(wire_queries[0])
    queries = [ip.Query(flat[i * n : (i + 1) * n], indices_count) for i in range(len(wire_queries))]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    responses = server.compute_response_batch(queries, ek)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    answers = [
        [[ser.serialize_ciphertext(ct, for_decryption=True) for ct in reply] for reply in r.ciphertexts]
        for r in responses
    ]
    t3 = time.perf_counter()
    return queries, responses, answers, t1 - t0, t2 - t1, t3 - t2


def read_answer(ctx, answer: list):
    """The client's side: answer bytes -> ip.Response."""
    from she_tpu_torch.core.poly import COEFF
    from she_tpu_torch.io import serialize as ser
    from she_tpu_torch.pir import index_pir as ip

    return ip.Response([ser.deserialize_ciphertexts(reply, ctx, COEFF, moduli_count=1) for reply in answer])


def stage_split(server, queries: list, ek, want: list) -> dict:
    """One batch through compute_response_batch with a CUDA event recorded
    at each of its stage marks: device ms of stacking, expansion, dim-0
    (query to Eval, MAC, columns to Coeff), BEHZ + relinearization, and mod
    switch, each span ending at its stage's mark. The answers must equal
    `want`, the same batch's earlier answers."""
    import torch

    names = {"stack": "stack", "expand": "expansion", "dim0": "dim0",
             "fold_dimensions": "behz_relinearize", "mod_switch": "mod_switch"}
    marks = []

    def mark(stage: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((names[stage], e))

    torch.cuda.synchronize()
    mark("stack")  # the start: the first span is the stacking
    got = server.compute_response_batch(queries, ek, on_stage=mark)
    torch.cuda.synchronize()
    assert_same_responses("stage split", got, want)
    ms = dict.fromkeys(names.values(), 0.0)
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        ms[stage] += a.elapsed_time(b)
    ms["total"] = marks[0][1].elapsed_time(marks[-1][1])
    return ms


def keyword_path(seed: int, batches: int) -> tuple[dict, tuple]:
    """Keyword PIR as a user drives it: process_database, the client, the
    wire, BatchedKeywordPirServer (cell keyword_1m_x_1B_w32_b128). Returns
    the path's numbers, and (context, processed database, rows, absent
    keywords) for the service phase."""
    import random

    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.io import serialize as ser
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import process_database as pd
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = "keyword"
    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    ctx = bfv.get_bfv_context(ep)  # the CUDA card
    absent_count = batches * BATCH // ABSENT_EVERY
    t0 = time.perf_counter()
    rows, absent = keyword_rows(seed + 1, KEYWORD_COUNT, 1, absent_count)
    log(f"[{label}] {len(rows)} keywords x 1 byte and {len(absent)} absent keywords made in "
        f"{time.perf_counter() - t0:.3f} s")
    bucket_size = kp.default_max_serialized_bucket_size(1, ep.bytes_per_plaintext)
    config = kp.KeywordPirConfig(
        dimension_count=2, cuckoo_table_config=kp.CuckooTableConfig.default_keyword_pir(bucket_size),
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    arguments = pd.Arguments(pd.KeywordDatabaseConfig(kp.Sharding("shardCount", 1), config), ep)
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = pd.process(rows, arguments, rng=random.Random(seed),
                           on_event=lambda kind, detail: events.append((kind, detail, time.perf_counter())))
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    cuckoo_s = [e[2] for e in events if e[0] == "insertedEntry"][-1] - t0
    shard = processed.shards["0"]
    parameter = shard.pir_parameter
    expansions = [e[1] for e in events if e[0] == "expandedTable"]
    log(f"[{label}] cuckoo table: bucket bound {bucket_size} bytes, created with "
        f"{[e[1] for e in events if e[0] == 'createdTable']} buckets, expanded to {expansions}; "
        f"built in {cuckoo_s:.3f} s; processed in {process_s:.3f} s in all")
    log(f"[{label}] PIR parameter: {parameter.entry_count} buckets per table of at most "
        f"{parameter.entry_size_in_bytes} bytes, dims {parameter.dimensions}, "
        f"{parameter.expanded_query_count * 2} expanded ciphertexts per query, "
        f"{shard.database.count} plaintexts ({int(shard.database.present.sum())} non-zero), "
        f"{shard.database.data.numel() * 8} bytes on the device")

    t0 = time.perf_counter()
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, parameter, ctx)
    ek_client = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    ek = ser.deserialize_evaluation_key(ser.serialize_evaluation_key(ek_client), ctx)
    server = serving.BatchedKeywordPirServer(ctx, shard)
    torch.cuda.synchronize()
    log(f"[{label}] keys made, sent through the wire, and server ready in {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(seed + 2)
    present = list(rows)
    all_keywords = keyword_batches(rng, present, absent, batches, BATCH)
    t0 = time.perf_counter()
    wire_batches = [
        [[ser.serialize_ciphertext(ct) for ct in client.generate_query(kw, sk).ciphertexts] for kw in kws]
        for kws in all_keywords
    ]
    query_s = time.perf_counter() - t0
    if any(s.kind != "seeded" for batch in wire_batches for q in batch for s in q):
        raise AssertionError("a fresh query ciphertext was not serialized seeded")
    query_bytes = sum(len(s.polys) + len(s.seed) for s in wire_batches[0][0])
    log(f"[{label}] {batches * BATCH} keyword queries generated and serialized in {query_s:.3f} s "
        f"({query_bytes} bytes each, seeded)")

    # the main path, with the launch counts read around it
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, batch_s, wire_in_s, wire_out_s, segments = [], [], [], [], []
    for wire_queries in wire_batches:
        before = torch.cuda.memory_stats()
        queries, responses, answers, d_s, s_s, o_s = serve_over_wire(ctx, server, wire_queries, ek, 2)
        after = torch.cuda.memory_stats()
        # device segments the caching allocator had to allocate (cudaMalloc)
        # and retries after freeing its cache, in this batch
        segments.append({k: after.get(k, 0) - before.get(k, 0)
                         for k in ("segment.all.allocated", "num_alloc_retries")})
        served.append((queries, responses, answers))
        batch_s.append(s_s)
        wire_in_s.append(d_s)
        wire_out_s.append(o_s)
    use_int8 = server.index_server.use_dim0_int8
    counts = read_counts(label, use_int8)
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()
    for i in range(batches):
        log(f"[{label}] batch {i}: served in {batch_s[i]:.4f} s ({BATCH / batch_s[i]:.2f} keyword queries/s); "
            f"wire: {wire_in_s[i]:.4f} s to read {BATCH} queries, {wire_out_s[i]:.4f} s to write the answers; "
            f"allocator: {segments[i]}")
    log(f"[{label}] dim-0 form: {'int8 digits (dim0_int8 kernel)' if use_int8 else 'MAC'}; kernel launches "
        f"over {batches} batches (wire included): {launches}, a batch: "
        f"{ {k: v / batches for k, v in launches.items()} }; plain NTT on CUDA: none")
    log(f"[{label}] peak device memory during serving: {peak} bytes ({peak / 2**30:.3f} GiB)")

    t0 = time.perf_counter()
    answer_bytes = 0
    for kws, (_, _, answers) in zip(all_keywords, served):
        for kw, answer in zip(kws, answers):
            answer_bytes = sum(len(s.polys) for reply in answer for s in reply)
            got = client.decrypt(read_answer(ctx, answer), kw, sk)
            if got != rows.get(kw):
                raise AssertionError(f"[{label}] keyword {kw.hex()} decrypted to {got!r}, expected {rows.get(kw)!r}")
    n_absent = sum(kw not in rows for kws in all_keywords for kw in kws)
    log(f"[{label}] all {batches * BATCH} answers read back: {batches * BATCH - n_absent} present keywords "
        f"gave their values, {n_absent} absent ones None ({answer_bytes} bytes an answer; "
        f"{time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    budgets = []
    single_ctx = ctx.ciphertext_context.get_context(1)
    for _, responses, _ in served:
        for qi in range(2):
            stacked = torch.stack([r.ciphertexts[qi][0].stacked() for r in responses])
            budgets.append(bfv.noise_budget(bfv.Ciphertext.from_stacked(ctx, stacked, single_ctx), sk))
    min_budget = min(budgets)
    if not min_budget > 0:
        raise AssertionError(f"[{label}] a response has no noise budget left: {min_budget}")
    log(f"[{label}] smallest noise budget of the answers: {min_budget:.3f} bits ({time.perf_counter() - t0:.3f} s)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = server.compute_response_stream([q for q, _, _ in served], ek)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    assert_same_responses("stream", stream, [r for _, responses, _ in served for r in responses])
    log(f"[{label}] compute_response_stream over the {batches} batches: {stream_s:.4f} s, "
        f"{stream_s / batches:.4f} s a batch, answers equal to the batched ones")

    t0 = time.perf_counter()
    queries0, responses0, answers0 = served[0]
    want = kp.KeywordPirServer(ctx, shard).compute_response(queries0[0], ek)
    assert_same_responses("per-query server", [responses0[0]], [want])
    want_bytes = [[ser.serialize_ciphertext(ct, for_decryption=True) for ct in reply] for reply in want.ciphertexts]
    if want_bytes != answers0[0]:
        raise AssertionError(f"[{label}] answer bytes differ from the per-query server's")
    log(f"[{label}] batched answer of query 0 and its bytes are identical to the per-query server's "
        f"({time.perf_counter() - t0:.3f} s)")

    stages = stage_split(server, queries0, ek, responses0)
    log(f"[{label}] device ms by stage (CUDA events, one batch): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    steady = batch_s[1:] or batch_s
    profiled = profile_batch(label, server, queries0, ek)
    profiled["idle_share_of_steady_batch"] = 1 - profiled["busy_ms"] / (1e3 * statistics.median(steady))
    log(f"[{label}] device idle share of the median unprofiled batch: {profiled['idle_share_of_steady_batch']:.3f}")
    wire_s = [a + b for a, b in zip(wire_in_s, wire_out_s)]
    return dict(
        path=label, cell=KEYWORD_CELL, params=PARAMS, scalar_bits=32, keywords=len(rows),
        bucket_size=bucket_size, dimensions=list(parameter.dimensions), buckets_per_table=parameter.entry_count,
        entry_size=parameter.entry_size_in_bytes, expansions=expansions, cuckoo_s=cuckoo_s, process_s=process_s,
        query_s=query_s, query_bytes=query_bytes, answer_bytes=answer_bytes, batch_s=batch_s,
        first_batch_s=batch_s[0], median_s_per_batch=statistics.median(steady), max_s_per_batch=max(steady),
        steady_batches=len(steady), queries_per_s=BATCH / statistics.median(steady), wire_in_s=wire_in_s,
        wire_out_s=wire_out_s, wire_s_per_batch=statistics.median(wire_s), stream_s=stream_s, segments=segments,
        stages_ms=stages, profile=profiled, min_noise_budget=min_budget, peak_bytes=peak, launches=launches,
        launches_per_batch={k: v / batches for k, v in launches.items()}, launch_shapes=counts["launch_shapes"],
        dim0_shapes=counts["dim0_shapes"], dim0_form="int8" if use_int8 else "mac", batches=batches,
        absent_queries=n_absent,
    ), (ctx, processed, rows, absent)


def large_value_path(seed: int) -> dict:
    """Keyword PIR with values larger than half a plaintext: every bucket
    spans two plaintexts (the multi-chunk route of database processing and
    of the batched server)."""
    import random

    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = "keyword_large"
    count, value_size, n_queries = LARGE_VALUES
    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    ctx = bfv.get_bfv_context(ep)
    rows, _ = keyword_rows(seed + 3, count, value_size, 0)
    bucket_size = kp.default_max_serialized_bucket_size(value_size, ep.bytes_per_plaintext)
    config = kp.KeywordPirConfig(2, kp.CuckooTableConfig.default_keyword_pir(bucket_size))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = kp.KeywordPirServer.process(list(rows.items()), config, ctx, rng=random.Random(seed))
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    parameter = processed.pir_parameter
    chunks = ip.chunk_count(parameter, ctx)
    if chunks < 2:
        raise AssertionError(f"[{label}] buckets of {parameter.entry_size_in_bytes} bytes fit one plaintext")
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr((seed + 1).to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(processed.keyword_pir_parameter, parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    rng = np.random.default_rng(seed + 4)
    names = list(rows)
    keywords = [names[int(i)] for i in rng.choice(count, size=n_queries, replace=False)]
    queries = [client.generate_query(kw, sk) for kw in keywords]
    server = serving.BatchedKeywordPirServer(ctx, processed)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = server.compute_response_batch(queries, ek)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    counts = read_counts(label, server.index_server.use_dim0_int8)
    launches = counts["launches"]
    for kw, response in zip(keywords, responses):
        if client.decrypt(response, kw, sk) != rows[kw]:
            raise AssertionError(f"[{label}] keyword {kw.hex()} did not decrypt to its value")
    want = kp.KeywordPirServer(ctx, processed).compute_response(queries[0], ek)
    assert_same_responses(label, [responses[0]], [want])
    log(f"[{label}] {count} keywords x {value_size} bytes: buckets of at most {parameter.entry_size_in_bytes} "
        f"bytes in {chunks} plaintexts each, dims {parameter.dimensions}, processed in {process_s:.3f} s; "
        f"{n_queries} queries served in one batch in {batch_s:.4f} s; every value came back; query 0's "
        f"answer equals the per-query server's; kernel launches {launches}")
    return dict(path=label, keywords=count, value_size=value_size, queries=n_queries, chunks=chunks,
                dimensions=list(parameter.dimensions), process_s=process_s, batch_s=batch_s,
                launches=launches, launch_shapes=counts["launch_shapes"], dim0_shapes=counts["dim0_shapes"],
                batches=1)


def _serve_request(service, usecase: str, request) -> tuple[bytes, float]:
    """The server's side of one PIR request: bytes in, bytes out, and the
    seconds it took (ending in a synchronize)."""
    import torch

    from she_tpu_torch.io import pb

    t0 = time.perf_counter()
    parsed = pb.api_pir_pb2.PIRRequest.FromString(request.SerializeToString())
    answer = service.handle_pir_request(usecase, parsed).SerializeToString()
    torch.cuda.synchronize()
    return answer, time.perf_counter() - t0


def _upload_keys(service, ctx, ek, identifier: bytes) -> int:
    """The client's evaluation key through an EvaluationKeys message, as
    bytes; returns their size."""
    from she_tpu_torch.io import pb
    from she_tpu_torch.io import proto_conversion as pc

    keys = pb.api_shared_pb2.EvaluationKeys()
    entry = keys.keys.add()
    entry.metadata.timestamp = 1
    entry.metadata.identifier = identifier
    entry.evaluation_key.CopyFrom(pc.evaluation_key_to_proto(ek))
    raw = keys.SerializeToString()
    service.store_evaluation_keys(pb.api_shared_pb2.EvaluationKeys.FromString(raw), ctx)
    return len(raw)


def _pir_request(query, config_id: bytes, shard_id: str, identifier: bytes):
    from she_tpu_torch.io import pb
    from she_tpu_torch.io import proto_conversion as pc

    request = pb.api_pir_pb2.PIRRequest()
    request.query.CopyFrom(pc.pir_query_to_proto(query))
    request.evaluation_key_metadata.identifier = identifier
    request.configuration_hash = config_id
    request.shard_id = shard_id
    return request


def _read_response(ctx, answer: bytes):
    from she_tpu_torch.io import pb
    from she_tpu_torch.io import proto_conversion as pc

    return pc.pir_response_from_proto(list(pb.api_pir_pb2.PIRResponse.FromString(answer).replies), ctx)


def service_phase(ctx, processed, rows: dict, absent: list, seed: int) -> dict:
    """The keyword cell's processed 1M-keyword database behind PirService,
    driven as a client of the protobuf envelope: a ConfigRequest, an
    EvaluationKeys upload and SERVICE_REQUESTS PIRRequests (the last for an
    absent keyword), each sent and answered as bytes; every answer is
    decrypted and checked. The service answers on the per-query
    KeywordPirServer, as she_tpu's does."""
    import numpy as np
    import torch

    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.io import pb
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import service as svc
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = "service"
    service = svc.PirService()
    service.add_keyword_pir_usecase(KEYWORD_CELL, ctx, processed)
    request = pb.api_pb2.ConfigRequest()
    request.usecases.append(KEYWORD_CELL)
    config_bytes = service.handle_config_request(
        pb.api_pb2.ConfigRequest.FromString(request.SerializeToString())).SerializeToString()
    config = pb.api_pb2.ConfigResponse.FromString(config_bytes).configs[KEYWORD_CELL]
    shard_config = config.pir_config.shard_configs[0]
    shard = processed.shards[shard_config.shard_id]
    if (list(shard_config.dimensions), shard_config.num_entries, shard_config.entry_size) != (
            list(shard.pir_parameter.dimensions), shard.pir_parameter.entry_count,
            shard.pir_parameter.entry_size_in_bytes):
        raise AssertionError(f"[{label}] the served config does not describe the shard: {shard_config}")
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr((seed + 7).to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"service-evaluation-key-err-seed!"))
    key_bytes = _upload_keys(service, ctx, ek, b"client-1")
    rng = np.random.default_rng(seed + 8)
    present = list(rows)
    keywords = [present[int(i)] for i in rng.integers(0, len(present), size=SERVICE_REQUESTS - 1)] + [absent[0]]
    reset_counts()
    torch.cuda.synchronize()
    request_s, answer_bytes = [], 0
    for kw in keywords:
        shard_id = str(processed.shards[shard_config.shard_id].keyword_pir_parameter.sharding_function.shard_index(
            kw, len(processed.shards)))
        request = _pir_request(client.generate_query(kw, sk), bytes(config.config_id), shard_id, b"client-1")
        answer, seconds = _serve_request(service, KEYWORD_CELL, request)
        request_s.append(seconds)
        answer_bytes = len(answer)
        got = client.decrypt(_read_response(ctx, answer), kw, sk)
        if got != rows.get(kw):
            raise AssertionError(f"[{label}] keyword {kw.hex()} came back as {got!r}, expected {rows.get(kw)!r}")
    counts = read_counts(label, False)
    log(f"[{label}] PirService over the {len(rows)}-keyword database: config {len(config_bytes)} bytes, "
        f"evaluation keys {key_bytes} bytes; {len(keywords)} PIR requests as bytes ({len(keywords) - 1} present "
        f"keywords gave their values, 1 absent gave None; {answer_bytes} bytes an answer); seconds a request "
        f"(parse, serve, serialize): {[round(x, 4) for x in request_s]}, median {statistics.median(request_s):.4f} s; "
        f"kernel launches {counts['launches']}")
    return dict(path=label, requests=len(keywords), request_s=request_s, median_request_s=statistics.median(request_s),
                config_bytes=len(config_bytes), evaluation_key_bytes=key_bytes, answer_bytes=answer_bytes,
                launches=counts["launches"], launch_shapes=counts["launch_shapes"],
                dim0_shapes=counts["dim0_shapes"], batches=1)


def keyword_and_service(seed: int, batches: int) -> dict:
    """The keyword cell, then the service phase over its processed
    database (freed once both are done)."""
    keyword, state = keyword_path(seed, batches)
    return {"keyword": keyword, "service": service_phase(*state, seed)}


def spir_phase(seed: int) -> dict:
    """Symmetric PIR, a check phase: SPIR[0] keywords sealed through
    process(..., symmetric_pir_config=...) (one pure-Python OPRF evaluation
    a row, so not at the cell's million), then SPIR[1] lookups (SPIR[2]
    absent) through PirService: an OPRFRequest for the oblivious keyword
    and the entry key, then a PIRRequest for the oblivious keyword; each
    value is unsealed with the port's AES-GCM and checked."""
    import hashlib
    import random

    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.io import pb
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import oprf
    from she_tpu_torch.pir import process_database as pd
    from she_tpu_torch.pir import service as svc
    from she_tpu_torch.pir import symmetric_pir as spir
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = "spir"
    count, lookups, n_absent = SPIR
    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    ctx = bfv.get_bfv_context(ep)
    rows, absent = keyword_rows(seed + 9, count, 1, n_absent)
    spir_config = spir.SymmetricPirConfig(bytes(16) + hashlib.sha256(b"oprf key %d" % seed).digest())
    sealed_size = 1 + spir_config.config_type.tag_size
    bucket_size = kp.default_max_serialized_bucket_size(sealed_size, ep.bytes_per_plaintext)
    config = kp.KeywordPirConfig(2, kp.CuckooTableConfig.default_keyword_pir(bucket_size))
    arguments = pd.Arguments(pd.KeywordDatabaseConfig(kp.Sharding("shardCount", 1), config), ep,
                             symmetric_pir_config=spir_config)
    t0 = time.perf_counter()
    processed = pd.process(rows, arguments, rng=random.Random(seed))
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    service = svc.PirService()
    service.add_keyword_pir_usecase(label, ctx, processed)
    service.add_oprf_usecase(b"spir-oprf", spir_config)
    config_id = bytes(service.handle_config_request(pb.api_pb2.ConfigRequest()).configs[label].config_id)
    shard = processed.shards["0"]
    oprf_client = spir.OprfClient(spir_config.client_config())
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr((seed + 10).to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, ctx)
    _upload_keys(service, ctx, client.generate_evaluation_key(sk, nist_aes128_ctr(b"spir-evaluation-key-err-seed-32!")),
                 b"spir-client")
    keywords = list(rows)[: lookups - n_absent] + absent[:n_absent]
    reset_counts()
    torch.cuda.synchronize()
    oprf_s, pir_s = [], []
    for kw in keywords:
        t0 = time.perf_counter()
        blinded = oprf_client.query_context(kw)
        request = pb.api_pir_pb2.OPRFRequest(query_element=blinded.query, config_id=b"spir-oprf")
        raw = service.handle_oprf_request(
            pb.api_pir_pb2.OPRFRequest.FromString(request.SerializeToString())).SerializeToString()
        response = pb.api_pir_pb2.OPRFResponse.FromString(raw)
        parsed = oprf_client.parse(oprf.BlindEvaluation(bytes(response.evaluated_element), bytes(response.proof)),
                                   blinded)
        oprf_s.append(time.perf_counter() - t0)
        query = client.generate_query(parsed.oblivious_keyword, sk)
        answer, seconds = _serve_request(service, label, _pir_request(query, config_id, "0", b"spir-client"))
        pir_s.append(seconds)
        sealed = client.decrypt(_read_response(ctx, answer), parsed.oblivious_keyword, sk)
        got = None if sealed is None else oprf_client.decrypt(sealed, parsed)
        if got != rows.get(kw):
            raise AssertionError(f"[{label}] keyword {kw.hex()} came back as {got!r}, expected {rows.get(kw)!r}")
    counts = read_counts(label, False)
    log(f"[{label}] {count} keywords sealed (OPRF P-384 + AES-192-GCM) and processed in {process_s:.3f} s "
        f"({1e3 * process_s / count:.1f} ms a row); {len(keywords)} lookups ({n_absent} absent): every present "
        f"value unsealed to its value, every absent keyword gave None; OPRF round trip median "
        f"{statistics.median(oprf_s):.4f} s, PIR request median {statistics.median(pir_s):.4f} s; "
        f"kernel launches {counts['launches']}")
    return dict(path=label, keywords=count, lookups=len(keywords), absent=n_absent, process_s=process_s,
                oprf_s=oprf_s, pir_request_s=pir_s, launches=counts["launches"],
                launch_shapes=counts["launch_shapes"], dim0_shapes=counts["dim0_shapes"], batches=1)


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    built = kernel_build.build()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s: {built}")
    for name in built:
        for line in ptxas_lines(name):
            log(f"  {name}: {line}")

    checked = kernel_phase(args.seed)
    paths, shapes, dim0_rows = {}, {"ntt_forward": [], "ntt_inverse": []}, []
    # each phase returns its paths' results by name
    phases = [lambda path=path: {path: main_path(path, args.seed, args.batches)} for path in PATHS]
    phases += [lambda: keyword_and_service(args.seed, args.batches),
               lambda: {"keyword_large": large_value_path(args.seed)},
               lambda: {"spir": spir_phase(args.seed)}]
    for drive in phases:
        for path, result in drive().items():
            paths[path] = result
            for name, rows in shape_timing(path, result["launch_shapes"], result["batches"]).items():
                shapes[name].extend(rows)
            dim0_rows += dim0_shape_timing(path, result["dim0_shapes"], result["batches"])
        torch.cuda.empty_cache()
    # the int8 form once at the w64 path's dim-0 shape (8 digits), which serves the MAC
    w64_moduli = paramsmod.from_predefined(PATHS["w64"][0], scalar_bits=64).coefficient_moduli[:-1]
    w64_check = dim0_case("w64_check", w64_moduli, 4, 11, 2 * BATCH, 8192, 90)

    kernels = []
    for name, line in (("ntt_forward", 217), ("ntt_inverse", 261)):
        widest = max(shapes[name], key=lambda r: prod(r["shape"]))
        kernels.append(dict(
            name=name, route="cuda", source="she_tpu_torch/csrc/ntt.cu",
            replaces=f"she_tpu/ops/ntt_pallas.py:{line}",
            launches=sum(p["launches"][name] for p in paths.values()),
            max_abs_err=max([checked["max_abs_err"][name]] + [r["max_abs_err"] for r in shapes[name]]),
            ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"],
            bound_by="bytes", library_ms=None, widest_shape=widest["shape"], widest_path=widest["path"],
            launches_by_path={p: v["launches"][name] for p, v in paths.items()},
            shapes=shapes[name], route64=checked["route64"][name],
        ))
    if not dim0_rows:
        raise AssertionError("no served path launched the int8 dim-0 kernel")
    widest = max(dim0_rows, key=lambda r: r["bytes"])
    kernels.append(dict(
        name="dim0_int8", route="cuda", source="she_tpu_torch/csrc/dim0_int8.cu",
        replaces="she_tpu/pir/serving.py:222",
        launches=sum(p["launches"]["dim0_int8"] for p in paths.values()),
        max_abs_err=max(r["max_abs_err"] for r in dim0_rows + [w64_check]),
        ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"], bound_by=widest["bound_by"],
        library_ms=widest["library_ms"],
        library="torch.bmm, float32 digit operands, TF32 off: the digit products only",
        mac_ms=widest["mac_ms"], widest_path=widest["path"], widest_digits_shape=widest["digits_shape"],
        widest_query_shape=widest["query_shape"],
        launches_by_path={p: v["launches"]["dim0_int8"] for p, v in paths.items()},
        shapes=dim0_rows, w64_check=w64_check,
    ))
    for p in paths.values():
        p["launch_shapes"] = [dict(name=k[0], shape=list(k[1]), moduli=list(k[2]), launches=v)
                              for k, v in p["launch_shapes"].items()]
        p["dim0_shapes"] = [dict(digits_shape=list(k[0]), query_shape=list(k[1]), moduli=list(k[2]), launches=v)
                            for k, v in p["dim0_shapes"].items()]
    summary = dict(card=card, device=torch.cuda.get_device_name(0), kernel_build_s=built,
                   kernels=kernels, paths=paths)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    for path, p in paths.items():
        if path not in PATHS:
            continue
        log(f"{path} path ({p['params']}): database processing {p['process_s']:.3f} s, first batch "
            f"{p['first_batch_s']:.4f} s, then median {p['median_s_per_batch']:.4f} s/batch "
            f"(max {p['max_s_per_batch']:.4f} s over {p['steady_batches']} batches), "
            f"{p['queries_per_s']:.2f} queries/s, peak {p['peak_bytes']} bytes, smallest noise budget "
            f"{p['min_noise_budget']:.3f} bits, on {card}")
    k = paths["keyword"]
    log(f"{KEYWORD_CELL} ({k['params']}, {k['keywords']} keywords, dims {k['dimensions']}): cuckoo table "
        f"{k['cuckoo_s']:.3f} s, processing {k['process_s']:.3f} s in all; served median "
        f"{k['median_s_per_batch']:.4f} s/batch (max {k['max_s_per_batch']:.4f} s, first {k['first_batch_s']:.4f} s), "
        f"{k['queries_per_s']:.2f} keyword queries/s; wire (read queries + write answers) "
        f"{k['wire_s_per_batch']:.4f} s/batch; stream {k['stream_s']:.4f} s for {k['batches']} batches; "
        f"device ms by stage {k['stages_ms']}; peak {k['peak_bytes']} bytes; smallest noise budget "
        f"{k['min_noise_budget']:.3f} bits; on {card}")
    q = paths["keyword_large"]
    log(f"keyword_large: {q['keywords']} keywords x {q['value_size']} bytes, {q['chunks']} plaintexts a bucket, "
        f"{q['queries']} queries in {q['batch_s']:.4f} s, on {card}")
    v = paths["service"]
    log(f"service: {v['requests']} PIR requests over {KEYWORD_CELL}, median {v['median_request_s']:.4f} s a "
        f"request, on {card}")
    v = paths["spir"]
    log(f"spir: {v['keywords']} keywords sealed in {v['process_s']:.3f} s, {v['lookups']} lookups, on {card}")
    log(f"dim0_int8 at the widest served shape ({widest['path']}, digits {widest['digits_shape']}, query "
        f"{widest['query_shape']}): {widest['ms']:.4f} ms against a bound of {widest['bound_ms']:.4f} ms "
        f"({100 * widest['share_of_bound']:.1f}%), MAC {widest['mac_ms']:.4f} ms, digit bmm "
        f"{widest['library_ms']:.4f} ms; launches by path {kernels[-1]['launches_by_path']}, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=3, help="query batches to serve (>= 3)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the database, keys and indices")
    parser.add_argument("--json-out", default=None, help="also write the full results to this file")
    args = parser.parse_args()
    if args.batches < 3:
        parser.error("--batches must be at least 3")
    try:
        return run(args)
    except Exception as exc:  # any failed phase: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
