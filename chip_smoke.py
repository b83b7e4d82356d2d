#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and check every kernel.

Batched MulPIR serving (she_tpu_torch.pir.serving.BatchedMulPirServer)
against a 1,000,000-entry x 1-byte database with parameters
n_4096_logq_27_28_28_logt_5 at 32-bit scalars, 128 queries per batch:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from she_tpu_torch/csrc with nvcc;
3. hold each kernel bit-equal to its plain PyTorch version at the main
   path's shapes, and time both with CUDA events;
4. process the database, generate keys and queries with the port's client,
   serve the batches, check that every answer decrypts to its entry and
   that one batched response equals the per-query server's bit for bit,
   with the kernels' launch counts read around the serving run, then
   profile one more batch (device time by kernel, idle share);
5. print one JSON line with every kernel's numbers, and as the last line
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
PARAMS = "n_4096_logq_27_28_28_logt_5"
ENTRY_COUNT = 1_000_000
BATCH = 128


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


def kernel_phase(seed: int) -> dict:
    """Kernels against their plain versions at the main path's shapes."""
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.core import rns
    from she_tpu_torch.ops import ntt, ntt_cuda
    from she_tpu_torch.utils import refimpl

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

    # the 64-bit moduli at N=8192 (n_8192_logq_3x55_logt_24): round trip and
    # one row against the big-int reference
    w64 = paramsmod.from_predefined("n_8192_logq_3x55_logt_24").coefficient_moduli
    tables = ntt.build_ntt_tables(tuple(w64), 8192, torch.device("cuda"))
    x = random_rows(w64, (16,), 8192, seed + 20)
    fwd = ntt_cuda.forward(x, tables)
    if fwd[3, 1].tolist() != refimpl.forward_ntt(x[3, 1].tolist(), w64[1]):
        raise AssertionError("w64 kernel disagrees with the big-int reference")
    if not torch.equal(ntt_cuda.inverse(fwd, tables), x):
        raise AssertionError("w64 kernel round trip failed")
    log(f"kernel check 3x55-bit moduli at N=8192 {tuple(x.shape)}: round trip and big-int reference row agree")

    # timing at the widest main-path shape, the key-switching transform
    label, moduli, fshape, _ = cases[1]
    tables = ntt.build_ntt_tables(tuple(moduli), n, torch.device("cuda"))
    x = random_rows(moduli, fshape, n, seed + 30)
    rows = x.numel() // n
    table_bytes = 2 * len(moduli) * n * 8
    bound_ms = 1e3 * (2 * x.numel() * 8 + table_bytes) / HBM_BYTES_PER_S
    timing = {}
    for name, kern, plain in (
        ("ntt_forward", ntt_cuda.forward, ntt.forward_ntt_plain),
        ("ntt_inverse", ntt_cuda.inverse, ntt.inverse_ntt_plain),
    ):
        ms = cuda_ms(lambda: kern(x, tables), 20)
        plain_ms = cuda_ms(lambda: plain(x, tables), 3)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=max_err[name])
        log(f"{name}: shape {tuple(x.shape)} ({rows} rows of N={n}), grid {rows} CTAs x "
            f"{min(n // 2, 256)} threads, {n * 8} B dynamic shared memory; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, byte bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound)")
    del x
    torch.cuda.empty_cache()
    return timing


def profile_batch(server, queries, ek) -> dict:
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
    top =sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    log(f"profiled batch: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {launches} device kernels and copies")
    for name, us in top:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {name[:110]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us,
                device_launches=launches, top_ms={k: v / 1e3 for k, v in top})


def main_path(seed: int, batches: int) -> dict:
    """The port's batched MulPIR serving, as a user drives it."""
    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.ops import ntt, ntt_cuda
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    ctx = bfv.get_bfv_context(ep)  # the CUDA card
    config = ip.IndexPirConfig(
        entry_count=ENTRY_COUNT, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    parameter = ip.generate_parameter(config, ctx)
    log(f"PIR parameter: dims {parameter.dimensions}, {parameter.expanded_query_count} expanded "
        f"ciphertexts per query, Galois elements {parameter.evaluation_key_config.galois_elements}")
    rng = np.random.default_rng(seed)
    database = rng.integers(0, 256, size=(ENTRY_COUNT, 1), dtype=np.uint8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = ip.MulPirServer.process(database, ctx, parameter)
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    log(f"database processed in {process_s:.3f} s: {processed.count} plaintexts, "
        f"{int(processed.present.sum())} non-zero")

    t0 = time.perf_counter()
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = ip.MulPirClient(parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    torch.cuda.synchronize()
    log(f"keys and server ready in {time.perf_counter() - t0:.3f} s")

    all_indices, all_queries = [], []
    t0 = time.perf_counter()
    for _ in range(batches):
        indices = [int(i) for i in rng.integers(0, ENTRY_COUNT, size=BATCH)]
        all_indices.append(indices)
        all_queries.append([client.generate_query([i], sk) for i in indices])
    torch.cuda.synchronize()
    log(f"{batches} x {BATCH} queries generated in {time.perf_counter() - t0:.3f} s")

    # the main path, with the launch counts read around it
    ntt_cuda.reset_launches()
    for k in ntt.plain_calls_on_cuda:
        ntt.plain_calls_on_cuda[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s, all_responses = [], []
    for queries in all_queries:
        t0 = time.perf_counter()
        responses = server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        all_responses.append(responses)
    launches = dict(ntt_cuda.launches)
    plain_on_cuda = dict(ntt.plain_calls_on_cuda)
    peak = torch.cuda.max_memory_allocated()
    for i, s in enumerate(batch_s):
        log(f"batch {i}: {s:.4f} s, {BATCH / s:.2f} queries/s")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"the plain NTT ran on CUDA tensors: {plain_on_cuda}")
    log(f"NTT kernel launches over {batches} batches: {launches}; plain NTT on CUDA: {plain_on_cuda}")
    log(f"peak device memory during serving: {peak} bytes ({peak / 2**30:.3f} GiB)")

    t0 = time.perf_counter()
    for indices, responses in zip(all_indices, all_responses):
        for index, response in zip(indices, responses):
            got = client.decrypt(response, [index], sk)
            if got != [database[index].tobytes()]:
                raise AssertionError(f"query for entry {index} decrypted to {got}")
    log(f"all {batches * BATCH} answers decrypt to their entries ({time.perf_counter() - t0:.3f} s)")

    reference = ip.MulPirServer(parameter, ctx, [processed])
    want = reference.compute_response(all_queries[0][0], ek)
    got = all_responses[0][0]
    for wc, gc in zip(want.ciphertexts[0], got.ciphertexts[0]):
        for wp, gp in zip(wc.polys, gc.polys):
            if not torch.equal(wp.data, gp.data):
                raise AssertionError("batched response differs from the per-query server")
    log("batched response of query 0 is bit-identical to the per-query server's")

    steady = batch_s[1:] or batch_s
    profiled = profile_batch(server, all_queries[0], ek)
    # the profiler slows the host; against the unprofiled batch time the
    # same device work leaves this idle share
    profiled["idle_share_of_steady_batch"] = 1 - profiled["busy_ms"] / (1e3 * statistics.median(steady))
    log(f"device idle share of the median unprofiled batch: {profiled['idle_share_of_steady_batch']:.3f}")
    return dict(
        profile=profiled,
        process_s=process_s, batch_s=batch_s, first_batch_s=batch_s[0],
        median_s_per_batch=statistics.median(steady), max_s_per_batch=max(steady),
        steady_batches=len(steady), queries_per_s=BATCH / statistics.median(steady),
        peak_bytes=peak, launches=launches,
        launches_per_batch={k: v / batches for k, v in launches.items()},
    )


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")

    from she_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    built = kernel_build.build()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s: {built}")
    for name in built:  # registers, shared memory and spills per kernel (ptxas -v)
        build_log = kernel_build.log_path(name)
        lines = build_log.read_text(errors="replace").splitlines() if build_log.exists() else []
        for line in lines:
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    timing = kernel_phase(args.seed)
    path = main_path(args.seed, args.batches)

    kernels = []
    for name, line in (("ntt_forward", 217), ("ntt_inverse", 261)):
        kernels.append(dict(
            name=name, route="cuda", source="she_tpu_torch/csrc/ntt.cu",
            replaces=f"she_tpu/ops/ntt_pallas.py:{line}", launches=path["launches"][name],
            max_abs_err=timing[name]["max_abs_err"], ms=timing[name]["ms"],
            plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound_ms"],
            bound_by="bytes", library_ms=None,
        ))
    summary = dict(card=card, device=torch.cuda.get_device_name(0), kernel_build_s=built,
                   kernels=kernels, main_path=path)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"main path: database processing {path['process_s']:.3f} s, first batch "
        f"{path['first_batch_s']:.4f} s, then median {path['median_s_per_batch']:.4f} s/batch "
        f"(max {path['max_s_per_batch']:.4f} s over {path['steady_batches']} batches), "
        f"{path['queries_per_s']:.2f} queries/s, peak {path['peak_bytes']} bytes, on {card}")
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
