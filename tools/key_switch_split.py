#!/usr/bin/env python3
"""Split the device time of the port's key switches, expansion, dim-0 and BEHZ products by part, on one NVIDIA card.

For each cell asked for (keyword, w32, w64, pnns_w32, pnns_w64: the cells
of chip_smoke.py, built the same way from the same seeds) it serves
`--batches` batches and reports the median seconds a batch (and the
host CPU seconds the process spent in it) and the peak device memory
while serving, the device ms
by stage of one batch (chip_smoke.stage_split, CUDA events), and one more
batch under torch.profiler with each part inside a record_function range:
its device ms (the kernels the profiler links to the range) and its kernel
launches, apart for the expansion, the dim-0 stage, the BEHZ stage (the
higher dimensions' ct x ct inner products and their relinearizations,
serving's fold_dimensions), PNNS's BSGS MAC and the other Galois
rotations (PNNS). A CUDA-event span of every part is kept beside it, and
the profiled batch's device ms of the NTT kernels by name (every launch,
whichever part made it) beside its busy ms.

The key switch's parts: the Galois gather, the digits (each digit reduced
mod every key-switching modulus), the forward NTT, the MAC against the
key, the inverse NTT, the divide-and-round by q_ks, the add into c0 (and
c1) and the expansion's combine (c' + parent, (parent - c') x^-k into the
slot pool). The expansion's tail after its last level: in a tree whose
levels write the leaves into the output (`leaves`: each level that writes
leaves, apart from the other levels' `combine`) there is none; in an
older tree it is the leaves' gather from the pool (`leaf_gather`), the
doubling's add (`leaf_add`) and the choice of the doubled leaves
(`leaf_where`). The dim-0 stage's parts: the query's forward NTT
(`dim0_query`), the MAC or the int8 form (`mac`) and the columns' inverse
NTT (`dim0_columns`); PNNS's BSGS MAC is stage `bsgs`. The BEHZ stage's
parts: the lift to [q, B_sk], the forward NTT, the tensor product, its sum
over the K pairs, the scale by t, the inverse NTT, the floor back to q and
the relinearization (one part, its key switch inside). `other` is the
rest of a stage (scatters, stacking copies, the root's copy into the
pool).

The port and chip_smoke.py are imported from `--root`, so the same script
measures a checkout of an older commit and this tree: where the tree has
ops/key_switch.py its four functions are the key switch's parts (the
gather and the digits are one kernel there, as are the divide-and-round
and the add), and where it has ops/behz.py its tensor MAC is one part
(product, sum and scale in one kernel); otherwise the plain passes are
labelled where they are called. Key and query randomness comes from a
generator seeded with --seed (os.urandom is replaced in the port's
modules), so two trees answer with the same bits: each cell prints a
digest of its responses.

Run from the repository root, on a machine with the card:
  python3 tools/key_switch_split.py [--root DIR] [--cells keyword,w64] [--batches 3] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import random
import statistics
import sys
import time
import types
from pathlib import Path

CELLS = ("keyword", "w32", "w64", "pnns_w32", "pnns_w64")


class Labels:
    """The current stage and part; CUDA-event spans of every part."""

    def __init__(self):
        self.stage = None
        self.part = None
        self.events = []  # (stage, part, start event, end event)

    def stage_wrapper(self, name, fn):
        def wrapped(*args, **kwargs):
            from torch.profiler import record_function

            if self.stage is not None:
                return fn(*args, **kwargs)
            self.stage = name
            try:
                with record_function(f"stage|{name}"):
                    return fn(*args, **kwargs)
            finally:
                self.stage = None

        wrapped.__wrapped__ = fn
        return wrapped

    def part_wrapper(self, part, fn, only_in=None):
        """fn labelled as `part` where it runs inside a stage (only inside
        stage `only_in`, where given) and outside another part."""

        def wrapped(*args, **kwargs):
            import torch
            from torch.profiler import record_function

            if self.stage is None or self.part is not None or only_in not in (None, self.stage):
                return fn(*args, **kwargs)
            self.part = part
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            try:
                with record_function(f"part|{self.stage}|{part}"):
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
            finally:
                self.part = None
            self.events.append((self.stage, part, start, end))
            return out

        wrapped.__wrapped__ = fn
        return wrapped


def proxy(module, **overrides):
    """A stand-in for a module reference: the overrides, and the module's
    own attributes for everything else."""
    ns = types.SimpleNamespace(**overrides)
    return types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module) if not k.startswith("__")}
                                 | vars(ns))


def instrument(labels: Labels) -> str:
    """Wrap the key switch's parts and stages of the imported tree; returns
    which kind of tree it is."""
    import torch

    from she_tpu_torch.bfv import bfv, keys
    from she_tpu_torch.core import poly
    from she_tpu_torch.pir import index_pir, keyword_pir, process_database  # noqa: F401  (seeded below)
    from she_tpu_torch.pnns import pnns  # noqa: F401
    from she_tpu_torch.ops import galois, modarith, ntt
    from she_tpu_torch.pir import serving

    bfv.apply_galois = labels.stage_wrapper("galois", bfv.apply_galois)
    # one part inside the BEHZ stage, a stage of its own elsewhere
    bfv.relinearize = labels.part_wrapper("relinearize", labels.stage_wrapper("relinearize", bfv.relinearize))
    serving.expand_stacked = labels.stage_wrapper("expansion", serving.expand_stacked)
    serving.BatchedMulPirServer.fold_dimensions = labels.stage_wrapper(
        "behz", serving.BatchedMulPirServer.fold_dimensions)
    ntt.forward_ntt = labels.part_wrapper("ntt_fwd", ntt.forward_ntt)
    ntt.inverse_ntt = labels.part_wrapper("ntt_inv", ntt.inverse_ntt)
    try:
        ks = importlib.import_module("she_tpu_torch.ops.key_switch")
    except ImportError:
        ks = None
    if ks is not None:
        for name, part in (("ks_digits", "digits"), ("ks_mac", "mac"), ("ks_finish", "finish"),
                           ("expand_combine", "combine")):
            setattr(ks, name, labels.part_wrapper(part, getattr(ks, name)))
        return "kernels"
    # a tree before the key-switch kernels: its plain passes where they are called
    galois.apply_galois_coeff = labels.part_wrapper("gather", galois.apply_galois_coeff)
    modarith.sum_products_mod = labels.part_wrapper("mac", modarith.sum_products_mod)
    poly.divide_and_round_q_last_data = labels.part_wrapper("divide_round", poly.divide_and_round_q_last_data)
    poly.add = labels.part_wrapper("c0_add", poly.add)
    keys.torch = proxy(torch, remainder=labels.part_wrapper("digits", torch.remainder))
    serving.bfv = proxy(bfv, ct_add=labels.part_wrapper("combine", bfv.ct_add),
                        ct_sub=labels.part_wrapper("combine", bfv.ct_sub),
                        multiply_power_of_x=labels.part_wrapper("combine", bfv.multiply_power_of_x))
    return "plain"


def instrument_dim0_and_leaves(labels: Labels) -> str:
    """Wrap the dim-0 stage's parts and the expansion's tail after its
    last level; returns which kind of tail the tree has.

    The dim-0 stage (serving's dim0_query and dim0, one range a call):
    `dim0_query` (the expanded ciphertexts' forward NTT and reshape),
    `mac` (dim0_partial: the MAC or the int8 form) and `dim0_columns`
    (the inverse NTT and the columns' transpose). PNNS's BSGS MAC is a
    stage of its own, `bsgs`, one part `mac`. The expansion: in a tree
    whose levels write their leaves (serving.levels_run has leaf_level),
    a level that writes leaves is part `leaves` and any other level's
    combine `combine`; in an older tree the tail after the last level is
    `leaf_gather` (the pool's index_select), `leaf_add` (the doubling's
    add_mod) and `leaf_where` (the choice of doubled leaves)."""
    import torch

    from she_tpu_torch.ops import modarith
    from she_tpu_torch.pir import serving
    from she_tpu_torch.pnns import serving as pnns_serving

    server = serving.BatchedMulPirServer
    server.dim0_query = labels.stage_wrapper("dim0", labels.part_wrapper("dim0_query", server.dim0_query))
    server.dim0 = labels.stage_wrapper("dim0", server.dim0)
    server.dim0_partial = labels.part_wrapper("mac", server.dim0_partial)
    server.dim0_columns = labels.part_wrapper("dim0_columns", server.dim0_columns)
    pnns_serving.bsgs_inner_products = labels.stage_wrapper(
        "bsgs", labels.part_wrapper("mac", pnns_serving.bsgs_inner_products))
    if "leaf_level" in serving.levels_run:
        ks = importlib.import_module("she_tpu_torch.ops.key_switch")
        combine = labels.part_wrapper("combine", ks.expand_combine)
        leaves = labels.part_wrapper("leaves", ks.expand_combine)
        ks.expand_combine = lambda *args, **kwargs: (leaves if kwargs.get("out") is not None else combine)(
            *args, **kwargs)
        return "leaves written by the levels"
    torch.Tensor.index_select = labels.part_wrapper("leaf_gather", torch.Tensor.index_select, only_in="expansion")
    serving.ma = proxy(modarith, add_mod=labels.part_wrapper("leaf_add", modarith.add_mod, only_in="expansion"))
    serving.torch = proxy(torch, where=labels.part_wrapper("leaf_where", torch.where, only_in="expansion"))
    return "a gather, add and where after the last level"


def instrument_behz(labels: Labels) -> str:
    """Wrap the BEHZ product's parts: the lift and the floor (RnsTool's
    methods in every tree), and where the tree has ops/behz.py its tensor
    MAC, else the plain product, sum over K and scale by t; returns which
    kind of tree it is."""
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.core import poly, rns
    from she_tpu_torch.ops import modarith

    rns.RnsTool.lift_q_to_qbsk = labels.part_wrapper("lift", rns.RnsTool.lift_q_to_qbsk)
    rns.RnsTool.floor_qbsk_to_q = labels.part_wrapper("floor", rns.RnsTool.floor_qbsk_to_q)
    try:
        behz = importlib.import_module("she_tpu_torch.ops.behz")
    except ImportError:
        behz = None
    if behz is not None:
        behz.behz_tensor_mac = labels.part_wrapper("tensor_mac", behz.behz_tensor_mac)
        return "kernels"
    poly.mul_eval = labels.part_wrapper("product", poly.mul_eval)
    poly.add = labels.part_wrapper("product", poly.add)
    poly.mul_scalar_rows = labels.part_wrapper("scale", poly.mul_scalar_rows)
    bfv.ma = proxy(modarith, sum_mod=labels.part_wrapper("sum", modarith.sum_mod))
    return "plain"


def seed_urandom(seed: int) -> None:
    """Key and query randomness from one seeded generator, in every module
    of the port that draws from os.urandom."""
    rng = random.Random(seed)
    fake = types.SimpleNamespace(**{k: getattr(os, k) for k in dir(os) if not k.startswith("__")})
    fake.urandom = lambda n: rng.randbytes(n)
    for name, mod in list(sys.modules.items()):
        if name.startswith("she_tpu_torch") and getattr(mod, "os", None) is os:
            mod.os = fake


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pir_digest(responses) -> str:
    return digest(ct.stacked() for r in responses for reply in r.ciphertexts for ct in reply)


def pnns_digest(responses) -> str:
    return digest(ct.stacked() for r in responses for m in r.ciphertext_matrices for ct in m.ciphertexts)


def keyword_cell(cs, seed: int):
    import numpy as np

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import process_database as pd
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    ep = paramsmod.from_predefined(cs.PARAMS, scalar_bits=32)
    ctx = bfv.get_bfv_context(ep)
    rows, absent = cs.keyword_rows(seed + 1, cs.KEYWORD_COUNT, 1, cs.BATCH // cs.ABSENT_EVERY)
    bucket_size = kp.default_max_serialized_bucket_size(1, ep.bytes_per_plaintext)
    config = kp.KeywordPirConfig(
        dimension_count=2, cuckoo_table_config=kp.CuckooTableConfig.default_keyword_pir(bucket_size),
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    arguments = pd.Arguments(pd.KeywordDatabaseConfig(kp.Sharding("shardCount", 1), config), ep)
    shard = pd.process(rows, arguments, rng=random.Random(seed)).shards["0"]
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    server = serving.BatchedKeywordPirServer(ctx, shard)
    kws = cs.keyword_batches(np.random.default_rng(seed + 2), list(rows), absent, 1, cs.BATCH)[0]
    queries = [client.generate_query(kw, sk) for kw in kws]
    return server, queries, ek, cs.PIR_STAGES, pir_digest


def mulpir_cell(cs, path: str, seed: int):
    setup = cs.serving_setup(path, seed, 1)
    return setup["server"], setup["all_queries"][0], setup["ek"], cs.PIR_STAGES, pir_digest


def pnns_cell(cs, label: str, seed: int):
    import numpy as np

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pnns import pnns
    from she_tpu_torch.pnns import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    params, scalar_bits = cs.PNNS_PATHS[label]
    rows, dim = cs.PNNS_DB
    ep = paramsmod.from_predefined(params, scalar_bits=scalar_bits)
    ctx = bfv.get_bfv_context(ep)
    sf = pnns.max_scaling_factor(dim, [ep.plaintext_modulus])
    ek_config = pnns.matmul_evaluation_key_config(ctx, pnns.MatrixDimensions(rows, dim), 1)
    client_config = pnns.ClientConfig.create(ep, sf, pnns.MatrixPacking.dense_row(), dim, ek_config)
    server_config = pnns.ServerConfig(client_config, pnns.MatrixPacking.diagonal(pnns.BabyStepGiantStep.create(dim)))
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((rows, dim)).astype(np.float32)
    processed = pnns.process_database(pnns.Database([pnns.DatabaseRow(i, b"", vectors[i]) for i in range(rows)]),
                                      server_config)
    client = pnns.Client(client_config)
    sk = client.generate_secret_key(nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"pnns-evaluation-key-err-seed-32b"))
    server = serving.BatchedPnnsServer(processed)
    query_vectors = rng.standard_normal((cs.PNNS_BATCH, 1, dim)).astype(np.float32)
    queries = [client.generate_query(v, sk, err_rng=nist_aes128_ctr(bytes([i]) * 32))
               for i, v in enumerate(query_vectors)]
    return server, queries, ek, cs.PNNS_STAGES, pnns_digest


def profiled_parts(labels: Labels, server, queries, ek) -> dict:
    """Per (stage, part): the CUDA-event span of one batch, then, of one
    more batch under torch.profiler, the device ms of the kernels linked to
    its ranges and their launches; per stage its kernels' ms and launches
    in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels.events.clear()
    server.compute_response_batch(queries, ek)  # the CUDA-event spans, unprofiled
    torch.cuda.synchronize()
    spans = list(labels.events)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()

    def kernels(evt):
        out = list(evt.kernels)
        for child in evt.cpu_children:
            out += kernels(child)
        return out

    parts, stages = {}, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU:  # a range's copy on the device timeline
            continue
        if evt.name.startswith("part|") or evt.name.startswith("stage|"):
            ks = kernels(evt)
            key = tuple(evt.name.split("|")[1:])
            table = parts if evt.name.startswith("part|") else stages
            row = table.setdefault("|".join(key), dict(ms=0.0, launches=0, calls=0))
            row["ms"] += sum(k.duration for k in ks) / 1e3
            row["launches"] += len(ks)
            row["calls"] += 1
    for stage, part, start, end in spans:
        row = parts.setdefault(f"{stage}|{part}", dict(ms=0.0, launches=0, calls=0))
        row["event_ms"] = row.get("event_ms", 0.0) + start.elapsed_time(end)
    for key, row in stages.items():
        inside = [r for k, r in parts.items() if k.split("|")[0] == key]
        parts[f"{key}|other"] = dict(ms=row["ms"] - sum(r["ms"] for r in inside),
                                     launches=row["launches"] - sum(r["launches"] for r in inside), calls=row["calls"])
    ntt_ms = {name: 0.0 for name in ("ntt_forward", "ntt_inverse")}
    busy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        busy_us += us
        for name in ntt_ms:
            if f"{name}_kernel" in evt.key:
                ntt_ms[name] += us / 1e3
    return dict(parts=parts, stages=stages, ntt_kernel_ms=ntt_ms, busy_ms=busy_us / 1e3)


def run_cell(cs, labels: Labels, cell: str, seed: int, batches: int) -> dict:
    import torch

    t0 = time.perf_counter()
    if cell == "keyword":
        server, queries, ek, stage_names, dig = keyword_cell(cs, seed)
    elif cell in ("w32", "w64"):
        server, queries, ek, stage_names, dig = mulpir_cell(cs, cell, seed)
    else:
        label = {"pnns_w32": "pnns_4096x128_w32_b16", "pnns_w64": "pnns_4096x128_w64_b16"}[cell]
        server, queries, ek, stage_names, dig = pnns_cell(cs, label, seed)
    setup_s = time.perf_counter() - t0
    batch_s, cpu_s, responses = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(batches + 1):  # the first batch warms up
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        responses = server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        cpu_s.append(time.process_time() - c0)
    steady = batch_s[1:]
    peak = torch.cuda.max_memory_allocated()
    same = cs.assert_same_pnns_responses if cell.startswith("pnns") else cs.assert_same_responses
    stages = cs.stage_split(server, queries, ek, responses, stage_names, same)
    split = profiled_parts(labels, server, queries, ek)
    out = dict(cell=cell, setup_s=setup_s, batch_s=batch_s, median_s_per_batch=statistics.median(steady),
               cpu_s=cpu_s, median_cpu_s_per_batch=statistics.median(cpu_s[1:]),
               stages_ms=stages, peak_bytes=peak, digest=dig(responses), **split)
    print(f"[{cell}] median {out['median_s_per_batch']:.4f} s/batch over {len(steady)} batches "
          f"(first {batch_s[0]:.4f}), host CPU {out['median_cpu_s_per_batch']:.4f} s a batch, peak {peak} bytes "
          f"while serving; device ms by stage {({k: round(v, 3) for k, v in stages.items()})}; "
          f"responses digest {out['digest']}", flush=True)
    print(f"[{cell}]   NTT kernels of the profiled batch: forward {split['ntt_kernel_ms']['ntt_forward']:.3f} ms, "
          f"inverse {split['ntt_kernel_ms']['ntt_inverse']:.3f} ms, of {split['busy_ms']:.3f} busy ms", flush=True)
    for key, row in sorted(split["stages"].items()):
        print(f"[{cell}]   stage {key}: kernels {row['ms']:.3f} ms, {row['launches']} launches, {row['calls']} calls",
              flush=True)
    for key, row in sorted(split["parts"].items()):
        ev = row.get("event_ms")
        print(f"[{cell}]     {key}: kernels {row['ms']:.3f} ms, {row['launches']} launches, {row['calls']} calls"
              + ("" if ev is None else f", event span {ev:.3f} ms"), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="the tree whose port and chip_smoke.py are measured")
    parser.add_argument("--cells", default="keyword,w64", help=f"comma-separated, of {', '.join(CELLS)}")
    parser.add_argument("--batches", type=int, default=3, help="steady batches timed after a warm-up batch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        parser.error(f"unknown cells {sorted(set(cells) - set(CELLS))}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("key_switch_split: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != root:
        raise AssertionError(f"chip_smoke imported from {cs.__file__}, not from {root}")
    from she_tpu_torch.ops import kernel_build

    kernel_build.build()
    labels = Labels()
    kind = instrument(labels)
    behz_kind = instrument_behz(labels)
    tail_kind = instrument_dim0_and_leaves(labels)
    seed_urandom(args.seed)
    card = cs.card_line()
    print(f"key_switch_split: tree {root} ({kind} key switch, {behz_kind} BEHZ product, expansion leaves: "
          f"{tail_kind}), card {card}", flush=True)
    results = {cell: run_cell(cs, labels, cell, args.seed, args.batches) for cell in cells}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(root=str(root), kind=kind, behz_kind=behz_kind, tail_kind=tail_kind, card=card,
                           cells=results), f, indent=1)
    print(json.dumps({cell: dict(digest=r["digest"], median_s_per_batch=r["median_s_per_batch"],
                                 ntt_kernel_ms=sum(r["ntt_kernel_ms"].values()), busy_ms=r["busy_ms"],
                                 median_cpu_s_per_batch=r["median_cpu_s_per_batch"], peak_bytes=r["peak_bytes"])
                      for cell, r in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
