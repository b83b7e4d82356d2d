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
rotations (PNNS) and the mod switch (`mod_switch`). A CUDA-event span and
the host seconds of every part are kept beside it, and the profiled
batch's device ms of the NTT kernels by name (every launch, whichever part
made it) beside its busy ms. Launches are counted apart for the port's
hand-written kernels and for PyTorch's own (plain) ones.

The cell `service` puts the keyword cell's database behind PirService
(chip_smoke's service phase) and sends `--requests` PIR requests as
protobuf bytes (the last for an absent keyword), each timed up to a
synchronize and decrypted, then splits one more request by part: parse,
expansion, dim0_to_eval, dim0_mac, dim0_columns, fold, mod_switch,
serialize (instrument_service).

The key switch's parts: the Galois gather, the digits (each digit reduced
mod every key-switching modulus), the forward NTT, the MAC against the
key, the inverse NTT, the divide-and-round by q_ks, the add into c0 (and
c1) and the expansion's combine (c' + parent, (parent - c') x^-k into the
slot pool). Where a tree's key switch has two routes, each cell says which
its key switches took (`route`: the registry's key_switch.fused and
key_switch.split a batch): a fused key switch is two parts, `digits_ntt_mac`
(the digits, the forward NTT and the MAC) and `intt_finish` (the inverse
NTT, the divide-and-round and the add), whose insides no range can split;
a split one the parts above. The expansion's tail after its last level: in a tree whose
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
  python3 tools/key_switch_split.py [--root DIR] [--cells keyword,w64,service] [--batches 3] [--requests 8]
      [--json-out FILE]
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

CELLS = ("keyword", "w32", "w64", "pnns_w32", "pnns_w64", "service")


KERNEL_WRAPPERS = ("ntt_cuda", "dim0_cuda", "simple_pir_cuda", "ntt_mxu_cuda", "key_switch_cuda", "behz_cuda",
                   "dim0_mac_cuda")


def hand_launches() -> int:
    """The launches of the port's hand-written kernels so far, by the
    tracer's running total of its launch.* counts, or in a tree before the
    tracer by the wrappers' own counts (the profiler does not link a kernel
    that a library loaded with ctypes launched to the range it ran in)."""
    trace = sys.modules.get("she_tpu_torch.trace")
    if trace is not None:
        return trace.launch_total
    total = 0
    for name in KERNEL_WRAPPERS:
        module = sys.modules.get(f"she_tpu_torch.ops.{name}")
        if module is not None:
            total += sum(module.launches.values())
    return total


class Labels:
    """The current stage and part; CUDA-event spans of every part."""

    def __init__(self):
        self.stage = None
        self.part = None
        self.events = []  # (stage, part, start event, end event, host seconds, hand-written kernel launches)
        self.stage_runs = []  # (stage, host seconds, hand-written kernel launches)

    def stage_wrapper(self, name, fn):
        def wrapped(*args, **kwargs):
            from torch.profiler import record_function

            if self.stage is not None:
                return fn(*args, **kwargs)
            self.stage = name
            t0, k0 = time.perf_counter(), hand_launches()
            try:
                with record_function(f"stage|{name}"):
                    return fn(*args, **kwargs)
            finally:
                self.stage = None
                self.stage_runs.append((name, time.perf_counter() - t0, hand_launches() - k0))

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
            t0, k0 = time.perf_counter(), hand_launches()
            try:
                with record_function(f"part|{self.stage}|{part}"):
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
            finally:
                self.part = None
            self.events.append((self.stage, part, start, end, time.perf_counter() - t0, hand_launches() - k0))
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
    # where expand_stacked is defined (pir/expansion.py in a tree whose
    # per-query server expands by level) and where serving names it
    expansion = sys.modules[serving.expand_stacked.__module__]
    expansion.expand_stacked = serving.expand_stacked = labels.stage_wrapper("expansion", serving.expand_stacked)
    # a stage of its own in a batch, a part of a service request
    bfv.mod_switch_down_to_single = labels.part_wrapper(
        "mod_switch", labels.stage_wrapper("mod_switch", bfv.mod_switch_down_to_single), only_in="request")
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
                           ("expand_combine", "combine"), ("ks_digits_ntt_mac", "digits_ntt_mac"),
                           ("ks_intt_finish", "intt_finish")):
            if hasattr(ks, name):
                setattr(ks, name, labels.part_wrapper(part, getattr(ks, name)))
        return "kernels, two routes" if hasattr(ks, "fused_route") else "kernels"
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
    whose levels write their leaves (one with the tracer's registry, whose
    leaf_level counts them, or whose serving.levels_run has leaf_level),
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
    if not hasattr(serving, "levels_run") or "leaf_level" in serving.levels_run:
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


_KEYWORD_DATABASES: dict = {}


def keyword_database(cs, seed: int):
    """The keyword cell's context, processed database (one shard), rows,
    absent keywords, secret key, client and evaluation key; processed once
    a seed and shared by the keyword and service cells."""
    if seed in _KEYWORD_DATABASES:
        return _KEYWORD_DATABASES[seed]
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import keyword_pir as kp
    from she_tpu_torch.pir import process_database as pd
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
    processed = pd.process(rows, arguments, rng=random.Random(seed))
    shard = processed.shards["0"]
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    _KEYWORD_DATABASES[seed] = out = (ctx, processed, rows, absent, sk, client, ek)
    return out


def keyword_cell(cs, seed: int):
    import numpy as np

    from she_tpu_torch.pir import serving

    ctx, processed, rows, absent, sk, client, ek = keyword_database(cs, seed)
    server = serving.BatchedKeywordPirServer(ctx, processed.shards["0"])
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


def instrument_service(labels: Labels) -> None:
    """Wrap a service request's parts: PirService.handle_pir_request is
    stage `request`; its parts are the query's parse from the protobuf
    message (`parse`), the expansion (`expansion`: index_pir.expand), the
    expanded ciphertexts' forward NTT (`dim0_to_eval`: bfv.ct_to_eval), the
    ct x pt MAC a column (`dim0_mac`: bfv.inner_product_ct_pt), the
    columns' inverse NTT (`dim0_columns`: bfv.ct_to_coeff), the higher
    dimensions (`fold`: bfv.inner_product_ct_ct and bfv.relinearize), the
    mod switch (`mod_switch`, wrapped in instrument) and the answer's
    conversion to protobuf (`serialize`)."""
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.io import proto_conversion as pc
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import service as svc

    svc.PirService.handle_pir_request = labels.stage_wrapper("request", svc.PirService.handle_pir_request)
    for module, name, part in ((pc, "pir_query_from_proto", "parse"), (pc, "pir_response_to_proto", "serialize"),
                               (ip, "expand", "expansion"), (bfv, "ct_to_eval", "dim0_to_eval"),
                               (bfv, "inner_product_ct_pt", "dim0_mac"), (bfv, "ct_to_coeff", "dim0_columns"),
                               (bfv, "inner_product_ct_ct", "fold"), (bfv, "relinearize", "fold")):
        setattr(module, name, labels.part_wrapper(part, getattr(module, name), only_in="request"))


def service_cell(cs, seed: int, count: int):
    """The keyword cell's database behind PirService, its client's keys
    uploaded, and `count` PIR requests as protobuf messages (the last for
    an absent keyword) with the value each must decrypt to (None where
    absent)."""
    import numpy as np

    from she_tpu_torch.io import pb
    from she_tpu_torch.pir import service as svc

    ctx, processed, rows, absent, sk, client, ek = keyword_database(cs, seed)
    service = svc.PirService()
    service.add_keyword_pir_usecase(cs.KEYWORD_CELL, ctx, processed)
    config_id = bytes(service.handle_config_request(pb.api_pb2.ConfigRequest()).configs[cs.KEYWORD_CELL].config_id)
    cs._upload_keys(service, ctx, ek, b"split-client")
    present = list(rows)
    rng = np.random.default_rng(seed + 8)
    keywords = [present[int(i)] for i in rng.integers(0, len(present), size=count - 1)] + [absent[0]]
    requests = [(cs._pir_request(client.generate_query(kw, sk), config_id, "0", b"split-client"), kw, rows.get(kw))
                for kw in keywords]

    def check(answer: bytes, kw: bytes, want) -> None:
        got = client.decrypt(cs._read_response(ctx, answer), kw, sk)
        if got != want:
            raise AssertionError(f"[service] keyword {kw.hex()} came back as {got!r}, expected {want!r}")

    return service, requests, check


HAND_KERNELS = ("ntt_forward_kernel", "ntt_inverse_kernel", "ntt_mxu_kernel", "dim0_int8_kernel", "plane_products",
                "ks_digits_kernel", "ks_mac_kernel", "ks_finish_kernel", "expand_combine_kernel", "mod_switch_kernel",
                "ks_digits_ntt_mac_kernel", "ks_intt_finish_kernel",
                "behz_lift_kernel", "behz_tensor_mac_kernel", "behz_floor_kernel", "dim0_mac_kernel")


def profiled_parts(labels: Labels, run) -> dict:
    """Per (stage, part): the CUDA-event span, host seconds and launches of
    the port's hand-written kernels (`kernel_launches`, the wrappers'
    counts) of one run() (a batch or a request), then, of one more run()
    under torch.profiler, the device ms of the kernels linked to its ranges
    and their launches (`plain_launches`: PyTorch's own; the profiler links
    none of the hand-written kernels, which ctypes launched); per stage
    the same in all. The hand-written kernels' device ms are in the event
    spans and, by name, in the profiled run's busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels.events.clear()
    labels.stage_runs.clear()
    k0 = hand_launches()
    run()  # the CUDA-event spans, unprofiled
    torch.cuda.synchronize()
    run_kernels = hand_launches() - k0
    spans, stage_runs = list(labels.events), list(labels.stage_runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
            row = table.setdefault("|".join(key), dict(ms=0.0, plain_launches=0, calls=0))
            row["ms"] += sum(k.duration for k in ks) / 1e3
            row["plain_launches"] += len(ks)
            row["calls"] += 1
    for stage, part, start, end, host_s, kernels_run in spans:
        row = parts.setdefault(f"{stage}|{part}", dict(ms=0.0, plain_launches=0, calls=0))
        row["event_ms"] = row.get("event_ms", 0.0) + start.elapsed_time(end)
        row["host_s"] = row.get("host_s", 0.0) + host_s
        row["kernel_launches"] = row.get("kernel_launches", 0) + kernels_run
    for stage, host_s, kernels_run in stage_runs:
        row = stages.setdefault(stage, dict(ms=0.0, plain_launches=0, calls=0))
        row["host_s"] = row.get("host_s", 0.0) + host_s
        row["kernel_launches"] = row.get("kernel_launches", 0) + kernels_run
    for key, row in stages.items():
        inside = [r for k, r in parts.items() if k.split("|")[0] == key]
        parts[f"{key}|other"] = dict(ms=row["ms"] - sum(r["ms"] for r in inside),
                                     plain_launches=row["plain_launches"] - sum(r["plain_launches"] for r in inside),
                                     calls=row["calls"])
    ntt_ms = {name: 0.0 for name in ("ntt_forward", "ntt_inverse")}
    busy_us = hand_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        busy_us += us
        hand_us += us if any(h in evt.key for h in HAND_KERNELS) else 0.0
        for name in ntt_ms:
            if f"{name}_kernel" in evt.key:
                ntt_ms[name] += us / 1e3
    return dict(parts=parts, stages=stages, ntt_kernel_ms=ntt_ms, busy_ms=busy_us / 1e3, kernel_launches=run_kernels,
                hand_kernel_ms=hand_us / 1e3)


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
    counted = route_counts()
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
    route = {k: (v - counted[k]) / (batches + 1) for k, v in route_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    same = cs.assert_same_pnns_responses if cell.startswith("pnns") else cs.assert_same_responses
    stages = cs.stage_split(server, queries, ek, responses, stage_names, same)
    split = profiled_parts(labels, lambda: server.compute_response_batch(queries, ek))
    out = dict(cell=cell, setup_s=setup_s, batch_s=batch_s, median_s_per_batch=statistics.median(steady),
               cpu_s=cpu_s, median_cpu_s_per_batch=statistics.median(cpu_s[1:]),
               stages_ms=stages, peak_bytes=peak, digest=dig(responses), route=route, **split)
    print(f"[{cell}] median {out['median_s_per_batch']:.4f} s/batch over {len(steady)} batches "
          f"(first {batch_s[0]:.4f}), host CPU {out['median_cpu_s_per_batch']:.4f} s a batch, peak {peak} bytes "
          f"while serving; device ms by stage {({k: round(v, 3) for k, v in stages.items()})}; "
          f"responses digest {out['digest']}", flush=True)
    if route:
        print(f"[{cell}]   key switches a batch by route: {route}", flush=True)
    print(f"[{cell}]   NTT kernels of the profiled batch: forward {split['ntt_kernel_ms']['ntt_forward']:.3f} ms, "
          f"inverse {split['ntt_kernel_ms']['ntt_inverse']:.3f} ms, of {split['busy_ms']:.3f} busy ms", flush=True)
    print_parts(cell, split)
    return out


def route_counts() -> dict:
    """The registry's key switches by route (key_switch.fused,
    key_switch.split); empty in a tree whose key switch has one route."""
    try:
        from she_tpu_torch import trace
        from she_tpu_torch.ops import key_switch as ks
    except ImportError:
        return {}
    if not hasattr(ks, "fused_route"):
        return {}
    return {k: trace.counters[k] for k in ("key_switch.fused", "key_switch.split")}


def print_parts(cell: str, split: dict) -> None:
    print(f"[{cell}]   the run: {split['kernel_launches']} hand-written kernel launches, their device ms "
          f"{split['hand_kernel_ms']:.3f} of {split['busy_ms']:.3f} busy ms", flush=True)

    def launches(row) -> str:
        hand = row.get("kernel_launches")
        return f"{row['plain_launches']} plain launches" + ("" if hand is None else f", {hand} hand-written kernels")

    for key, row in sorted(split["stages"].items()):
        host = row.get("host_s")
        print(f"[{cell}]   stage {key}: kernels {row['ms']:.3f} ms, {launches(row)}, {row['calls']} calls"
              + ("" if host is None else f", host {host:.4f} s"), flush=True)
    for key, row in sorted(split["parts"].items()):
        ev, host = row.get("event_ms"), row.get("host_s")
        print(f"[{cell}]     {key}: kernels {row['ms']:.3f} ms, {launches(row)}, {row['calls']} calls"
              + ("" if ev is None else f", event span {ev:.3f} ms") + ("" if host is None else f", host {host:.4f} s"),
              flush=True)


def run_service(cs, labels: Labels, seed: int, count: int) -> dict:
    """`count` PIR requests through PirService (chip_smoke's service
    phase, as bytes), each timed on the host clock up to a synchronize
    and decrypted, after one warm-up request; then one more request split
    by part (profiled_parts)."""
    import torch

    t0 = time.perf_counter()
    service, requests, check = service_cell(cs, seed, count)
    setup_s = time.perf_counter() - t0
    cs._serve_request(service, cs.KEYWORD_CELL, requests[0][0])  # warm-up
    request_s, answers = [], []
    for request, kw, want in requests:
        answer, seconds = cs._serve_request(service, cs.KEYWORD_CELL, request)
        check(answer, kw, want)
        request_s.append(seconds)
        answers.append(answer)
    split = profiled_parts(labels, lambda: cs._serve_request(service, cs.KEYWORD_CELL, requests[0][0]))
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for answer in answers:
        h.update(answer)
    out = dict(cell="service", setup_s=setup_s, request_s=request_s, median_s_per_request=statistics.median(request_s),
               digest=h.hexdigest()[:16], **split)
    print(f"[service] {len(requests)} requests ({len(requests) - 1} present keywords gave their values, 1 absent "
          f"gave None): seconds a request {[round(x, 4) for x in request_s]}, median "
          f"{out['median_s_per_request']:.4f} s; answers digest {out['digest']}", flush=True)
    print_parts("service", split)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="the tree whose port and chip_smoke.py are measured")
    parser.add_argument("--cells", default="keyword,w64", help=f"comma-separated, of {', '.join(CELLS)}")
    parser.add_argument("--batches", type=int, default=3, help="steady batches timed after a warm-up batch")
    parser.add_argument("--requests", type=int, default=8, help="requests of the service cell, the last absent")
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
    instrument_service(labels)
    seed_urandom(args.seed)
    card = cs.card_line()
    print(f"key_switch_split: tree {root} ({kind} key switch, {behz_kind} BEHZ product, expansion leaves: "
          f"{tail_kind}), card {card}", flush=True)
    results = {cell: run_service(cs, labels, args.seed, args.requests) if cell == "service"
               else run_cell(cs, labels, cell, args.seed, args.batches) for cell in cells}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(root=str(root), kind=kind, behz_kind=behz_kind, tail_kind=tail_kind, card=card,
                           cells=results), f, indent=1)
    keys = ("digest", "median_s_per_batch", "median_s_per_request", "busy_ms", "median_cpu_s_per_batch",
            "peak_bytes")
    print(json.dumps({cell: {k: r[k] for k in keys if k in r} | dict(ntt_kernel_ms=sum(r["ntt_kernel_ms"].values()))
                      for cell, r in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
