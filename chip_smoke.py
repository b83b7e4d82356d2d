#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and check every kernel.

Batched MulPIR serving (she_tpu_torch.pir.serving.BatchedMulPirServer)
against a 1,000,000-entry x 1-byte database, 128 queries per batch, on two
paths: w32 (n_4096_logq_27_28_28_logt_5 at 32-bit scalars) and w64
(n_8192_logq_3x55_logt_24 at 64-bit scalars, exact wide arithmetic); then
keyword PIR (BatchedKeywordPirServer) over a 1,000,000-keyword cuckoo table
of 1-byte values, 128 keyword queries per batch, through the wire format;
then PNNS (BatchedPnnsServer), 16 cosine-similarity queries a batch over a
4,096 x 128 database at 32- and 64-bit scalars:

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
6. at every shape a serving run launched a kernel with: time the NTT
   kernels with CUDA events first, at every shape of every path, then
   hold each bit-equal to its plain version and time that; the
   int8 dim-0 kernel (served by default on the w32 index and keyword
   paths; the w64 path keeps the wide MAC, as she_tpu does) also against
   the int64 MAC and a torch.bmm yardstick of its digit products, and once
   at the w64 shape (8 digits);
7. the PIR service (service_phase): the keyword cell's 1M-keyword
   database behind PirService, a config request, an evaluation-key upload
   and 8 PIR requests (one for an absent keyword) as protobuf bytes, each
   expanded level by level on the key-switch kernels (the per-query
   server's expansion, pir/expansion.py), with the kernels' launches a
   request; then
   Symmetric PIR (spir_phase): 512 keywords sealed through
   process(..., symmetric_pir_config=...) and 16 lookups (2 absent)
   through OPRF and PIR requests, each value unsealed with the port's
   AES-GCM;
8. PNNS (pnns_path), cells pnns_4096x128_w32_b16 and _w64_b16
   (n_4096_logq_27_28_28_logt_17): process the database (diagonal BSGS
   packing, one NTT mod t and one to Eval for the 128 diagonals), make 16
   queries and the evaluation key with the port's client, serve a first
   batch and 3 more of the same queries; check every score of every query
   against the integer dot product of the rounded vectors, two responses
   against the per-query pnns.Server and the stream against the batch;
   split a batch's device time by stage and profile one more; the NTT is
   held to its plain version at the set-up's launch shapes too;
9. SimplePIR (simple_pir_path), cell simplepir_256k_x_4KiB_b32: a 1 GiB
   database of 262,144 entries x 4 KiB processed on the card (packing,
   then the hint through the NTT kernel), 32 queries made with the port's
   client, 3 batches of their 32 stacked request rows and one per-query
   call through the simple_pir_matmul kernel (u8 wgmma fed by a ring of
   bulk copies); every answer must decrypt to its entry; the kernel timed
   and held bit-equal to its plain version at both launched shapes, beside
   its bound and a float64 torch.matmul;
10. multi-device serving (mesh_phase, she_tpu_torch.parallel) with gloo
   ranks that all share this one card, a check of correctness, not of
   scaling: (a) batch-parallel MulPIR over the 1M x 1 B database, 128
   queries on 2 ranks; (b) the two-axis response over 2,097,152 x 1 B
   (dims 32 x 32), 128 queries on a (batch 2, db 2) mesh; (c)
   dim0_partial_psum on (b)'s chunk at S = 2 and 4 and at 64-bit scalars;
   (d) batch-parallel PNNS, 16 queries on 2 ranks; (e) the N-sharded NTT
   at S = 2 and 4, limb-parallel NTTs and the N-sharded ct x ct. Queries,
   keys and the single-process answers are made here first; every part
   must be bit-identical to them on every rank, and every answer of (a),
   (b) and (d) must decrypt; each rank reports its seconds a call, gloo's
   staged bytes and seconds, its peak memory and its kernel launches and
   shapes (the NTT's with per-rank block tables), held to the plain
   versions here after the ranks exit;
11. the matrix NTT (matrix_ntt_phase), she_tpu's opt-in
   SHE_TPU_NTT_MXU=1: the w32 cell served for --batches batches and one
   batch of the w64 cell (8 digits), each first on the butterfly route and
   then on the matrix route (the fused kernel of csrc/ntt_mxu.cu, one
   launch a direction, no butterfly launch, no plain NTT on CUDA tensors);
   every answer of the matrix route must equal the butterfly route's bit
   for bit and decrypt; then the fused kernel at every shape it launched
   with and at 60-bit moduli (n_8192_logq_28_60_60_logt_20, [2, 3, 8192], 9
   digits): timed first in turns with the butterfly kernel, beside its
   bytes and int8 bounds (and, as a diagnostic, the time the CUDA cores
   take to issue its build's integer instructions) and torch._int_mm's
   digit products, then held bit-equal to its plain version and to the butterfly
   kernel;
12. the command-line tools (cli_phase), in process on the card: generate,
   shard and process a keyword database, an mmap dictionary of it, a PNNS
   database generated and processed, 16,384 x 4 KiB entries processed for
   SimplePIR, and the warm tool for PIR and PNNS;
13. the key switch (ks_shape_timing): every path above switches keys
   (each Galois rotation, expansion level and relinearization) through
   csrc/key_switch.cu: where every key-switching modulus is below 2^30 and
   8 <= N <= 4096 (the w32 paths, keyword, both PNNS cells, the mesh's) through
   the fused pair, ks_digits_ntt_mac and ks_intt_finish, else (the w64
   path) through ks_digits, ks_mac and ks_finish around the NTT kernels;
   and expand_combine once an expansion level; every path fails unless
   each launched once a key switch of its route (or level) the port
   counted, every launch shape took its shape's route, and no plain
   key-switch pass ran on CUDA tensors; then each is timed at every shape a path launched it with,
   before any plain version, beside its byte bound (and
   torch.remainder where that one call computes ks_digits), then held
   bit-equal to its plain version; the mod switch too: every path that
   mod-switches its answers (w32, w64, keyword, keyword_large, both PNNS
   cells, the service, Symmetric PIR, mesh (a), (b) and (d)) drops its
   moduli with one launch of csrc/key_switch.cu's mod_switch a mod switch
   (every poly, every drop); a path fails unless mod_switch launched once a
   mod switch the port ran (the tracer's mod_switch count), and at least
   once, and the kernel is timed at every shape with the key switch's
   kernels;
14. the BEHZ product (behz_kernel_timing, behz_plain_checks): every path
   that multiplies ciphertexts (w32, w64, keyword, keyword_large, the
   service, mesh (a), (b) and (e)) lifts each side to [q, B_sk], sums the
   tensor product and scales it by t, and floors it back to q through the
   three kernels of csrc/behz.cu; every path fails unless behz_lift
   launched twice and behz_tensor_mac once a tensor product the port ran
   (the tracer's behz.tensor_product count), behz_floor once a floor, and
   no plain BEHZ pass ran on CUDA tensors; each kernel is timed at the widest shape of each path
   first, before any plain BEHZ version runs (and before the key switch's
   are timed), beside its byte bound; after the key switch's checks every
   launched shape is held bit-equal to its plain version;
15. the dim-0 MAC and the expansion's leaves (mac_kernel_timing,
   mac_plain_checks; ks_shape_timing for expand_leaves): every MAC a path
   serves (the w64 cell's dim-0, both PNNS cells' BSGS products, the
   per-query server's ct x pt products behind the service and Symmetric
   PIR, mesh (c) at 64 bits and (d), the CLI's warm pnns, the matrix NTT's
   w64 batch) goes through csrc/dim0_mac.cu, and every batched
   expansion writes its leaves from the level that makes them, through
   expand_combine's leaf instance (expand_leaves); a path fails if it
   serves a MAC and never launched dim0_mac, if a plain MAC ran on CUDA
   tensors, or if an expansion level that wrote leaves did not launch
   expand_leaves; dim0_mac is timed at the widest shape of each path
   first, before any plain MAC runs, beside its byte bound, then held
   bit-equal to its plain version at every launched shape; expand_leaves
   is timed with the key switch's kernels, beside torch.index_select of
   the same leaves;
16. print one JSON line with every kernel's numbers, and as the last line
   {"ok": true, "device": {...}}.

Any failure exits non-zero without the last line. Run from the repository
root:  python3 chip_smoke.py [--batches 3] [--seed 0] [--json-out FILE]

The default runs every phase. `--only dim0` builds the kernels and runs
only step 6's int8 dim-0 cases, at every shape of DIM0_SERVED_SHAPES and
the w64 check, then prints the kernels line and the last line.
`--only simple_pir` builds the kernels and runs step 9 alone (its NTT
shapes held and timed too), then prints the kernels line and the last
line. `--only mesh` does the same for step 10 and `--only ntt_mxu` for
step 11. `--only key_switch` serves the w32 and keyword cells and runs
step 13 on their shapes. `--only behz` serves the w32, w64 and keyword
cells and runs step 14 on their shapes. `--only dim0_mac` serves the w64,
w32, keyword and both PNNS cells and runs step 15 on their shapes.
`--only ntt` serves the w32 and w64 cells, times both NTT kernels at
every shape they launched (and at the keyword cell's widest) before any
plain version, then holds each bit-equal to the plain version.
`--only mod_switch` serves the w64, w32, keyword and both PNNS cells and
times mod_switch at every shape they launched it with, before any plain
version, then holds it bit-equal to the plain version at each.
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
# H100 SXM clocks of all SMs a second: 132 SMs at the 1,980 MHz boost
# clock (NVIDIA data sheet). The CUDA cores' 32-bit integer instructions go
# to two pipes, each 64 lanes an SM a clock (CUDA C++ Programming Guide,
# arithmetic throughput at compute capability 9.0): the multiplies to the
# FMA pipe, the rest to the ALU pipe; an SM's four schedulers issue one warp
# instruction a clock each, 128 lanes, to both pipes together.
SM_CLOCKS_PER_S = 132 * 1.98e9
INT_PIPE_LANES = 64
ISSUE_LANES = 128
FMA_INT_OPCODES = frozenset(("IMAD", "IMUL", "IMUL32I", "IDP"))
ALU_INT_OPCODES = frozenset(("IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR", "PRMT", "LEA",
                             "SEL", "ISETP", "ICMP", "IMNMX", "VIMNMX", "VIADD", "IABS", "POPC", "FLO", "BREV", "SGXT",
                             "BMSK", "ISCADD", "MOV", "P2R", "R2P", "PLOP3", "BFE", "BFI"))
_SASS: dict = {}
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
# every (C, d0, P, N) a serving run launches the int8 dim-0 kernel with, at
# the w32 ciphertext moduli (4 digits): the full run fails on one not here
DIM0_SERVED_SHAPES = {
    "keyword": (31, 97, 256, 4096),
    "w32": (9, 55, 256, 4096),
    "keyword_large": (21, 228, 64, 4096),
    # the mesh phase: (a) 64 queries a rank; (b) and (c) at S = 2, the d0
    # slice of 16 of 32 hyper-rows; (c) at S = 4, 8 of them
    "mesh_batch": (9, 55, 128, 4096),
    "mesh_two_axis": (32, 16, 128, 4096),
    "mesh_psum_S4": (32, 8, 128, 4096),
}
# the int8 form once at the w64 path's dim-0 shape (8 digits), which serves the MAC
DIM0_W64_CHECK = (4, 11, 2 * BATCH, 8192)
# PNNS (bench.py bench_pnns, bench_pnns_w64): name -> (parameters, scalar bits)
PNNS_PATHS = {
    "pnns_4096x128_w32_b16": ("n_4096_logq_27_28_28_logt_17", 32),
    "pnns_4096x128_w64_b16": ("n_4096_logq_27_28_28_logt_17", 64),
}
PNNS_DB = (4096, 128)  # database rows x vector dimension
PNNS_BATCH = 16
# SimplePIR (Henzinger et al., USENIX Security 2023, evaluate a 1 GB
# database): 262,144 entries x 4 KiB from default_rng(seed); p = 9 as
# she_tpu's tool defaults (cli/simple_pir_process_database.py:27); b = 32
# and n = 2048 in place of its b = 21, n = 1024, at which no answer
# decrypts (q' - 2^21 = 4097 > Delta / 2 = 2048); b = 32 is within the
# 128-bit table at n = 2048 (41 bits)
SIMPLE_PIR_CELL = "simplepir_256k_x_4KiB_b32"
SIMPLE_PIR_DB = (262_144, 4096)  # entries x bytes
SIMPLE_PIR_PARAMS = (9, 32, 2048)  # plaintext bits p, ciphertext bits b, lattice dimension n
SIMPLE_PIR_BATCH = 32
# the CLI phase: keyword rows (1 B values, 2 shards), the warm tool's PIR
# entries and batch, SimplePIR entries x bytes at the tool's defaults
CLI_KEYWORD_ROWS = 10_000
CLI_WARM_PIR = (100_000, 16)
CLI_SIMPLE_PIR_DB = (16_384, 4096)
CLI_SIMPLE_PIR_ROWS = 3641  # ceil(8 * 4096 / 9): the hint's rows
CLI_SIMPLE_PIR_DEGREE = 1024  # the tool's default lattice dimension

# multi-device serving (mesh_phase): gloo ranks sharing the one card
MESH_BATCH = 128  # queries of (a) and (b): 64 a rank
MESH_TWO_AXIS_ENTRIES = 2_097_152  # (b): 1-byte entries whose dims split over a db axis of 2
MESH_TWO_AXIS_DIMS = (32, 32)
MESH_PSUM_W64 = (4, 32, 16, 8192)  # (c) at 64-bit scalars, random residues: C, d0, P, N
MESH_LIMB_MODULI = 4  # (e): limb-parallel NTTs of 4 moduli, which 2 and 4 ranks divide
MESH_REPS = 3  # calls of each part on each rank, the first a warm-up
NTT_KERNELS = ("ntt_forward", "ntt_inverse")
NTT_AND_DIM0 = NTT_KERNELS + ("dim0_int8",)
# the key switch's kernels (csrc/key_switch.cu): a key switch on the split
# route launches KS_SPLIT once each (and each NTT kernel once), one on the
# fused route (every key-switching modulus below 2^30, N <= 4096: the w32
# paths) KS_FUSED once each; an expansion level expand_combine once, or its
# leaf instance (expand_leaves) where the level writes leaves into the
# output; a mod switch (every drop of every poly of a ciphertext batch)
# mod_switch once
KS_SPLIT = ("ks_digits", "ks_mac", "ks_finish")
KS_FUSED = ("ks_digits_ntt_mac", "ks_intt_finish")
KS_KERNELS = KS_SPLIT + ("expand_combine", "expand_leaves", "mod_switch") + KS_FUSED
KS_W32 = KS_FUSED + ("expand_combine", "expand_leaves", "mod_switch")  # what a w32 path's key switches launch
# kernels shorter than their wrapper's host work a call: their ms is
# replayed from a CUDA graph (graph_ms), beside the time through the wrapper
GRAPH_TIMED = ("mod_switch",)
# the she_tpu functions each replaces (none is a Pallas kernel: XLA fuses them)
KS_REPLACES = {"ks_digits": "she_tpu/ops/galois.py:61", "ks_mac": "she_tpu/bfv/keys.py:319",
               "ks_finish": "she_tpu/core/poly.py:207", "expand_combine": "she_tpu/pir/serving.py:160",
               "expand_leaves": "she_tpu/pir/serving.py:168", "mod_switch": "she_tpu/core/poly.py:207",
               "ks_digits_ntt_mac": "she_tpu/bfv/keys.py:228-255, she_tpu/ops/galois.py:61",
               "ks_intt_finish": "she_tpu/core/poly.py:207"}
# the BEHZ product's kernels (csrc/behz.cu): a tensor product launches
# behz_lift twice (a side) and behz_tensor_mac once, a floor behz_floor once
BEHZ_KERNELS = ("behz_lift", "behz_tensor_mac", "behz_floor")
# every hand-written kernel, as the tracer's registry counts them (launch.<kernel>)
ALL_KERNELS = NTT_KERNELS + ("dim0_int8", "simple_pir_matmul", "ntt_mxu") + KS_KERNELS + BEHZ_KERNELS + ("dim0_mac",)
PLAIN_NTTS = ("ntt_forward", "ntt_inverse", "ntt_mxu_forward", "ntt_mxu_inverse")
BEHZ_REPLACES = {"behz_lift": "she_tpu/core/rns.py:376", "behz_tensor_mac": "she_tpu/bfv/bfv.py:734",
                 "behz_floor": "she_tpu/core/rns.py:458"}
BEHZ_LIBRARY = ("none: no PyTorch call computes a base conversion between moduli sets or a modular sum of 128-bit "
                "products")
# the dim-0 MAC (csrc/dim0_mac.cu): every dim-0 MAC form, PNNS BSGS product and
# ct x pt inner product; the function of she_tpu that the w64 cell serves
MAC_REPLACES = "she_tpu/pir/serving.py:344"
MAC_LIBRARY = "none: no PyTorch call computes a modular sum of 128-bit products"

# the matrix NTT (ntt_mxu): she_tpu's opt-in SHE_TPU_NTT_MXU=1 on the
# MulPIR cells, label -> (path of PATHS, batches: None for --batches)
NTT_MXU_PATHS = {"ntt_mxu_w32": ("w32", None), "ntt_mxu_w64": ("w64", 1)}
# the 60-bit check: 9 digits, batch shape and degree
NTT_MXU_D9 = ("n_8192_logq_28_60_60_logt_20", (2,), 8192)
# every kernel of the kernels line, by name: its source in the repository
KERNEL_SOURCES = {
    "ntt_forward": "she_tpu_torch/csrc/ntt.cu",
    "ntt_inverse": "she_tpu_torch/csrc/ntt.cu",
    "dim0_int8": "she_tpu_torch/csrc/dim0_int8.cu",
    "simple_pir_matmul": "she_tpu_torch/csrc/simple_pir_matmul.cu",
    "ntt_mxu": "she_tpu_torch/csrc/ntt_mxu.cu",
    "ks_digits": "she_tpu_torch/csrc/key_switch.cu",
    "ks_mac": "she_tpu_torch/csrc/key_switch.cu",
    "ks_finish": "she_tpu_torch/csrc/key_switch.cu",
    "expand_combine": "she_tpu_torch/csrc/key_switch.cu",
    "behz_lift": "she_tpu_torch/csrc/behz.cu",
    "behz_tensor_mac": "she_tpu_torch/csrc/behz.cu",
    "behz_floor": "she_tpu_torch/csrc/behz.cu",
    "expand_leaves": "she_tpu_torch/csrc/key_switch.cu",
    "dim0_mac": "she_tpu_torch/csrc/dim0_mac.cu",
    "mod_switch": "she_tpu_torch/csrc/key_switch.cu",
    "ks_digits_ntt_mac": "she_tpu_torch/csrc/key_switch.cu",
    "ks_intt_finish": "she_tpu_torch/csrc/key_switch.cu",
}
# ptxas_lines' labels of each kernel's instances
PTXAS_LABELS = {"ks_digits": "ks_digits_kernel", "ks_mac": "ks_mac_kernel", "ks_finish": "ks_finish_kernel",
                "expand_combine": "expand_combine_kernel", "expand_leaves": "expand_leaves", "dim0_mac": "dim0_mac_kernel",
                "mod_switch": "mod_switch_kernel", "ks_digits_ntt_mac": "ks_digits_ntt_mac_kernel",
                "ks_intt_finish": "ks_intt_finish_kernel"}
# profiler names of the kernels where f"{name}_kernel" does not single them out
PROFILE_NAMES = {"expand_combine": "expand_combine_kernel<false", "expand_leaves": "expand_combine_kernel<true"}
MESH_PATHS = ("mesh_batch_w32", "mesh_two_axis_w32", "mesh_pnns_w32", "mesh_dim0_psum", "mesh_sharded")


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


def graph_ms(fn, iters: int = 20) -> float:
    """Milliseconds of fn() replayed from a CUDA graph of `iters` calls (the
    mean of 3 replays after a warm-up): the kernel's time without the
    host's cost of a call, which a short launch does not hide."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def random_rows(moduli, shape, degree, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = np.zeros(tuple(shape) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        rows[..., i, :] = rng.integers(0, q, size=tuple(shape) + (degree,))
    return torch.from_numpy(rows).cuda()


def ptxas_lines(name: str) -> list[str]:
    """ptxas -v's registers, spills and shared memory of the N=4096 and
    N=8192 instantiations of the NTT kernels on both routes, of the dim-0
    kernel's instances at 4 and 8 digits (the served and checked ones),
    and of the SimplePIR kernel's instances that serve the cell (two D
    planes against four query planes, 32 and 8 request rows), with the
    dynamic shared memory and stages of their rings; and of the matrix
    NTT's fused kernel at 4, 8 and 9 digits, both directions; of every
    key-switch kernel instance (each one is served, expand_combine's leaf
    instances as expand_leaves, the mod switch's at every L); of the BEHZ kernels (the lift at every L,
    the floor at every L in both words); and of every instance of the
    dim-0 MAC (word, accumulators, depth of its ring of B)."""
    import re

    from she_tpu_torch.ops import kernel_build

    path = kernel_build.log_path(name)
    lines = path.read_text(errors="replace").splitlines() if path.exists() else []
    out, label = [], None
    for line in lines:
        m = re.search(r"(ntt_(?:forward|inverse)_kernel)I([jy])Li(\d+)E(Lb1E)?", line)
        if m:
            word = "u32" if m.group(2) == "j" else "u64"
            label = (f"{m.group(1)}<{word}, log2n={m.group(3)}{', lazy' if m.group(4) else ''}>"
                     if m.group(3) in ("12", "13") else None)
        elif "Compiling entry function" in line and "dim0_int8_kernel" in line:
            m = re.search(r"dim0_int8_kernelILi(\d)ELi(\d)E", line)
            label = f"dim0_int8_kernel<D={m.group(1)}, MT={m.group(2)}>" if m and m.group(1) in "48" else None
        elif "Compiling entry function" in line and "plane_products" in line:
            m = re.search(r"plane_productsILi(\d)ELi(\d)ELi(\d+)E", line)
            label = None
            if m and (m.group(1), m.group(2)) == ("4", "2") and m.group(3) in ("8", "32"):
                from she_tpu_torch.ops import simple_pir_cuda

                stages, shared = simple_pir_cuda.ring(4, 2, int(m.group(3)))
                label = (f"plane_products<JA=4, NI=2, KQT={m.group(3)}> ({stages} stages, {shared} bytes of "
                         f"dynamic shared memory)")
        elif "Compiling entry function" in line and "ntt_mxu_kernel" in line:
            m = re.search(r"ntt_mxu_kernelILi(\d)ELb([01])E", line)
            label = (f"ntt_mxu_kernel<D={m.group(1)}, {'forward' if m.group(2) == '1' else 'inverse'}>"
                     if m and m.group(1) in "489" else None)
        elif "Compiling entry function" in line and "expand_combine_kernel" in line:
            m = re.search(r"expand_combine_kernelILb([01])ELb([01])E", line)
            label = ("expand_combine_kernel" if m is None else
                     {"00": "expand_combine_kernel", "10": "expand_leaves (expand_combine_kernel<leaves>)",
                      "11": "expand_leaves (expand_combine_kernel<leaves, doubled>)"}.get(m.group(1) + m.group(2)))
        elif "Compiling entry function" in line and re.search(r"ks_(?:digits_ntt_mac|intt_finish)_kernel", line):
            m = re.search(r"(ks_(?:digits_ntt_mac|intt_finish)_kernel)ILi(\d+)E", line)
            label = f"{m.group(1)}<log2n=12>" if m and m.group(2) == "12" else None
        elif "Compiling entry function" in line and re.search(r"ks_\w+_kernel", line):
            m = re.search(r"(ks_\w+?_kernel)(?:ILNS_\d+FinishE(\d)E|ILb([01])E)?", line)
            variant = (("update", "galois", "relinearize")[int(m.group(2))] if m.group(2)
                       else {"0": "no gather", "1": "gather"}.get(m.group(3)))
            label = m.group(1) + (f"<{variant}>" if variant else "")
        elif "Compiling entry function" in line and "mod_switch_kernel" in line:
            m = re.search(r"mod_switch_kernelILi(\d)E", line)
            label = f"mod_switch_kernel<L={m.group(1)}>" if m else None
        elif "Compiling entry function" in line and "dim0_mac_kernel" in line:
            m = re.search(r"dim0_mac_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            label = f"dim0_mac_kernel<W={m.group(1)}, MG={m.group(2)}, D={m.group(3)}>" if m else None
        elif "Compiling entry function" in line and "behz_" in line:
            m = re.search(r"(behz_(?:lift|floor|tensor_mac)_kernel)(?:I([jy])?Li(\d)E)?", line)
            word = {"j": "u32, ", "y": "u64, "}.get(m.group(2) or "", "")
            label = m.group(1) + (f"<{word}L={m.group(3)}>" if m.group(3) else "")
        elif label and ("Used" in line or "spill" in line):
            out.append(f"{label}: {line.strip()}")
    return out


def prod(shape) -> int:
    p = 1
    for d in shape:
        p *= d
    return p


def reset_counts() -> None:
    """The tracer's registry cleared (every kernel's launches and launch
    shapes, the plain passes' counts on CUDA tensors, the port's count of
    key switches, expansion levels and of them those that write leaves,
    tensor products, floors and mod switches) and its spans dropped, with
    tracing on, so that launches are counted by shape: just before a path
    is driven."""
    from she_tpu_torch import trace

    trace.reset()
    trace.drain()
    if not trace.tracing():
        trace.enable()


def kernel_launches() -> dict:
    """Each hand-written kernel's launches since reset_counts."""
    from she_tpu_torch import trace

    return {k: trace.counters["launch." + k] for k in ALL_KERNELS}


def plain_on_cuda(ops) -> dict:
    """The plain passes of `ops` run on CUDA tensors since reset_counts."""
    from she_tpu_torch import trace

    return {k: trace.counters["plain_on_cuda." + k] for k in ops}


def launch_shapes_of(kernels) -> dict:
    """The launches of `kernels` by their wrappers' launch keys since
    reset_counts."""
    from she_tpu_torch import trace

    return {key: n for (kernel, key), n in trace.launch_shapes.items() if kernel in kernels}


def key_switch_counts(label: str, launches: dict, switches: bool, expands: bool) -> None:
    """Fails unless each of ks_digits_ntt_mac and ks_intt_finish launched
    once a key switch the port ran on the fused route (the registry's
    key_switch.fused) and each of ks_digits, ks_mac and ks_finish once one
    on the split route (key_switch.split), the two routes adding up to
    key_switch; unless every launch shape of those kernels took the route
    that ops/key_switch.fused_route gives its moduli and degree (the w32
    paths the fused pair, the w64 paths the split chain); unless
    expand_leaves launched once an expansion level that wrote leaves and
    expand_combine once any other level (expansion_level, leaf_level); if
    a path that switches keys (`switches`) ran no key switch, or one that
    expands queries in batches (`expands`) no level or no level that wrote
    its leaves; or if a plain key-switch pass (the leaves' too) ran on CUDA
    tensors."""
    import torch

    from she_tpu_torch import trace
    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import key_switch as ks

    ran = {k: trace.counters[k] for k in ("key_switch", "key_switch.fused", "key_switch.split", "expansion_level",
                                          "leaf_level")}
    if (ran["key_switch.fused"] + ran["key_switch.split"] != ran["key_switch"]
            or any(launches[k] != ran["key_switch.split"] for k in KS_SPLIT)
            or any(launches[k] != ran["key_switch.fused"] for k in KS_FUSED)
            or launches["expand_leaves"] != ran["leaf_level"]
            or launches["expand_combine"] != ran["expansion_level"] - ran["leaf_level"]):
        raise AssertionError(f"[{label}] key-switch launches {dict((k, launches[k]) for k in KS_KERNELS)} against "
                             f"{ran['key_switch']} key switches ({ran['key_switch.fused']} fused, "
                             f"{ran['key_switch.split']} split) and {ran['expansion_level']} expansion levels, "
                             f"{ran['leaf_level']} of them writing leaves")
    for key in launch_shapes_of(KS_SPLIT + KS_FUSED):
        fused = ks.fused_route(get_poly_context(key.shape[-1], key.moduli, 64, torch.device("cuda")))
        if fused != (key.name in KS_FUSED):
            raise AssertionError(f"[{label}] {key.name} launched at {key.shape}, moduli {key.moduli}: the shape's "
                                 f"route is the {'fused' if fused else 'split'} one")
    if (switches and not ran["key_switch"]) or (expands and not (ran["expansion_level"] and ran["leaf_level"])):
        raise AssertionError(f"[{label}] the path ran {ran} key switches and expansion levels")
    plain = plain_on_cuda(KS_KERNELS)
    if any(plain.values()):
        raise AssertionError(f"[{label}] a plain key-switch pass ran on CUDA tensors: {plain}")


def mod_switch_counts(label: str, launches: dict, mod_switches: bool) -> None:
    """Fails unless mod_switch launched once a mod switch the port ran (the
    registry's mod_switch), or if a path that mod-switches
    (`mod_switches`) ran none. A plain mod switch on CUDA tensors fails
    key_switch_counts."""
    from she_tpu_torch import trace

    ran = trace.counters["mod_switch"]
    if launches["mod_switch"] != ran:
        raise AssertionError(f"[{label}] {launches['mod_switch']} mod_switch launches against {ran} mod switches")
    if mod_switches and not ran:
        raise AssertionError(f"[{label}] the path mod-switches and ran no mod switch")


def behz_counts(label: str, launches: dict, multiplies: bool) -> None:
    """Fails unless behz_lift launched twice and behz_tensor_mac once a
    tensor product the port ran (the registry's behz.tensor_product) and
    behz_floor once a floor (behz.floor); if a path that multiplies
    ciphertexts (`multiplies`) ran no product or no floor; or if a plain
    BEHZ pass ran on CUDA tensors."""
    from she_tpu_torch import trace

    ran = {"tensor_product": trace.counters["behz.tensor_product"], "floor": trace.counters["behz.floor"]}
    if (launches["behz_lift"] != 2 * ran["tensor_product"] or launches["behz_tensor_mac"] != ran["tensor_product"]
            or launches["behz_floor"] != ran["floor"]):
        raise AssertionError(f"[{label}] BEHZ launches {[launches[k] for k in BEHZ_KERNELS]} against "
                             f"{ran['tensor_product']} tensor products and {ran['floor']} floors")
    if multiplies and not (ran["tensor_product"] and ran["floor"]):
        raise AssertionError(f"[{label}] the path ran {ran} tensor products and floors")
    plain = plain_on_cuda(BEHZ_KERNELS)
    if any(plain.values()):
        raise AssertionError(f"[{label}] a plain BEHZ pass ran on CUDA tensors: {plain}")


def mac_counts(label: str, launches: dict, mac: bool) -> None:
    """Fails if a path that serves a MAC (`mac`: the w64 dim-0, PNNS's BSGS
    product, the per-query server's ct x pt products) never launched
    dim0_mac, or if a plain dim-0, BSGS or ct x pt MAC ran on CUDA
    tensors."""
    if mac and not launches["dim0_mac"]:
        raise AssertionError(f"[{label}] the path serves a MAC and never launched dim0_mac: {launches}")
    plain = plain_on_cuda(("dim0_mac",))
    if any(plain.values()):
        raise AssertionError(f"[{label}] a plain dim-0 MAC ran on CUDA tensors: {plain}")


def read_counts(label: str, use_dim0_int8: bool, simple_pir: bool = False, mxu: bool = False,
                switches: bool = True, expands: bool = True, multiplies: bool = True, mac: bool = False,
                mod_switches: bool = True) -> dict:
    """The counts of the path just driven. Fails if a kernel of the path
    never launched, if the int8 dim-0 kernel launched on a path that serves
    the MAC form, if the SimplePIR kernel launched on another protocol's
    path, if the NTT took the other route than the path's (`mxu`: the
    matrix NTT's fused kernel, else the butterfly kernels), if a plain
    NTT ran on CUDA tensors, or as key_switch_counts says (`switches`,
    `expands`: the path switches keys, and expands queries level by level)
    and behz_counts (`multiplies`: the path multiplies ciphertexts) and
    mac_counts (`mac`: the path serves a MAC) and mod_switch_counts
    (`mod_switches`: the path mod-switches its answers)."""
    launches = kernel_launches()
    plain_ntts = plain_on_cuda(PLAIN_NTTS)
    ntt_kernels, other_route = (["ntt_mxu"], NTT_KERNELS) if mxu else (list(NTT_KERNELS), ("ntt_mxu",))
    path_kernels = (ntt_kernels + (["dim0_int8"] if use_dim0_int8 else [])
                    + (["simple_pir_matmul"] if simple_pir else []))
    if any(launches[k] == 0 for k in path_kernels):
        raise AssertionError(f"[{label}] a kernel of the path never launched: {launches}")
    if any(launches[k] for k in other_route):
        raise AssertionError(f"[{label}] the NTT took the other route: {launches}")
    if not use_dim0_int8 and launches["dim0_int8"]:
        raise AssertionError(f"[{label}] the int8 dim-0 kernel ran on a MAC path: {launches}")
    if not simple_pir and launches["simple_pir_matmul"]:
        raise AssertionError(f"[{label}] the SimplePIR kernel ran on another path: {launches}")
    if any(plain_ntts.values()):
        raise AssertionError(f"[{label}] a plain NTT ran on CUDA tensors: {plain_ntts}")
    key_switch_counts(label, launches, switches, expands)
    behz_counts(label, launches, multiplies)
    mac_counts(label, launches, mac)
    mod_switch_counts(label, launches, mod_switches)
    return dict(launches=launches, launch_shapes=launch_shapes_of(NTT_KERNELS),
                dim0_shapes=launch_shapes_of(("dim0_int8",)),
                simple_pir_shapes=launch_shapes_of(("simple_pir_matmul",)),
                mxu_shapes=launch_shapes_of(("ntt_mxu",)), ks_shapes=launch_shapes_of(KS_KERNELS),
                behz_shapes=launch_shapes_of(BEHZ_KERNELS), mac_shapes=launch_shapes_of(("dim0_mac",)))


def kernel_bound_ms(shape, moduli, degree) -> float:
    """Bytes over the memory rate: every int64 row read and written once,
    plus the int64 root and Shoup tables of its moduli (counted as in PR 1)."""
    return 1e3 * (2 * prod(shape) * 8 + 2 * len(moduli) * degree * 8) / HBM_BYTES_PER_S


def ntt_coefficients_per_thread(word_bits: int, log2n: int) -> int:
    """Coefficients one thread of the built NTT kernel holds at
    (word_bits, log2n), as the library reports it
    (she_ntt_coefficients_per_thread); a build of csrc/ntt.cu without that
    query holds 16 at every N >= 16, so that older trees measure too."""
    from she_tpu_torch.ops import kernel_build

    query = getattr(kernel_build.load("ntt"), "she_ntt_coefficients_per_thread", None)
    return query(word_bits, log2n) if query is not None else min(16, 1 << log2n)


def ntt_instance(word_bits: int, log2n: int, modulus_bits: int) -> str:
    """The mangled-name pattern of the NTT kernel instance a launch takes:
    a build whose kernels carry the lazy flag (she_ntt_lazy) has two
    instances at the 64-bit route's N = 8192; older builds one."""
    from she_tpu_torch.ops import kernel_build

    w = "j" if word_bits == 32 else "y"
    query = getattr(kernel_build.load("ntt"), "she_ntt_lazy", None)
    if query is None:
        return rf"I{w}Li{log2n}EE"
    return rf"I{w}Li{log2n}ELb{int(query(word_bits, log2n, modulus_bits))}E"


def ntt_sass(name: str, shape, word_bits: int, modulus_bits: int) -> dict | None:
    """The butterfly NTT's build at `shape`, as a diagnostic: the integer
    SASS instructions of the instance the launch takes (ntt_instance) by
    pipe (sass_count), over a thread's P / 2 * log2 N butterflies (P
    coefficients a thread, ntt_coefficients_per_thread; a kernel that walks
    rows counts its loop body once, one row), and the time the CUDA cores
    take to issue them for the shape's rows x N / P threads
    (sass_issue_ms). None where the kernel holds a row in fewer than 16
    threads or cuobjdump is missing."""
    n = shape[-1]
    log2n = n.bit_length() - 1
    per_thread = ntt_coefficients_per_thread(word_bits, log2n)
    if n < 16 * per_thread:
        return None
    count = sass_count("ntt", rf"{name}_kernel{ntt_instance(word_bits, log2n, modulus_bits)}")
    if count is None:
        return None
    threads = prod(shape[:-1]) * n // per_thread
    return dict(per_butterfly={k: v / (per_thread // 2 * log2n) for k, v in count.items()},
                issue_ms=sass_issue_ms(count, threads), per_thread=per_thread)


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
    # timed before the plain version runs at this shape
    times = {name: cuda_ms(lambda kern=kern: kern(x, tables), 20)
             for name, kern in (("ntt_forward", ntt_cuda.forward), ("ntt_inverse", ntt_cuda.inverse))}
    k = ntt_cuda.forward(x, tables)
    ki = ntt_cuda.inverse(x, tables)
    route64 = {}
    for name, got, plain in (("ntt_forward", k, ntt.forward_ntt_plain),
                             ("ntt_inverse", ki, ntt.inverse_ntt_plain)):
        err = int((got - plain(x, tables)).abs().max())
        max_err[name] = max(max_err[name], err)
        ms = times[name]
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


def ntt_tables_of(moduli, n, block):
    import torch

    from she_tpu_torch.ops import ntt

    if block is None:
        return ntt.build_ntt_tables(moduli, n, torch.device("cuda"))
    return ntt.build_block_tables(moduli, *block, torch.device("cuda"))  # a sharded NTT's block tables


def ntt_kernel_timing(path: str, launch_shapes, batches: int) -> dict:
    """Each NTT kernel at every shape one path's run launched it with,
    timed before any plain version runs on it (a launch just after the wide
    route's plain NTT, whose gigabytes of temporaries were just freed, reads
    slow): ms (mean of 20 launches after a warm-up), ns per row, byte bound
    and its share, launches per batch, the build's integer SASS (ntt_sass)
    and, as a yardstick of the memory rate, one copy_ of the same tensor.
    Each row keeps the seed of its input for ntt_plain_checks."""
    import torch

    from she_tpu_torch.ops import ntt_cuda

    kernels = {"ntt_forward": ntt_cuda.forward, "ntt_inverse": ntt_cuda.inverse}
    out = {name: [] for name in kernels}
    for (name, shape, moduli, block), count in sorted(launch_shapes.items(),
                                                      key=lambda kv: (kv[0][0], -prod(kv[0][1]), str(kv[0][3]))):
        kern = kernels[name]
        n = shape[-1]
        tables = ntt_tables_of(moduli, n, block)
        seed = 50 + len(out[name])
        x = random_rows(moduli, shape[:-2], n, seed)
        y = torch.empty_like(x)
        rows = x.numel() // n
        ms = cuda_ms(lambda: kern(x, tables), 20)
        copy_ms = cuda_ms(lambda: y.copy_(x), 20)
        bound = kernel_bound_ms(shape, moduli, n)
        sass = ntt_sass(name, shape, tables.word_bits, max(moduli).bit_length())
        row = dict(path=path, shape=list(shape), moduli=list(moduli), block=block, rows=rows, word_bits=tables.word_bits,
                   launches_per_batch=count / batches, seed=seed, ms=ms, ns_per_row=1e6 * ms / rows,
                   copy_ms=copy_ms, bound_ms=bound, share_of_bound=bound / ms,
                   sass_int_per_butterfly=sass and sass["per_butterfly"], sass_issue_ms=sass and sass["issue_ms"],
                   coefficients_per_thread=sass and sass["per_thread"])
        out[name].append(row)
        log(f"{path} {name} {tuple(shape)}{'' if block is None else f' block tables {block}'} ({rows} rows, "
            f"{count / batches:g} per batch, {tables.word_bits}-bit words): kernel {ms:.4f} ms "
            f"({row['ns_per_row']:.2f} ns/row), copy_ {copy_ms:.4f} ms, byte bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f}% of bound)"
            + ("" if sass is None else f"; the build's integer SASS, {sass['per_butterfly']['alu']:.2f} ALU + "
               f"{sass['per_butterfly']['fma']:.2f} FMA a butterfly at {sass['per_thread']} coefficients a thread, "
               f"issues in {sass['issue_ms']:.4f} ms (a diagnostic)"))
        del x, y
    torch.cuda.empty_cache()
    for name, rows in out.items():
        per_batch = sum(r["launches_per_batch"] * r["ms"] for r in rows)
        log(f"{path} {name}: launches x ms summed over the shapes of one batch = {per_batch:.4f} ms")
    return out


def ntt_plain_checks(shapes: dict) -> None:
    """Every row of ntt_kernel_timing (rows by kernel) held bit-equal to the
    plain version on the same input, and the plain version timed (of 3
    launches on the int64 route, of 1 on the wide route, whose plain NTT is
    far slower); in place. Fails on any difference."""
    import torch

    from she_tpu_torch.ops import modarith, ntt, ntt_cuda

    kernels = {"ntt_forward": (ntt_cuda.forward, ntt.forward_ntt_plain),
               "ntt_inverse": (ntt_cuda.inverse, ntt.inverse_ntt_plain)}
    for name, rows in shapes.items():
        kern, plain = kernels[name]
        for row in rows:
            n = row["shape"][-1]
            moduli = tuple(row["moduli"])
            tables = ntt_tables_of(moduli, n, row["block"])
            x = random_rows(moduli, row["shape"][:-2], n, row["seed"])
            err = int((kern(x, tables) - plain(x, tables)).abs().max())
            if err:
                raise AssertionError(f"{name} at {tuple(row['shape'])}, moduli {moduli}: max |kernel - plain| = {err}")
            plain_iters = 1 if modarith.is_wide(max(moduli)) else 3
            row.update(max_abs_err=err, plain_ms=cuda_ms(lambda: plain(x, tables), plain_iters),
                       plain_iters=plain_iters)
            log(f"{row['path']} {name} {tuple(row['shape'])}: bit-equal to plain; plain {row['plain_ms']:.4f} ms "
                f"(x{plain_iters}) against the kernel's {row['ms']:.4f} ms")
            del x
    torch.cuda.empty_cache()


def shape_timing(path: str, launch_shapes, batches: int) -> dict:
    """One path's NTT launch shapes alone: ntt_kernel_timing, then
    ntt_plain_checks."""
    out = ntt_kernel_timing(path, launch_shapes, batches)
    ntt_plain_checks(out)
    return out


def random_residues(moduli, shape, degree, seed, device="cuda"):
    """int64 [*shape, L, N] uniform residues, drawn on the card."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = [torch.randint(0, q, tuple(shape) + (degree,), generator=g, device=device) for q in moduli]
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
    """The int8 dim-0 kernel at one shape on random residues: equal bit for
    bit to the plain int64 / wide MAC (ops/dim0_mac.dim0_mac_plain, not
    the dim0_mac kernel that dim0_inner_products launches on the card) at
    the full shape and to the plain digit form on the first DIM0_CUT_N n;
    then timed (CUDA events: the kernel over 20 launches, the plain MAC
    over 3, the plain digit form once) beside the digit-bmm yardstick and
    the bound."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import digits as dg
    from she_tpu_torch.ops import dim0_cuda, dim0_mac
    from she_tpu_torch.pir import serving

    D, L = dg.digit_count(moduli), len(moduli)
    db = random_residues(moduli, (C, d0), N, seed)
    query = random_residues(moduli, (d0, P), N, seed + 1)
    ctx = get_poly_context(N, tuple(moduli), 64, db.device)
    digits = serving.pack_database_chunk_digits(db, ctx)
    got = dim0_cuda.dim0_int8(digits, query, ctx)
    err_mac = int((got - dim0_mac.dim0_mac_plain(db, query, ctx)).abs().max())
    del got
    cut = min(DIM0_CUT_N, N)
    cut_digits = serving.pack_database_chunk_digits(db[..., :cut].contiguous(), ctx)
    cut_query = query[..., :cut].contiguous()
    err_plain = int((dim0_cuda.dim0_int8(cut_digits, cut_query, ctx)
                     - serving.dim0_inner_products_int8(cut_digits, cut_query, ctx)).abs().max())
    if err_mac or err_plain:
        raise AssertionError(f"{label} dim0_int8 at C={C}, d0={d0}, P={P}, N={N}: max |kernel - plain MAC| = {err_mac}, "
                             f"max |kernel - plain digit form| = {err_plain}")
    ms = cuda_ms(lambda: dim0_cuda.dim0_int8(digits, query, ctx), 20)
    mac_ms = cuda_ms(lambda: dim0_mac.dim0_mac_plain(db, query, ctx), 3)
    plain_ms = cuda_ms(lambda: serving.dim0_inner_products_int8(digits, query, ctx), 1)
    library_ms = digit_bmm_ms(digits, query, D)
    bound = dim0_bound(L, N, digits.shape[2], d0, P, C, D)
    row = dict(path=label, digits_shape=list(digits.shape), query_shape=list(query.shape), moduli=list(moduli),
               digits=D, C=C, d0=d0, P=P, max_abs_err=max(err_mac, err_plain), plain_check_n=cut, ms=ms,
               mac_ms=mac_ms, plain_ms=plain_ms, library_ms=library_ms, **bound,
               share_of_bound=bound["bound_ms"] / ms)
    log(f"{label} dim0_int8 C={C} d0={d0} P={P} L={L} N={N} ({D} digits): equal to the plain MAC and (first {cut} n) "
        f"to the plain digit form; kernel {ms:.4f} ms, plain MAC {mac_ms:.4f} ms, plain digit form {plain_ms:.4f} ms, "
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


def dim0_w64_check() -> dict:
    from she_tpu_torch import params as paramsmod

    moduli = paramsmod.from_predefined(PATHS["w64"][0], scalar_bits=64).coefficient_moduli[:-1]
    return dim0_case("w64_check", moduli, *DIM0_W64_CHECK, 90)


def dim0_kernel_entry(rows: list, w64_check: dict, launches: int) -> dict:
    """The int8 dim-0 kernel's entry of the kernels line, at the widest of
    `rows` (dim0_case results)."""
    widest = max(rows, key=lambda r: r["bytes"])
    return dict(
        name="dim0_int8", route="cuda", source="she_tpu_torch/csrc/dim0_int8.cu",
        replaces="she_tpu/pir/serving.py:222", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows + [w64_check]),
        ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"], bound_by=widest["bound_by"],
        library_ms=widest["library_ms"],
        library="torch.bmm, float32 digit operands, TF32 off: the digit products only",
        mac_ms=widest["mac_ms"], widest_path=widest["path"], widest_digits_shape=widest["digits_shape"],
        widest_query_shape=widest["query_shape"], shapes=rows, w64_check=w64_check,
    )


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
    kernel_ms = {k: sum(us for name, us in by_name.items() if PROFILE_NAMES.get(k, f"{k}_kernel") in name) / 1e3
                 for k in NTT_AND_DIM0 + KS_KERNELS + BEHZ_KERNELS + ("dim0_mac",)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    log(f"[{path}] profiled batch: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {launches} device kernels and copies")
    for name, us in top:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {name[:110]}")
    log(f"[{path}]  the port's kernels in the profiled batch: {kernel_ms} ms, "
        f"{100 * sum(kernel_ms.values()) * 1e3 / busy_us:.1f}% of device time")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us,
                device_launches=launches, top_ms={k: v / 1e3 for k, v in top}, kernel_ms=kernel_ms)


def serving_setup(path: str, seed: int, batches: int, label: str | None = None) -> dict:
    """A MulPIR path made as a user makes it: the context on the card, the
    1M x 1 B database processed, keys, the batched server and `batches`
    batches of 128 queries from the port's client (fresh ones each batch
    where the path says so); logs under `label` (the path's name)."""
    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = label or path
    params, scalar_bits, fresh_queries = PATHS[path]
    ep = paramsmod.from_predefined(params, scalar_bits=scalar_bits)
    ctx = bfv.get_bfv_context(ep)  # the CUDA card
    config = ip.IndexPirConfig(
        entry_count=ENTRY_COUNT, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    parameter = ip.generate_parameter(config, ctx)
    log(f"[{label}] {params} at {scalar_bits}-bit scalars, moduli {ep.coefficient_moduli}, "
        f"t = {ep.plaintext_modulus}")
    log(f"[{label}] PIR parameter: dims {parameter.dimensions}, {parameter.expanded_query_count} expanded "
        f"ciphertexts per query, Galois elements {parameter.evaluation_key_config.galois_elements}")
    rng = np.random.default_rng(seed)
    database = rng.integers(0, 256, size=(ENTRY_COUNT, 1), dtype=np.uint8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = ip.MulPirServer.process(database, ctx, parameter)
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    log(f"[{label}] database processed in {process_s:.3f} s: {processed.count} plaintexts, "
        f"{int(processed.present.sum())} non-zero")

    t0 = time.perf_counter()
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = ip.MulPirClient(parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    torch.cuda.synchronize()
    log(f"[{label}] keys and server ready in {time.perf_counter() - t0:.3f} s")

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
    log(f"[{label}] {distinct} queries generated in {time.perf_counter() - t0:.3f} s "
        f"({'fresh queries in each batch' if fresh_queries else 'the same queries in each batch'})")
    return dict(params=params, scalar_bits=scalar_bits, fresh_queries=fresh_queries, ctx=ctx, parameter=parameter,
                database=database, processed=processed, process_s=process_s, sk=sk, client=client, ek=ek,
                server=server, all_indices=all_indices, all_queries=all_queries)


def main_path(path: str, seed: int, batches: int) -> dict:
    """One path of the port's batched MulPIR serving, as a user drives it."""
    import torch

    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip

    setup = serving_setup(path, seed, batches)
    params, scalar_bits, fresh_queries = PATHS[path]
    ctx, parameter, database, processed = setup["ctx"], setup["parameter"], setup["database"], setup["processed"]
    sk, client, ek, server = setup["sk"], setup["client"], setup["ek"], setup["server"]
    all_indices, all_queries, process_s = setup["all_indices"], setup["all_queries"], setup["process_s"]

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
    counts = read_counts(path, server.use_dim0_int8, mac=not server.use_dim0_int8)
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
        launch_shapes=counts["launch_shapes"],
        ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"], dim0_shapes=counts["dim0_shapes"], batches=batches,
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


PIR_STAGES = {"stack": "stack", "expand": "expansion", "dim0": "dim0",
              "fold_dimensions": "behz_relinearize", "mod_switch": "mod_switch"}


def stage_split(server, queries: list, ek, want: list, names: dict = PIR_STAGES,
                same=assert_same_responses) -> dict:
    """One batch through compute_response_batch with a CUDA event recorded
    at each of its stage marks: device ms of each stage (by default PIR's:
    stacking, expansion, dim-0 (query to Eval, MAC, columns to Coeff),
    BEHZ + relinearization, and mod switch), each span ending at its
    stage's mark. The answers must equal `want`, the same batch's earlier
    answers (checked by `same`)."""
    import torch

    marks = []

    def mark(stage: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((names[stage], e))

    torch.cuda.synchronize()
    mark("stack")  # the start: the first span is the stacking
    got = server.compute_response_batch(queries, ek, on_stage=mark)
    torch.cuda.synchronize()
    same("stage split", got, want)
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
        ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"],
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
                launches=launches, launch_shapes=counts["launch_shapes"],
                ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"], dim0_shapes=counts["dim0_shapes"],
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


def per_request_launches(launches: dict, requests: int) -> dict:
    """Each kernel's launches a request (those it launched), with the
    expansion levels a request ran (the registry's expansion_level)."""
    from she_tpu_torch import trace

    out = {k: v / requests for k, v in launches.items() if v}
    out["expansion_levels"] = trace.counters["expansion_level"] / requests
    return out


def service_phase(ctx, processed, rows: dict, absent: list, seed: int) -> dict:
    """The keyword cell's processed 1M-keyword database behind PirService,
    driven as a client of the protobuf envelope: a ConfigRequest, an
    EvaluationKeys upload and SERVICE_REQUESTS PIRRequests (the last for an
    absent keyword), each sent and answered as bytes; every answer is
    decrypted and checked. The service answers on the per-query
    KeywordPirServer, as she_tpu's does, whose expansion runs level by
    level on the key-switch kernels (pir/expansion.py); the kernels'
    launches a request are reported."""
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
    # the per-query server: its expansion level by level, a ct x pt MAC a column
    counts = read_counts(label, False, mac=True)
    per_request = per_request_launches(counts["launches"], len(keywords))
    log(f"[{label}] PirService over the {len(rows)}-keyword database: config {len(config_bytes)} bytes, "
        f"evaluation keys {key_bytes} bytes; {len(keywords)} PIR requests as bytes ({len(keywords) - 1} present "
        f"keywords gave their values, 1 absent gave None; {answer_bytes} bytes an answer); seconds a request "
        f"(parse, serve, serialize): {[round(x, 4) for x in request_s]}, median {statistics.median(request_s):.4f} s; "
        f"kernel launches a request {per_request}")
    return dict(path=label, requests=len(keywords), request_s=request_s, median_request_s=statistics.median(request_s),
                launches_per_request=per_request,
                config_bytes=len(config_bytes), evaluation_key_bytes=key_bytes, answer_bytes=answer_bytes,
                launches=counts["launches"], launch_shapes=counts["launch_shapes"], ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"],
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
    # the per-query server: its expansion level by level, a ct x pt MAC a column
    counts = read_counts(label, False, mac=True)
    per_request = per_request_launches(counts["launches"], len(keywords))
    log(f"[{label}] {count} keywords sealed (OPRF P-384 + AES-192-GCM) and processed in {process_s:.3f} s "
        f"({1e3 * process_s / count:.1f} ms a row); {len(keywords)} lookups ({n_absent} absent): every present "
        f"value unsealed to its value, every absent keyword gave None; OPRF round trip median "
        f"{statistics.median(oprf_s):.4f} s, PIR request median {statistics.median(pir_s):.4f} s; "
        f"kernel launches a request {per_request}")
    return dict(path=label, keywords=count, lookups=len(keywords), absent=n_absent, process_s=process_s,
                median_request_s=statistics.median(pir_s), launches_per_request=per_request,
                oprf_s=oprf_s, pir_request_s=pir_s, launches=counts["launches"],
                launch_shapes=counts["launch_shapes"],
                ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"], dim0_shapes=counts["dim0_shapes"], batches=1)


PNNS_STAGES = {"stack": "stacking", "baby_steps": "baby_step_rotations", "to_eval": "to_eval",
               "bsgs_mac": "bsgs_mac", "inverse_ntt": "inverse_ntt", "rotate_and_sum": "giant_step_rotate_and_sum",
               "mod_switch": "mod_switch"}


def assert_same_pnns_responses(label: str, got: list, want: list) -> None:
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} responses, expected {len(want)}")
    for g, w in zip(got, want):
        for gm, wm in zip(g.ciphertext_matrices, w.ciphertext_matrices, strict=True):
            for gc, wc in zip(gm.ciphertexts, wm.ciphertexts, strict=True):
                if gc.poly_context() is not wc.poly_context() or not torch.equal(gc.stacked(), wc.stacked()):
                    raise AssertionError(f"{label}: responses differ")


def pnns_path(label: str, seed: int, batches: int) -> dict:
    """PNNS as a user drives it (bench_pnns / bench_pnns_w64): a 4,096 x 128
    float32 database processed with diagonal BSGS packing, the port's
    client, BatchedPnnsServer serving PNNS_BATCH cosine-similarity queries
    a batch; every score checked exactly, two queries against the
    per-query server, the stream against the batch; the stage split and a
    profiled batch."""
    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.ops import ntt_cuda
    from she_tpu_torch.pnns import pnns
    from she_tpu_torch.pnns import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    params, scalar_bits = PNNS_PATHS[label]
    rows, dim = PNNS_DB
    ep = paramsmod.from_predefined(params, scalar_bits=scalar_bits)
    reset_counts()  # the set-up's launch shapes are checked too
    ctx = bfv.get_bfv_context(ep)  # the CUDA card
    sf = pnns.max_scaling_factor(dim, [ep.plaintext_modulus])
    ek_config = pnns.matmul_evaluation_key_config(ctx, pnns.MatrixDimensions(rows, dim), 1)
    client_config = pnns.ClientConfig.create(ep, sf, pnns.MatrixPacking.dense_row(), dim, ek_config)
    bsgs = pnns.BabyStepGiantStep.create(dim)
    server_config = pnns.ServerConfig(client_config, pnns.MatrixPacking.diagonal(bsgs))
    log(f"[{label}] {params} at {scalar_bits}-bit scalars, moduli {ep.coefficient_moduli}, t = {ep.plaintext_modulus}; "
        f"{rows} x {dim} database, cosine similarity, scaling factor {sf}, BSGS baby step {bsgs.baby_step}, giant "
        f"step {bsgs.giant_step}; Galois elements {ek_config.galois_elements}; {PNNS_BATCH} queries a batch")
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((rows, dim)).astype(np.float32)
    database = pnns.Database([pnns.DatabaseRow(i, b"", vectors[i]) for i in range(rows)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = pnns.process_database(database, server_config)
    torch.cuda.synchronize()
    process_s = time.perf_counter() - t0
    log(f"[{label}] database processed in {process_s:.4f} s: {len(processed.plaintext_matrices[0].plaintexts)} "
        f"Eval plaintexts")

    t0 = time.perf_counter()
    client = pnns.Client(client_config)
    sk = client.generate_secret_key(nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"pnns-evaluation-key-err-seed-32b"))
    server = serving.BatchedPnnsServer(processed)
    query_vectors = rng.standard_normal((PNNS_BATCH, 1, dim)).astype(np.float32)
    queries = [client.generate_query(v, sk, err_rng=nist_aes128_ctr(bytes([i]) * 32))
               for i, v in enumerate(query_vectors)]
    torch.cuda.synchronize()
    setup_shapes = launch_shapes_of(NTT_KERNELS)
    log(f"[{label}] keys, server and {PNNS_BATCH} queries ready in {time.perf_counter() - t0:.4f} s")

    # the main path, with the launch counts read around it: the first batch
    # and `batches` more of the same queries
    served = batches + 1
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s, all_responses = [], []
    for _ in range(served):
        t0 = time.perf_counter()
        responses = server.compute_response_batch(queries, ek)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        all_responses.append(responses)
    # rotations (key switches only) and the BSGS MAC
    counts = read_counts(label, False, expands=False, multiplies=False, mac=True)
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()
    steady = batch_s[1:]
    for i, s in enumerate(batch_s):
        log(f"[{label}] batch {i}{' (first)' if i == 0 else ''}: {s:.4f} s, {PNNS_BATCH / s:.2f} queries/s")
    log(f"[{label}] median {statistics.median(steady):.4f} s/batch, max {max(steady):.4f} s over {len(steady)} "
        f"batches, {PNNS_BATCH / statistics.median(steady):.2f} queries/s; kernel launches over {served} batches: "
        f"{launches}, a batch: { {k: v / served for k, v in launches.items()} }; plain NTT on CUDA: none")
    log(f"[{label}] peak device memory during serving: {peak} bytes ({peak / 2**30:.3f} GiB)")
    for responses in all_responses[1:]:
        assert_same_pnns_responses(f"[{label}] repeated batch", responses, all_responses[0])

    t0 = time.perf_counter()
    db_rounded = pnns.normalized_scaled_and_rounded(vectors, sf)
    for qv, response in zip(query_vectors, all_responses[0]):
        want = db_rounded @ pnns.normalized_scaled_and_rounded(qv, sf).T  # [rows, 1]
        got = client.scores(response, sk)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"[{label}] scores differ from the integer dot products: "
                                 f"{int((got != want).sum())} of {want.size}")
    log(f"[{label}] all {PNNS_BATCH} x {rows} scores equal the integer dot products of the rounded vectors "
        f"({time.perf_counter() - t0:.3f} s)")

    single_ctx = ctx.ciphertext_context.get_context(1)
    stacked = torch.stack([r.ciphertext_matrices[0].ciphertexts[0].stacked() for r in all_responses[0]])
    min_budget = bfv.noise_budget(bfv.Ciphertext.from_stacked(ctx, stacked, single_ctx), sk)
    if not min_budget > 0:
        raise AssertionError(f"[{label}] a response has no noise budget left: {min_budget}")
    log(f"[{label}] smallest noise budget of the {PNNS_BATCH} responses: {min_budget:.3f} bits")

    t0 = time.perf_counter()
    reference = pnns.Server(processed)
    for i in (0, PNNS_BATCH - 1):
        assert_same_pnns_responses(f"[{label}] per-query server, query {i}", [all_responses[0][i]],
                                   [reference.compute_response(queries[i], ek)])
    log(f"[{label}] batched responses of queries 0 and {PNNS_BATCH - 1} are bit-identical to the per-query "
        f"server's ({time.perf_counter() - t0:.3f} s)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = server.compute_response_stream([queries, queries], ek)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    assert_same_pnns_responses(f"[{label}] stream", stream, all_responses[0] + all_responses[0])
    log(f"[{label}] compute_response_stream over 2 batches: {stream_s:.4f} s, answers equal to the batched ones")

    stages = stage_split(server, queries, ek, all_responses[0], PNNS_STAGES, assert_same_pnns_responses)
    log(f"[{label}] device ms by stage (CUDA events, one batch): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profiled = profile_batch(label, server, queries, ek)
    ntt_ms = profiled["kernel_ms"]["ntt_forward"] + profiled["kernel_ms"]["ntt_inverse"]
    profiled["ntt_share"] = ntt_ms / profiled["busy_ms"]
    profiled["idle_share_of_steady_batch"] = 1 - profiled["busy_ms"] / (1e3 * statistics.median(steady))
    log(f"[{label}] NTT kernels {ntt_ms:.3f} ms, {100 * profiled['ntt_share']:.1f}% of the profiled batch's device "
        f"time; device idle share of the median unprofiled batch: {profiled['idle_share_of_steady_batch']:.3f}")
    return dict(
        path=label, params=params, scalar_bits=scalar_bits, rows=rows, dim=dim, batch=PNNS_BATCH,
        baby_step=bsgs.baby_step, giant_step=bsgs.giant_step, process_s=process_s, batch_s=batch_s,
        first_batch_s=batch_s[0], median_s_per_batch=statistics.median(steady), max_s_per_batch=max(steady),
        steady_batches=len(steady), queries_per_s=PNNS_BATCH / statistics.median(steady), stream_s=stream_s,
        stages_ms=stages, profile=profiled, min_noise_budget=min_budget, peak_bytes=peak, launches=launches,
        launches_per_batch={k: v / served for k, v in launches.items()}, launch_shapes=counts["launch_shapes"],
        ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"],
        dim0_shapes=counts["dim0_shapes"], batches=served, setup_launch_shapes=setup_shapes,
    )


def simple_pir_bound(pd: int, rows: int, k: int, columns: int, bits: int, plaintext_bits: int) -> dict:
    """The least time of one SimplePIR product: the D planes the work needs
    (P_D * R * C bytes, without the padding of C), the int64 query read
    once and the int64 output written once over the memory rate, and its
    u8 operations (2 R C k for each plane pair (i, j) of weight below 2^b,
    i + j < P_Q; the others vanish mod 2^b) over the int8 tensor-core rate.
    Beside it, `data_bound_ms`: the same with D read at p bits an entry,
    the floor of any layout (the planes spend P_D bytes on p bits)."""
    from she_tpu_torch.ops import simple_pir_cuda

    io_bytes = 8 * k * columns + 8 * k * rows
    nbytes = pd * rows * columns + io_bytes
    data_bytes = -(-rows * columns * plaintext_bits // 8) + io_bytes
    pq = simple_pir_cuda.plane_count(bits)
    pairs = sum(pq - i for i in range(min(pd, pq)))
    ops = 2 * pairs * rows * columns * k
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
    return dict(bytes=nbytes, operations=ops, bytes_ms=bytes_ms, operations_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                data_bytes=data_bytes, data_bound_ms=1e3 * data_bytes / HBM_BYTES_PER_S)


def float64_product_ms(database, queries, bits: int, want) -> tuple[float, int]:
    """The yardstick: one float64 torch.matmul of the database (held as
    float64) by the queries cut into 16-bit pieces side by side ([R, C] x
    [C, pieces * k]), exact while (2^p - 1) (2^16 - 1) C < 2^53; the pieces'
    sums recombined mod 2^b must equal `want` (the kernel's answer). Returns
    (ms of the matmul alone, pieces)."""
    import torch

    pieces = -(-bits // 16)
    columns = database.shape[1]
    top = int(database.max())
    if top * 0xFFFF * columns >= 1 << 53:
        raise AssertionError("the float64 yardstick is not exact at this shape")
    d = database.to(torch.float64)
    q = torch.cat([((queries >> (16 * j)) & 0xFFFF) for j in range(pieces)]).to(torch.float64).T.contiguous()
    out = torch.matmul(d, q).to(torch.int64)  # [R, pieces * k]
    k = queries.shape[0]
    got = sum((out[:, j * k : (j + 1) * k] & ((1 << bits) - 1)) << (16 * j) for j in range(pieces)) & ((1 << bits) - 1)
    if not torch.equal(got.T, want):
        raise AssertionError("the float64 yardstick disagrees with the kernel")
    ms = cuda_ms(lambda: torch.matmul(d, q), 3)
    del d, q, out, got
    torch.cuda.empty_cache()
    return ms, pieces


def simple_pir_case(label: str, planes, queries, database, bits: int, plaintext_bits: int, count: int,
                    batches: int, ms: float) -> dict:
    """simple_pir_matmul at one launched shape, on the served planes and
    request rows, with `ms` its time (simple_pir_path times every shape
    first): held bit-equal to its plain version (float64 plane products on
    the card), which is timed with the float64 yardstick over 3, beside its
    bound."""
    import torch

    from she_tpu_torch.ops import simple_pir_cuda

    got = simple_pir_cuda.simple_pir_matmul_cuda(planes, queries, bits)
    err = int((got - simple_pir_cuda.simple_pir_matmul_plain(planes, queries, bits)).abs().max())
    if err:
        raise AssertionError(f"{label} simple_pir_matmul at planes {tuple(planes.data.shape)}, queries "
                             f"{tuple(queries.shape)}: max |kernel - plain| = {err}")
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: simple_pir_cuda.simple_pir_matmul_plain(planes, queries, bits), 3)
    torch.cuda.empty_cache()
    library_ms, pieces = float64_product_ms(database, queries, bits, got)
    bound = simple_pir_bound(planes.data.shape[0], planes.rows, queries.shape[0], queries.shape[1], bits,
                             plaintext_bits)
    row = dict(path=label, planes_shape=list(planes.data.shape), query_shape=list(queries.shape), bits=bits,
               launches_per_batch=count / batches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, library_pieces=pieces, **bound, share_of_bound=bound["bound_ms"] / ms)
    log(f"{label} simple_pir_matmul planes {tuple(planes.data.shape)} ({planes.rows} rows) x queries "
        f"{tuple(queries.shape)} mod 2^{bits}: "
        f"bit-equal to plain; kernel {ms:.4f} ms, plain (float64 plane products) {plain_ms:.4f} ms, float64 "
        f"matmul of {pieces} 16-bit pieces {library_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['operations']} u8 operations), "
        f"{100 * bound['bound_ms'] / ms:.1f}% of bound; at p = {plaintext_bits} bits an entry "
        f"{bound['data_bound_ms']:.4f} ms ({bound['data_bytes']} bytes), {100 * bound['data_bound_ms'] / ms:.1f}%")
    del got
    torch.cuda.empty_cache()
    return row


def batch_span(run) -> dict:
    """One more batch, run(), between two CUDA events: its wall time, the
    device's span from the first launch to the last, and the idle share
    1 - span / wall. (torch.profiler's key_averages() reports no device
    time for a batch made only of ctypes launches.)"""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    span_ms = start.elapsed_time(end)
    return dict(wall_ms=wall_ms, span_ms=span_ms, idle_share=1 - span_ms / wall_ms)


def simple_pir_path(seed: int, batches: int) -> dict:
    """SimplePIR as a user drives it: a 1 GiB database of SIMPLE_PIR_DB
    entries from default_rng(seed) processed on the card (packing, then the
    hint through the NTT), a server (the database's byte planes) and a
    client (the A polynomials to Eval), SIMPLE_PIR_BATCH queries (one
    precompute_query + add(index) each, distinct random indices, the
    system's randomness as a client's), `batches` batches of their stacked
    request rows and one per-query call. The counts are read around all of
    it. Every answer must decrypt to its entry's bytes; then the kernel is
    timed at each launched shape and held to its plain version."""
    import numpy as np
    import torch

    from she_tpu_torch.ops import simple_pir_cuda
    from she_tpu_torch.pir import simple_pir as sp

    label = SIMPLE_PIR_CELL
    count, size = SIMPLE_PIR_DB
    p_bits, b_bits, n = SIMPLE_PIR_PARAMS
    ep = sp.SimplePirEncryptionParams(p_bits, b_bits, n)  # QUANTUM128: b <= 41 at n = 2048
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    entries = np.frombuffer(rng.bytes(count * size), dtype=np.uint8).reshape(count, size)
    generate_s = time.perf_counter() - t0

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = {}

    def mark(stage: str) -> None:
        torch.cuda.synchronize()
        marks[stage] = time.perf_counter()

    t0 = time.perf_counter()
    results = sp.process_database(entries, ep, seed=seed.to_bytes(4, "little") * 8, on_stage=mark)
    pack_s, hint_s = marks["pack"] - t0, marks["hint"] - marks["pack"]
    params = results.params
    log(f"[{label}] p = {p_bits}, b = {b_bits}, n = {n}: {count} entries x {size} bytes ({count * size} bytes, made in "
        f"{generate_s:.3f} s) -> database {tuple(results.database.shape)} {results.database.dtype}, "
        f"{params.a_poly_count} A polynomials, hint {tuple(results.hint.shape)}; packing {pack_s:.3f} s, hint "
        f"{hint_s:.3f} s")
    t0 = time.perf_counter()
    server = sp.SimplePirServer(results.database, results.hint, params)
    client = sp.SimplePirClient(params, results.hint)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    indices = [int(i) for i in rng.choice(count, size=SIMPLE_PIR_BATCH, replace=False)]
    query_s, queries = [], []
    for index in indices:
        t0 = time.perf_counter()
        queries.append(client.precompute_query().add(index))
        torch.cuda.synchronize()
        query_s.append(time.perf_counter() - t0)
    prepared = [q.prepare_response() for q in queries]
    requests = torch.cat([q.queries for q in queries])
    batch_s, answers = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers.append(server.compute_response(requests))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    single = server.compute_response(queries[0].queries)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    counts = read_counts(label, False, simple_pir=True, switches=False, expands=False, multiplies=False,
                         mod_switches=False)
    peak = torch.cuda.max_memory_allocated()
    served_shapes = {(tuple(server.planes.data.shape), server.planes.rows, tuple(q.shape), b_bits): c
                     for q, c in ((requests, batches), (queries[0].queries, 1))}
    if counts["simple_pir_shapes"] != served_shapes:
        raise AssertionError(f"[{label}] SimplePIR launches {counts['simple_pir_shapes']}, expected {served_shapes}")

    t0 = time.perf_counter()
    for answer in answers[1:]:
        if not torch.equal(answer, answers[0]):
            raise AssertionError(f"[{label}] a repeated batch gave other answers")
    rows = params.chunks_per_entry  # request rows a query
    if not torch.equal(single, answers[0][:rows]):
        raise AssertionError(f"[{label}] the per-query answer differs from the batch's")
    wrong = [(b, i) for b, answer in enumerate(answers) for i, index in enumerate(indices)
             if client.decrypt(answer[i * rows : (i + 1) * rows], prepared[i], index) != entries[index].tobytes()]
    wrong += [("single", 0)] if client.decrypt(single, prepared[0], indices[0]) != entries[indices[0]].tobytes() else []
    if wrong:
        raise AssertionError(f"[{label}] {len(wrong)} answers do not decrypt to their entries: {wrong[:8]}")
    check_s = time.perf_counter() - t0
    median = statistics.median(batch_s)
    log(f"[{label}] {SIMPLE_PIR_BATCH} queries (host s a client: median {statistics.median(query_s):.4f}, max "
        f"{max(query_s):.4f}); batches {[round(x, 5) for x in batch_s]} s: median {median:.5f} s, max "
        f"{max(batch_s):.5f} s, {SIMPLE_PIR_BATCH / median:.2f} queries/s; per-query call {single_s:.5f} s; "
        f"all {batches} x {SIMPLE_PIR_BATCH} + 1 answers decrypt to their entries ({check_s:.3f} s); server and "
        f"client set up in {setup_s:.3f} s; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); kernel "
        f"launches {counts['launches']}")

    span = batch_span(lambda: server.compute_response(requests))
    # the kernel is timed (CUDA events, 20 launches) at every shape before
    # any plain version: launches right after one, whose 7.6 GB of float64
    # temporaries were just freed, ran 16-18% slower for a while (PERF.md)
    launched = ((requests, batches), (queries[0].queries, 1))
    times = [cuda_ms(lambda q=q: simple_pir_cuda.simple_pir_matmul_cuda(server.planes, q, b_bits), 20)
             for q, _ in launched]
    rows = [simple_pir_case(label, server.planes, q, results.database, b_bits, p_bits, c, batches, ms)
            for (q, c), ms in zip(launched, times)]
    del server, client, results, requests, answers, single, queries, prepared, entries
    torch.cuda.empty_cache()
    return dict(
        path=label, params=f"p={p_bits},b={b_bits},n={n}", entries=count, entry_size=size, batch=SIMPLE_PIR_BATCH,
        database_shape=[params.column_size, params.database_columns], a_poly_count=params.a_poly_count,
        generate_s=generate_s, process_s=pack_s + hint_s, pack_s=pack_s, hint_s=hint_s, setup_s=setup_s,
        query_s=query_s, median_query_s=statistics.median(query_s), batch_s=batch_s, median_s_per_batch=median,
        max_s_per_batch=max(batch_s), queries_per_s=SIMPLE_PIR_BATCH / median, single_s=single_s, peak_bytes=peak,
        span=span,
        launches=counts["launches"], launch_shapes=counts["launch_shapes"],
        ks_shapes=counts["ks_shapes"], behz_shapes=counts["behz_shapes"], mac_shapes=counts["mac_shapes"], dim0_shapes=counts["dim0_shapes"],
        simple_pir_rows=rows, served_batches=batches,
        batches=1,  # the NTT runs in the set-up and the clients, not per batch: shape_timing counts a run
    )


def simple_pir_kernel_entry(rows: list, launches: dict) -> dict:
    """simple_pir_matmul's entry of the kernels line, at the widest of
    `rows` (simple_pir_case results)."""
    widest = max(rows, key=lambda r: r["bytes"])
    return dict(
        name="simple_pir_matmul", route="cuda", source="she_tpu_torch/csrc/simple_pir_matmul.cu",
        replaces="she_tpu/pir/simple_pir.py:283", launches=sum(launches.values()), launches_by_path=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=widest["ms"], plain_ms=widest["plain_ms"],
        bound_ms=widest["bound_ms"], bound_by=widest["bound_by"], library_ms=widest["library_ms"],
        data_bound_ms=widest["data_bound_ms"], library="torch.matmul in float64: the database held as float64 by the queries cut into 16-bit pieces",
        widest_planes_shape=widest["planes_shape"], widest_query_shape=widest["query_shape"], shapes=rows,
    )


def ntt_kernel_entries(shapes: dict, paths: dict, checked: dict | None) -> list:
    """The NTT kernels' entries of the kernels line, at the widest shape of
    `shapes` (shape_timing rows by kernel), with `checked` (kernel_phase's
    result) where the run made it."""
    out = []
    for name, line in (("ntt_forward", 217), ("ntt_inverse", 261)):
        widest = max(shapes[name], key=lambda r: prod(r["shape"]))
        errs = [r["max_abs_err"] for r in shapes[name]] + ([checked["max_abs_err"][name]] if checked else [])
        out.append(dict(
            name=name, route="cuda", source="she_tpu_torch/csrc/ntt.cu",
            replaces=f"she_tpu/ops/ntt_pallas.py:{line}",
            launches=sum(p["launches"][name] for p in paths.values()), max_abs_err=max(errs),
            ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"],
            bound_by="bytes", library_ms=None, sass_issue_ms=widest["sass_issue_ms"],
            library="none: no PyTorch call computes an exact modular NTT",
            widest_shape=widest["shape"], widest_path=widest["path"],
            launches_by_path={p: v["launches"][name] for p, v in paths.items()}, shapes=shapes[name],
            **({"route64": checked["route64"][name]} if checked else {}),
        ))
    return out


def launch_keys(paths: dict, field: str) -> dict:
    """Every launch key of one kernel family (the paths' `field`:
    "ks_shapes", "behz_shapes") -> its launches a batch by path."""
    keys = {}
    for path, result in paths.items():
        for key, count in result.get(field, {}).items():
            keys.setdefault(key, {})[path] = count / result["batches"]
    return keys


def ks_bytes(key) -> int:
    """The bytes one key-switch launch must move (`key` a
    key_switch_cuda.KsKey): each int64 input read once, each output
    written once; the constants are a few words."""
    name, shape, moduli, variant = key
    words, l_ks, n = 8, len(moduli), shape[-1]
    if name == "ks_digits":  # c1 [..., L_t, N] in, [..., L_t, L_ks, N] out
        return words * prod(shape) * (1 + l_ks)
    if name == "ks_mac":  # fwd [..., L_t, L_ks, N] and the key [L_t, 2, L_ks, N] in, [..., 2, L_ks, N] out
        batch, l_t = prod(shape[:-3]), shape[-3]
        return words * n * l_ks * (batch * l_t + l_t * 2 + batch * 2)
    if name == "ks_finish":  # inv [..., 2, L_ks, N], c0 and c1 where given in, [..., 2, L_t, N] out
        batch, l_t = prod(shape[:-3]), l_ks - 1
        _, c0, c1, _ = variant
        return words * n * batch * (2 * l_ks + (int(c0) + int(c1)) * l_t + 2 * l_t)
    if name == "mod_switch":  # x [..., L, N] in, [..., target, N] out
        return words * prod(shape[:-2]) * n * (shape[-2] + variant[0])
    if name == "ks_digits_ntt_mac":  # c1 [..., L_t, N] and the int32 key [L_t, 2, L_ks, N] in, [..., 2, L_ks, N] int32 out
        batch, l_t = prod(shape[:-2]), shape[-2]
        return n * (words * batch * l_t + 4 * l_t * 2 * l_ks + 4 * batch * 2 * l_ks)
    if name == "ks_intt_finish":  # int32 products [..., 2, L_ks, N], c0 and c1 where given in, [..., 2, L_t, N] out
        batch, l_t = prod(shape[:-3]), l_ks - 1
        _, c0, c1, _ = variant
        return n * batch * (4 * 2 * l_ks + words * ((int(c0) + int(c1)) * l_t + 2 * l_t))
    return words * 4 * prod(shape)  # expand_combine, expand_leaves: the update and the parents in, both children out


def ks_case(key, seed: int, device="cuda") -> dict:
    """The inputs of one key-switch launch shape on the card, made from
    `seed`: the kernel, its plain version and, where one PyTorch call
    computes the kernel's whole function, that call, each as a function
    of no arguments returning what the kernel writes. Indexed operands
    read a random pool of `slots` through distinct random indices, c0 and
    c1 are views of one stacked tensor, as on the main path, and the mod
    switch's input is laid out with the strides the launch read.
    expand_combine's kernel writes into a copy of the pool made here and
    its plain version into a copy made at each call, so both start from
    the same untouched pool and every slot is compared."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import key_switch as ks
    from she_tpu_torch.ops import key_switch_cuda as kc

    name, shape, moduli, variant = key
    dev, n = torch.device(device), shape[-1]
    ctx = get_poly_context(n, moduli, 64, dev)
    target = moduli[:-1]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    library = None

    def residues(mods, batch, salt):
        return random_residues(mods, batch, n, seed + salt, dev)

    def stacked(batch, slots, polys):
        """A [slots or batch[0], *batch[1:], polys, L_t, N] tensor and the index of its axis 0."""
        if slots is None:
            return residues(target, tuple(batch) + (polys,), 1), None
        index = torch.randperm(slots, generator=g, device=dev)[: batch[0]]
        return residues(target, (slots,) + tuple(batch[1:]) + (polys,), 1), index

    if name == "ks_digits":
        element, slots = variant
        base, index = stacked(shape[:-2], slots, 2)
        c1 = base[..., 1, :, :]
        kernel = lambda: kc.ks_digits(c1, moduli, element, index)  # noqa: E731
        plain = lambda: ks.ks_digits_plain(c1, ctx, element, index)  # noqa: E731
        if element is None and index is None:
            library = lambda: torch.remainder(c1.unsqueeze(-2), ctx.q_col)  # noqa: E731
    elif name == "ks_mac":
        fwd = residues(moduli, shape[:-2], 2)
        key_rows = residues(moduli, (shape[-3], 2), 3)
        kernel = lambda: kc.ks_mac(fwd, key_rows, moduli)  # noqa: E731
        plain = lambda: ks.ks_mac_plain(fwd, key_rows, ctx)  # noqa: E731
    elif name == "ks_digits_ntt_mac":
        element, slots = variant
        base, index = stacked(shape[:-2], slots, 2)
        c1 = base[..., 1, :, :]
        key_rows = residues(moduli, (shape[-2], 2), 3).int()
        kernel = lambda: kc.ks_digits_ntt_mac(c1, key_rows, moduli, ctx.ntt_tables, element, index)  # noqa: E731
        plain = lambda: ks.ks_digits_ntt_mac_plain(c1, key_rows, ctx, element, index)  # noqa: E731
    elif name == "ks_intt_finish":
        element, has_c0, has_c1, slots = variant
        products = residues(moduli, shape[:-2], 2).int()
        base, index = stacked(shape[:-3], slots, 2)
        c0 = base[..., 0, :, :] if has_c0 else None
        c1 = base[..., 1, :, :] if has_c1 else None
        kernel = lambda: kc.ks_intt_finish(products, moduli, ctx.ntt_tables, c0, c1, element, index)  # noqa: E731
        plain = lambda: ks.ks_intt_finish_plain(products, ctx, c0, c1, element, index)  # noqa: E731
    elif name == "mod_switch":
        target_count, strides = variant
        x = strided_like(residues(moduli, shape[:-2], 1), strides)
        kernel = lambda: kc.mod_switch(x, moduli, target_count)  # noqa: E731
        plain = lambda: ks.mod_switch_plain(x, ctx, target_count)  # noqa: E731
    elif name == "ks_finish":
        element, has_c0, has_c1, slots = variant
        inv = residues(moduli, shape[:-2], 2)
        base, index = stacked(shape[:-3], slots, 2)
        c0 = base[..., 0, :, :] if has_c0 else None
        c1 = base[..., 1, :, :] if has_c1 else None
        kernel = lambda: kc.ks_finish(inv, moduli, c0, c1, element, index)  # noqa: E731
        plain = lambda: ks.ks_finish_plain(inv, ctx, c0, c1, element, index)  # noqa: E731
    else:
        shift, slots = variant
        pool = residues(moduli, (slots,) + tuple(shape[1:-2]), 1)
        update = residues(moduli, shape[:-2], 2)
        slot_order = torch.randperm(slots, generator=g, device=dev)
        parents, child0, child1 = (slot_order[i * shape[0]: (i + 1) * shape[0]] for i in range(3))

        work = pool.clone()  # written in place at each call: the same values, since no child is a parent

        def kernel():
            kc.expand_combine(work, update, parents, child0, child1, shift, moduli)
            return work

        def plain():
            out = pool.clone()
            ks.expand_combine_plain(out, update, parents, child0, child1, shift, ctx)
            return out

    return dict(kernel=kernel, plain=plain, library=library)


def leaves_case(key, seed: int, device="cuda") -> dict:
    """The inputs of one expand_leaves launch shape, made from `seed`: a
    pool of `slots` inner nodes and the output of `outputs` leaves as two
    views of one buffer, the level's n parents, and 2n children of which
    min(2n, outputs) are leaves at random output positions and the rest
    new pool slots; where the launch doubled leaves, every third child is
    doubled. The kernel writes into a copy of the buffer made here and its
    plain version into one made at each call; both return the whole
    buffer. The library yardstick is the parent design's leaf pass alone:
    torch.index_select of the `outputs` leaves, in output order, from a
    pool of every node."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import key_switch as ks
    from she_tpu_torch.ops import key_switch_cuda as kc

    _, shape, moduli, (shift, slots, outputs, doubling) = key
    dev, n, nodes = torch.device(device), shape[-1], shape[0]
    ctx = get_poly_context(n, moduli, 64, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    buffer = random_residues(moduli, (slots + outputs,) + tuple(shape[1:-2]), n, seed + 1, dev)
    update = random_residues(moduli, shape[:-2], n, seed + 2, dev)
    slot_order = torch.randperm(slots, generator=g, device=dev)
    leaf_count = min(2 * nodes, outputs)
    positions = torch.randperm(outputs, generator=g, device=dev)[:leaf_count]
    children = torch.cat([-positions - 1, slot_order[nodes: nodes + 2 * nodes - leaf_count]])
    children = children[torch.randperm(2 * nodes, generator=g, device=dev)]
    parents, child0, child1 = slot_order[:nodes], children[:nodes].contiguous(), children[nodes:].contiguous()
    doubled = (torch.arange(2 * nodes, device=dev) % 3 == 0).view(2, nodes) if doubling else None
    work = buffer.clone()

    def kernel():
        kc.expand_combine(work[:slots], update, parents, child0, child1, shift, moduli, work[slots:], doubled)
        return work

    def plain():
        out = buffer.clone()
        ks.expand_combine_plain(out[:slots], update, parents, child0, child1, shift, ctx, out[slots:], doubled)
        return out

    leaf_slots = torch.randperm(slots + outputs, generator=g, device=dev)[:outputs]
    return dict(kernel=kernel, plain=plain, library=lambda: buffer.index_select(0, leaf_slots))


def ks_shape_timing(paths: dict, names=KS_KERNELS) -> list:
    """Each key-switch kernel at every launch shape of the paths' runs
    (launch_shapes of ops/key_switch_cuda.py, keyed by KsKey), in two
    passes so that every kernel is timed before any plain version runs:
    first the kernel (mean of 20 launches after a warm-up, CUDA events;
    for GRAPH_TIMED kernels 20 launches replayed from a CUDA graph, beside
    the time through the wrapper, `wrapper_ms`) and, where one PyTorch call
    computes the whole function, that call;
    then, on the same inputs made again from the same seed, the plain
    version (3 calls; 1 where a modulus takes the wide route), and the
    kernel held bit-equal to it. Rows: ms, plain_ms, library_ms, bytes,
    byte bound and its share, launches a batch by path."""
    import torch

    from she_tpu_torch.ops import modarith

    keys = {k: v for k, v in launch_keys(paths, "ks_shapes").items() if k.name in names}
    ordered = sorted(keys, key=lambda k: (KS_KERNELS.index(k.name), -ks_bytes(k), str(k)))
    case_of = {"expand_leaves": leaves_case}
    rows = []
    for i, key in enumerate(ordered):
        case = case_of.get(key.name, ks_case)(key, 100 + 7 * i)
        ms = cuda_ms(case["kernel"], 20)
        extra = {}
        if key.name in GRAPH_TIMED:
            extra["wrapper_ms"], ms = ms, graph_ms(case["kernel"])
        library_ms = None if case["library"] is None else cuda_ms(case["library"], 20)
        bound = 1e3 * ks_bytes(key) / HBM_BYTES_PER_S
        rows.append(dict(name=key.name, shape=list(key.shape), moduli=list(key.moduli), variant=list(key.variant),
                         ms=ms, library_ms=library_ms, bytes=ks_bytes(key), bound_ms=bound, share_of_bound=bound / ms,
                         launches_per_batch=keys[key], **extra))
        del case
        torch.cuda.empty_cache()
    for i, (key, row) in enumerate(zip(ordered, rows)):
        case = case_of.get(key.name, ks_case)(key, 100 + 7 * i)
        got = case["kernel"]().clone()
        want = case["plain"]()
        err = int((got - want).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"{key.name} at {key.shape}, moduli {key.moduli}, {key.variant}: max |kernel - plain| "
                                 f"= {err}")
        plain_iters = 1 if modarith.is_wide(max(key.moduli)) else 3
        row.update(max_abs_err=err, plain_ms=cuda_ms(case["plain"], plain_iters), plain_iters=plain_iters)
        log(f"{key.name} {tuple(key.shape)} moduli {key.moduli} {tuple(key.variant)} "
            f"(a batch: {row['launches_per_batch']}): bit-equal to plain; kernel {row['ms']:.4f} ms"
            + ("" if "wrapper_ms" not in row else f" (from a CUDA graph; {row['wrapper_ms']:.4f} through the wrapper)")
            + f", plain {row['plain_ms']:.4f} ms (x{plain_iters}), "
            + ("" if row["library_ms"] is None else f"library {row['library_ms']:.4f} ms, ")
            + f"byte bound {row['bound_ms']:.4f} ms ({100 * row['share_of_bound']:.1f}% of bound)")
        del case, got, want
        torch.cuda.empty_cache()
    return rows


KS_LIBRARY = {
    "ks_digits": "torch.remainder(c1.unsqueeze(-2), q) where no Galois element is given; none computes the signed "
                 "gather and the reduction in one call",
    "ks_mac": "none: no PyTorch call computes a modular sum of 128-bit products",
    "ks_finish": "none: no PyTorch call computes the divide-and-round by q_ks",
    "expand_combine": "none: no PyTorch call computes a modular add and a negacyclic shift into indexed slots",
    "expand_leaves": "torch.index_select of the same leaves, in output order, from a pool of every node: the gather "
                     "alone of the leaf pass it replaces, without the level's combine or the doubling",
    "mod_switch": "none: no PyTorch call computes a divide-and-round across RNS rows",
    "ks_digits_ntt_mac": "none: no PyTorch call computes an exact modular NTT or a modular sum of products",
    "ks_intt_finish": "none: no PyTorch call computes an exact modular NTT or the divide-and-round by q_ks",
}


def ks_kernel_entries(rows: list, paths: dict, names=KS_KERNELS) -> list:
    """The key-switch kernels' entries of the kernels line, at each
    kernel's widest shape (by bytes); library_ms where a PyTorch call
    computes the function at that shape, else the widest shape that has
    one (ks_digits of a relinearization), else null; library_shape_ms is
    the kernel's own time at the library's shape."""
    out = []
    for name in names:
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            raise AssertionError(f"no served path launched {name}")
        widest = max(mine, key=lambda r: r["bytes"])
        with_library = [r for r in mine if r["library_ms"] is not None]
        library_row = widest if widest["library_ms"] is not None else (
            max(with_library, key=lambda r: r["bytes"]) if with_library else None)
        launches_by_path = {p: v["launches"].get(name, 0) for p, v in paths.items() if "launches" in v}
        out.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCES[name], replaces=KS_REPLACES[name],
            launches=sum(launches_by_path.values()), max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=widest["ms"], wrapper_ms=widest.get("wrapper_ms"), plain_ms=widest["plain_ms"],
            bound_ms=widest["bound_ms"], bound_by="bytes",
            library_ms=None if library_row is None else library_row["library_ms"], library=KS_LIBRARY[name],
            library_shape=None if library_row is None else library_row["shape"],
            library_shape_ms=None if library_row is None else library_row["ms"], widest_shape=widest["shape"],
            widest_moduli=widest["moduli"], widest_variant=widest["variant"], launches_by_path=launches_by_path,
            shapes=mine, ptxas=[line for line in ptxas_lines("key_switch") if line.startswith(PTXAS_LABELS[name])],
        ))
    return out


def fused_against_chain(entries: list) -> dict:
    """The fused pair at ks_digits_ntt_mac's widest served shape (the
    keyword cell's widest level) against the split chain (ks_digits, the
    NTT kernels, ks_mac, ks_finish) on the same inputs, in turns (chain,
    fused, fused, chain; 5 calls each after a warm-up), both held
    bit-equal; with the byte bound of each (14 U and 56 U at that level)."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import key_switch_cuda as kc
    from she_tpu_torch.ops import ntt_cuda

    row = max(next(e for e in entries if e["name"] == "ks_digits_ntt_mac")["shapes"], key=lambda r: r["bytes"])
    key = kc.KsKey("ks_digits_ntt_mac", tuple(row["shape"]), tuple(row["moduli"]), tuple(row["variant"]))
    element, slots = key.variant  # an expansion level: a Galois element, parents read from a slot pool
    moduli, n, l_t = key.moduli, key.shape[-1], key.shape[-2]
    tables = get_poly_context(n, moduli, 64, torch.device("cuda")).ntt_tables
    base = random_residues(moduli[:-1], (slots or key.shape[0],) + tuple(key.shape[1:-2]) + (2,), n, 8, "cuda")
    index = None if slots is None else torch.randperm(slots, device="cuda")[: key.shape[0]]
    c0, c1 = base[..., 0, :, :], base[..., 1, :, :]
    key_rows = random_residues(moduli, (l_t, 2), n, 9, "cuda")
    key32 = key_rows.int()
    c0_arg = c0 if element is not None else None

    def fused():
        products = kc.ks_digits_ntt_mac(c1, key32, moduli, tables, element, index)
        return kc.ks_intt_finish(products, moduli, tables, c0_arg, None, element, index)

    def chain():
        fwd = ntt_cuda.forward(kc.ks_digits(c1, moduli, element, index), tables)
        inv = ntt_cuda.inverse(kc.ks_mac(fwd, key_rows, moduli), tables)
        del fwd
        return kc.ks_finish(inv, moduli, c0_arg, None, element, index)

    if not torch.equal(fused(), chain()):
        raise AssertionError(f"the fused pair and the split chain differ at {key.shape}")
    times = {"chain": [], "fused": []}
    for name in ("chain", "fused", "fused", "chain"):
        times[name].append(cuda_ms(fused if name == "fused" else chain, 5))
    del base, c0, c1
    torch.cuda.empty_cache()
    unit = prod(key.shape) * 8 // l_t  # U: the target polynomials' 64-bit words
    return dict(shape=list(key.shape), moduli=list(moduli), fused_ms=min(times["fused"]), chain_ms=min(times["chain"]),
                turns=times, fused_bound_ms=1e3 * 14 * unit / HBM_BYTES_PER_S,
                chain_bound_ms=1e3 * 56 * unit / HBM_BYTES_PER_S)


def ks_summary(entries: list, paths: dict, card: str) -> str:
    stage = {p: {k: round(v["stages_ms"][k], 3) for k in ("expansion", "behz_relinearize", "mod_switch")
                 if k in v["stages_ms"]}
             for p, v in paths.items() if "stages_ms" in v}
    pair = fused_against_chain(entries)
    return (f"fused key switch at {tuple(pair['shape'])}: {pair['fused_ms']:.4f} ms (bound {pair['fused_bound_ms']:.4f}) "
            f"against the split chain's {pair['chain_ms']:.4f} ms (bound {pair['chain_bound_ms']:.4f}), bit-equal; "
            + "key switch and mod switch: " + "; ".join(
        f"{e['name']} {e['ms']:.4f} ms at {tuple(e['widest_shape'])} against a byte bound of {e['bound_ms']:.4f} ms "
        f"({100 * e['bound_ms'] / e['ms']:.1f}%), plain {e['plain_ms']:.4f} ms, "
        + ("" if e["library_ms"] is None else f"library {e['library_ms']:.4f} ms at {tuple(e['library_shape'])}, "
           f"where the kernel takes {e['library_shape_ms']:.4f} ms, ")
        + f"{e['launches']} launches" for e in entries) + f"; expansion, BEHZ and mod switch device ms by path {stage}; "
        f"on {card}")


def mod_switch_summary(entry: dict, paths: dict, card: str) -> str:
    """The mod switch at every shape it was timed at, and each path's
    mod_switch stage."""
    stage = {p: round(v["stages_ms"]["mod_switch"], 4) for p, v in paths.items() if "mod_switch" in v.get("stages_ms", {})}
    return ("mod_switch: " + "; ".join(
        f"{tuple(r['shape'])} -> {r['variant'][0]} moduli {r['ms']:.4f} ms from a CUDA graph ({r['wrapper_ms']:.4f} "
        f"through the wrapper) against a byte bound of {r['bound_ms']:.4f} ms ({100 * r['share_of_bound']:.1f}%), "
        f"plain {r['plain_ms']:.4f} ms, {r['launches_per_batch']} a batch"
        for r in sorted(entry["shapes"], key=lambda r: -r["bytes"]))
        + f"; {entry['launches']} launches by path {entry['launches_by_path']}; mod_switch stage device ms by path "
        f"{stage}; on {card}")


def behz_bytes(key) -> int:
    """The bytes one BEHZ launch must move (`key` a behz_cuda.BehzKey):
    each int64 input read once, each output written once; the constants
    travel with the launch."""
    name, shape, moduli, _ = key
    if name == "behz_lift":  # x [..., L, n] in, [..., 2L + 1, n] out
        return 8 * prod(shape[:-2]) * shape[-1] * (3 * shape[-2] + 1)
    if name == "behz_tensor_mac":  # la and lb [..., K, 2, M, n] in, [..., 3, M, n] out
        return 8 * (2 * prod(shape) + prod(shape[:-4]) * 3 * prod(shape[-2:]))
    return 8 * prod(shape[:-2]) * shape[-1] * (3 * len(moduli[0]) + 1)  # behz_floor: [..., 2L + 1, n] in, [..., L, n] out


def strided_like(values, strides):
    """`values` laid out with `strides`, as a launch read its input: a view
    of a fresh buffer."""
    import torch

    size = 1 + sum((d - 1) * st for d, st in zip(values.shape, strides))
    out = torch.zeros(size, dtype=values.dtype, device=values.device).as_strided(values.shape, strides)
    out.copy_(values)
    return out


def behz_case(key, seed: int, device="cuda") -> dict:
    """The inputs of one BEHZ launch shape on the card, made from `seed`,
    the lift's and the floor's input laid out with the strides the launch
    read it through: the kernel and its plain version, each a function of
    no arguments returning what the kernel writes."""
    import torch

    from she_tpu_torch.core import rns
    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import behz
    from she_tpu_torch.ops import behz_cuda as bc

    name, shape, moduli, variant = key
    dev, n = torch.device(device), shape[-1]
    if name == "behz_tensor_mac":
        (scale,) = variant
        ctx = get_poly_context(n, moduli, 64, dev)
        la, lb = (random_residues(moduli, shape[:-2], n, seed + i, dev) for i in range(2))
        return dict(kernel=lambda: bc.behz_tensor_mac(la, lb, moduli, scale),
                    plain=lambda: behz.behz_tensor_mac_plain(la, lb, ctx, scale, -4))
    q_moduli, bsk_moduli = moduli
    if name == "behz_lift":
        m_tilde, strides = variant
        # the tool's m~ is the launch's: 2^16 at 32-bit scalars, 2^32 at 64
        tool = rns.RnsTool(get_poly_context(n, q_moduli, 32 if m_tilde == 1 << 16 else 64, dev), 2, bsk_moduli)
        x = strided_like(random_residues(q_moduli, shape[:-2], n, seed, dev), strides)
        return dict(kernel=lambda: bc.behz_lift(x, q_moduli, bsk_moduli, m_tilde),
                    plain=lambda: behz.behz_lift_plain(x, tool))
    scale, strides = variant
    tool = rns.RnsTool(get_poly_context(n, q_moduli, 64, dev), 2, bsk_moduli)
    y = strided_like(random_residues(q_moduli + bsk_moduli, shape[:-2], n, seed, dev), strides)
    return dict(kernel=lambda: bc.behz_floor(y, q_moduli, bsk_moduli, scale),
                plain=lambda: behz.behz_floor_plain(y, tool, scale))


def behz_kernel_timing(paths: dict) -> list:
    """Each BEHZ kernel at the widest shape (by bytes) each path launched
    it with, timed before any plain BEHZ version runs in the process: the
    mean of 20 launches after a warm-up (CUDA events), beside its byte
    bound. One row a kernel and path."""
    import torch

    keys = launch_keys(paths, "behz_shapes")
    widest = {}
    for key, by_path in keys.items():
        for path in by_path:
            if (key.name, path) not in widest or behz_bytes(key) > behz_bytes(widest[key.name, path]):
                widest[key.name, path] = key
    rows = []
    for i, ((name, path), key) in enumerate(sorted(widest.items(), key=lambda kv: (BEHZ_KERNELS.index(kv[0][0]),
                                                                                   kv[0][1]))):
        case = behz_case(key, 200 + 7 * i)
        ms = cuda_ms(case["kernel"], 20)
        bound = 1e3 * behz_bytes(key) / HBM_BYTES_PER_S
        sass = floor_sass(key) if name == "behz_floor" else None
        rows.append(dict(name=name, path=path, key=key, shape=list(key.shape), moduli=key.moduli,
                         variant=key.variant, ms=ms, bytes=behz_bytes(key), bound_ms=bound, share_of_bound=bound / ms,
                         launches_per_batch=keys[key], sass=sass))
        log(f"{name} at {path}'s widest {tuple(key.shape)}: {ms:.4f} ms against a byte bound of {bound:.4f} ms "
            f"({100 * bound / ms:.1f}%)" + (f"; {sass['word_bits']}-bit instance, integer SASS {sass['counts']} a "
                                             f"thread, issued in {sass['issue_ms']:.4f} ms (diagnostic)" if sass else ""))
        del case
        torch.cuda.empty_cache()
    return rows


def floor_sass(key) -> dict | None:
    """behz_floor's build at launch `key`, as a diagnostic: the integer
    SASS instructions of the instance the launch takes (its word,
    behz_cuda.floor_word_bits, and L) by pipe (sass_count; the kernel has
    no loop, so this is what a thread runs for its two columns, both sides
    of every branch counted), and the time the CUDA cores take to issue
    them for the launch's threads (sass_issue_ms). None where cuobjdump is
    missing."""
    from she_tpu_torch.ops import behz_cuda

    q_moduli, bsk_moduli = key.moduli
    bits = behz_cuda.floor_word_bits(q_moduli, bsk_moduli)
    count = sass_count("behz", rf"behz_floor_kernelI{'j' if bits == 32 else 'y'}Li{len(q_moduli)}E")
    if count is None:
        return None
    threads = prod(key.shape[:-2]) * key.shape[-1] // 2
    return dict(word_bits=bits, counts=count, issue_ms=sass_issue_ms(count, threads))


def behz_plain_checks(paths: dict, rows: list) -> list:
    """Every BEHZ launch shape of the paths' runs held bit-equal to its
    plain version, on inputs made from a seed; the timed rows (`rows`,
    behz_kernel_timing's) get their shape's plain time (3 calls after a
    warm-up; 1 where a modulus takes the wide route) and its largest
    difference. Returns one row a launched shape."""
    import torch

    from she_tpu_torch.ops import modarith

    keys = launch_keys(paths, "behz_shapes")
    checked = []
    for i, key in enumerate(sorted(keys, key=lambda k: (BEHZ_KERNELS.index(k.name), -behz_bytes(k), str(k)))):
        case = behz_case(key, 300 + 7 * i)
        got = case["kernel"]().clone()
        want = case["plain"]()
        err = int((got - want).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"{key.name} at {key.shape}, moduli {key.moduli}, {key.variant}: max |kernel - plain| "
                                 f"= {err}")
        timed = [r for r in rows if r["key"] == key]
        if timed:
            wide = modarith.is_wide(max(key.moduli if key.name == "behz_tensor_mac" else key.moduli[0] + key.moduli[1]))
            plain_iters = 1 if wide else 3
            plain_ms = cuda_ms(case["plain"], plain_iters)
            for r in timed:
                r.update(max_abs_err=err, plain_ms=plain_ms, plain_iters=plain_iters)
        checked.append(dict(name=key.name, shape=list(key.shape), moduli=key.moduli, variant=key.variant,
                            bytes=behz_bytes(key), launches_per_batch=keys[key], max_abs_err=err))
        log(f"{key.name} {tuple(key.shape)} moduli {key.moduli} {key.variant} (a batch: {keys[key]}): bit-equal to "
            f"plain" + (f"; plain {timed[0]['plain_ms']:.4f} ms (x{timed[0]['plain_iters']})" if timed else ""))
        del case, got, want
        torch.cuda.empty_cache()
    for r in rows:
        r.pop("key")
    return checked


def behz_kernel_entries(rows: list, checked: list, paths: dict) -> list:
    """The BEHZ kernels' entries of the kernels line, at each kernel's
    widest timed shape (by bytes), with the timed row of every path;
    library_ms is null: no PyTorch call computes the function."""
    out = []
    for name in BEHZ_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            raise AssertionError(f"no served path launched {name}")
        widest = max(mine, key=lambda r: r["bytes"])
        launches_by_path = {p: v["launches"].get(name, 0) for p, v in paths.items() if "launches" in v}
        out.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCES[name], replaces=BEHZ_REPLACES[name],
            launches=sum(launches_by_path.values()),
            max_abs_err=max(r["max_abs_err"] for r in checked if r["name"] == name),
            ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"], bound_by="bytes",
            library_ms=None, library=BEHZ_LIBRARY, widest_shape=widest["shape"], widest_path=widest["path"],
            launches_by_path=launches_by_path, shapes=mine,
            checked_shapes=sum(r["name"] == name for r in checked),
        ))
    return out


def behz_summary(entries: list, paths: dict, card: str) -> str:
    stage = {p: round(v["stages_ms"]["behz_relinearize"], 3) for p, v in paths.items()
             if "behz_relinearize" in v.get("stages_ms", {})}
    return ("BEHZ: " + "; ".join(
        f"{e['name']} {e['ms']:.4f} ms at {e['widest_path']}'s {tuple(e['widest_shape'])} against a byte bound of "
        f"{e['bound_ms']:.4f} ms ({100 * e['bound_ms'] / e['ms']:.1f}%), plain {e['plain_ms']:.4f} ms, "
        f"{e['launches']} launches, {e['checked_shapes']} shapes bit-equal" for e in entries)
        + f"; behz_relinearize device ms by path {stage}; on {card}")


def _distinct_words(shape, strides) -> int:
    """Words an operand holds: a broadcast (stride 0) axis counted once."""
    return prod(d for d, st in zip(shape, strides) if st != 0)


def mac_bytes(key) -> int:
    """The bytes one dim0_mac launch must move (`key` a
    dim0_mac_cuda.MacKey): each word of both operands read once, each
    output word written once."""
    m1, m2 = prod(key.a_shape[:-3]), prod(key.b_shape[1:-2])
    return 8 * (_distinct_words(key.a_shape, key.a_strides) + _distinct_words(key.b_shape, key.b_strides)
                + m1 * m2 * prod(key.a_shape[-2:]))


def mac_case(key, seed: int, device="cuda") -> dict:
    """The inputs of one dim0_mac launch shape, made from `seed` and laid
    out with the strides the launch read them through (a strided d0 slice,
    PNNS's permuted diagonals): the kernel and its plain version, each a
    function of no arguments."""
    import torch

    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import dim0_mac
    from she_tpu_torch.ops import dim0_mac_cuda as dc

    moduli, n = key.moduli, key.a_shape[-1]
    dev = torch.device(device)
    ctx = get_poly_context(n, moduli, 64, dev)
    operands = []
    for i, (shape, strides) in enumerate(((key.a_shape, key.a_strides), (key.b_shape, key.b_strides))):
        full = tuple(d if st else 1 for d, st in zip(shape, strides))  # a broadcast axis made once, then expanded
        laid = strided_like(random_residues(moduli, full[:-2], n, seed + i, dev), strides)
        operands.append(laid.expand(shape))
    a, b = operands
    return dict(kernel=lambda: dc.dim0_mac(a, b, moduli), plain=lambda: dim0_mac.dim0_mac_plain(a, b, ctx))


def mac_plan(key):
    """The launch plan dim0_mac_cuda.plan gives launch `key`."""
    from she_tpu_torch.ops import dim0_mac_cuda

    m1, m2 = prod(key.a_shape[:-3]), prod(key.b_shape[1:-2])
    return dim0_mac_cuda.plan(m1, m2, key.a_shape[-3], key.moduli)


def mac_sass(key) -> dict | None:
    """dim0_mac's build at launch `key`, as a diagnostic: the integer SASS
    instructions of the instance its plan takes (word, accumulators, ring
    depth) by pipe (sass_count), and the time the CUDA cores take to issue
    that listing once for each of the launch's threads (sass_issue_ms): the
    listing holds the copies, the offsets and the epilogue, and its j loop's
    body once where a thread runs it for every j of each of its m2. None
    where cuobjdump is missing."""
    from she_tpu_torch.ops import dim0_mac_cuda

    p = mac_plan(key)
    instance = next(g for g in dim0_mac_cuda.GROUPS if g >= p.group)
    count = sass_count("dim0_mac", rf"dim0_mac_kernelILi{p.word_bits}ELi{instance}ELi{p.depth}E")
    if count is None:
        return None
    m1, m2, n = prod(key.a_shape[:-3]), prod(key.b_shape[1:-2]), key.a_shape[-1]
    columns = dim0_mac_cuda.COLUMNS
    threads = len(key.moduli) * -(-n // columns) * columns * p.lanes * -(-m1 // p.group) * -(-m2 // p.run)
    return dict(counts=count, issue_ms=sass_issue_ms(count, threads))


def mac_kernel_timing(paths: dict) -> list:
    """dim0_mac at the widest shape (by bytes) each path launched it with,
    timed before any plain dim-0 MAC runs in the process: the mean of 20
    launches after a warm-up (CUDA events), beside its byte bound. One row
    a path."""
    import torch

    keys = launch_keys(paths, "mac_shapes")
    widest = {}
    for key, by_path in keys.items():
        for path in by_path:
            if path not in widest or mac_bytes(key) > mac_bytes(widest[path]):
                widest[path] = key
    rows = []
    for i, (path, key) in enumerate(sorted(widest.items())):
        case = mac_case(key, 400 + 7 * i)
        ms = cuda_ms(case["kernel"], 20)
        bound = 1e3 * mac_bytes(key) / HBM_BYTES_PER_S
        sass = mac_sass(key)
        rows.append(dict(name="dim0_mac", path=path, key=key, a_shape=list(key.a_shape), b_shape=list(key.b_shape),
                         moduli=list(key.moduli), ms=ms, bytes=mac_bytes(key), bound_ms=bound,
                         share_of_bound=bound / ms, launches_per_batch=keys[key][path], plan=mac_plan(key)._asdict(),
                         sass=sass))
        log(f"dim0_mac at {path}'s widest a {key.a_shape} x b {key.b_shape}: {ms:.4f} ms against a byte bound of "
            f"{bound:.4f} ms ({100 * bound / ms:.1f}%), plan {tuple(mac_plan(key))}"
            + (f", integer SASS {sass['counts']}, issued in {sass['issue_ms']:.4f} ms (diagnostic)" if sass else ""))
        del case
        torch.cuda.empty_cache()
    return rows


def mac_plain_checks(paths: dict, rows: list) -> list:
    """Every dim0_mac launch shape of the paths' runs held bit-equal to
    its plain version, on inputs made from a seed; the timed rows get
    their shape's plain time (3 calls after a warm-up; 1 where a modulus
    takes the wide route) and its largest difference. Returns one row a
    launched shape."""
    import torch

    from she_tpu_torch.ops import modarith

    keys = launch_keys(paths, "mac_shapes")
    checked = []
    for i, key in enumerate(sorted(keys, key=lambda k: (-mac_bytes(k), str(k)))):
        case = mac_case(key, 500 + 7 * i)
        got = case["kernel"]()
        want = case["plain"]()
        err = int((got - want).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"dim0_mac at a {key.a_shape} {key.a_strides} x b {key.b_shape} {key.b_strides}, "
                                 f"moduli {key.moduli}: max |kernel - plain| = {err}")
        timed = [r for r in rows if r["key"] == key]
        if timed:
            plain_iters = 1 if modarith.is_wide(max(key.moduli)) else 3
            plain_ms = cuda_ms(case["plain"], plain_iters)
            for r in timed:
                r.update(max_abs_err=err, plain_ms=plain_ms, plain_iters=plain_iters)
        checked.append(dict(a_shape=list(key.a_shape), a_strides=list(key.a_strides), b_shape=list(key.b_shape),
                            b_strides=list(key.b_strides), moduli=list(key.moduli), bytes=mac_bytes(key),
                            launches_per_batch=keys[key], max_abs_err=err))
        log(f"dim0_mac a {key.a_shape} x b {key.b_shape} moduli {key.moduli} (a batch: {keys[key]}): bit-equal to "
            f"plain" + (f"; plain {timed[0]['plain_ms']:.4f} ms (x{timed[0]['plain_iters']})" if timed else ""))
        del case, got, want
        torch.cuda.empty_cache()
    for r in rows:
        r.pop("key")
    return checked


def mac_kernel_entry(rows: list, checked: list, paths: dict) -> dict:
    """dim0_mac's entry of the kernels line, at its widest timed shape (by
    bytes), with the timed row of every path; library_ms is null: no
    PyTorch call computes a modular sum of 128-bit products."""
    if not rows:
        raise AssertionError("no served path launched dim0_mac")
    widest = max(rows, key=lambda r: r["bytes"])
    launches_by_path = {p: v["launches"].get("dim0_mac", 0) for p, v in paths.items() if "launches" in v}
    return dict(
        name="dim0_mac", route="cuda", source=KERNEL_SOURCES["dim0_mac"], replaces=MAC_REPLACES,
        launches=sum(launches_by_path.values()), max_abs_err=max(r["max_abs_err"] for r in checked),
        ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"], bound_by="bytes",
        library_ms=None, library=MAC_LIBRARY, widest_path=widest["path"], widest_a_shape=widest["a_shape"],
        widest_b_shape=widest["b_shape"], launches_by_path=launches_by_path, shapes=rows,
        checked_shapes=len(checked), ptxas=[line for line in ptxas_lines("dim0_mac")],
    )


def mac_summary(entry: dict, leaves: dict, paths: dict, card: str) -> str:
    """dim0_mac's and expand_leaves' numbers, the dim-0 (and BSGS) stage
    and the expansion by path, and each path's peak device memory."""
    stage = {p: {k: round(v["stages_ms"][k], 3) for k in ("expansion", "dim0", "bsgs_mac") if k in v["stages_ms"]}
             for p, v in paths.items() if "stages_ms" in v}
    peaks = {p: v["peak_bytes"] for p, v in paths.items() if "peak_bytes" in v}
    return (f"dim0_mac: {entry['ms']:.4f} ms at {entry['widest_path']}'s a {tuple(entry['widest_a_shape'])} x b "
            f"{tuple(entry['widest_b_shape'])} against a byte bound of {entry['bound_ms']:.4f} ms "
            f"({100 * entry['bound_ms'] / entry['ms']:.1f}%), plain {entry['plain_ms']:.4f} ms, "
            f"{entry['launches']} launches by path {entry['launches_by_path']}, {entry['checked_shapes']} shapes "
            f"bit-equal; by path " + "; ".join(f"{r['path']} {r['ms']:.4f} ms ({100 * r['share_of_bound']:.1f}%)"
                                               for r in entry["shapes"])
            + f"; expand_leaves {leaves['ms']:.4f} ms at {tuple(leaves['widest_shape'])} against a byte bound of "
            f"{leaves['bound_ms']:.4f} ms ({100 * leaves['bound_ms'] / leaves['ms']:.1f}%), plain "
            f"{leaves['plain_ms']:.4f} ms, index_select of the leaves {leaves['library_ms']:.4f} ms, "
            f"{leaves['launches']} launches; stages ms by path {stage}; peak bytes by path {peaks}; on {card}")


def serve_both_routes(label: str, path: str, seed: int, batches: int) -> dict:
    """One MulPIR cell served on both NTT routes, the butterfly kernels
    (SHE_TPU_NTT_MXU=0) and then the matrix NTT (=1), the same batches of
    the same queries, with the counts read around each route's batches.
    Every answer of the matrix route must equal the butterfly route's bit
    for bit and decrypt to its entry. The matrix tables of every (moduli,
    degree) the butterfly route transformed are made before the timed
    batches."""
    import os

    import torch

    from she_tpu_torch.ops import ntt_mxu

    setup = serving_setup(path, seed, batches, label)
    server, ek = setup["server"], setup["ek"]
    routes = {}
    previous = os.environ.get(ntt_mxu.ENV)
    try:
        for route, flag in (("butterfly", "0"), ("mxu", "1")):
            os.environ[ntt_mxu.ENV] = flag
            if route == "mxu":
                t0 = time.perf_counter()
                for key in routes["butterfly"]["counts"]["launch_shapes"]:
                    ntt_mxu.tables_for(key.moduli, key.shape[-1], torch.device("cuda"))
                log(f"[{label}] matrix tables made in {time.perf_counter() - t0:.3f} s")
            reset_counts()
            torch.cuda.synchronize()
            batch_s, responses = [], []
            for queries in setup["all_queries"]:
                t0 = time.perf_counter()
                responses.append(server.compute_response_batch(queries, ek))
                torch.cuda.synchronize()
                batch_s.append(time.perf_counter() - t0)
            counts = read_counts(f"{label} {route}", server.use_dim0_int8, mxu=route == "mxu",
                                 mac=not server.use_dim0_int8)
            steady = batch_s[1:] or batch_s
            routes[route] = dict(batch_s=batch_s, median_s_per_batch=statistics.median(steady),
                                 steady_batches=len(steady), responses=responses, counts=counts)
            log(f"[{label}] {route} route: batches {[round(v, 4) for v in batch_s]} s, launches {counts['launches']}")
    finally:
        if previous is None:
            os.environ.pop(ntt_mxu.ENV, None)
        else:
            os.environ[ntt_mxu.ENV] = previous
    for b, (got, want) in enumerate(zip(routes["mxu"]["responses"], routes["butterfly"]["responses"], strict=True)):
        assert_same_responses(f"[{label}] batch {b}, matrix route against the butterfly route", got, want)
    client, sk, database = setup["client"], setup["sk"], setup["database"]
    for indices, responses in zip(setup["all_indices"], routes["mxu"]["responses"]):
        for index, response in zip(indices, responses):
            if client.decrypt(response, [index], sk) != [database[index].tobytes()]:
                raise AssertionError(f"[{label}] the matrix route's answer for entry {index} does not decrypt")
    log(f"[{label}] all {batches * BATCH} answers of the matrix route are bit-identical to the butterfly "
        f"route's and decrypt to their entries")
    mxu = routes["mxu"]["counts"]
    return dict(path=path, params=setup["params"], batches=batches, launches=mxu["launches"],
                launch_shapes={}, dim0_shapes={}, mxu_shapes=mxu["mxu_shapes"],
                routes={r: {k: v[k] for k in ("batch_s", "median_s_per_batch", "steady_batches")}
                        for r, v in routes.items()})


def sass_integer_counts(name: str) -> dict:
    """Integer instructions on the CUDA cores' 32-bit lanes of every
    function in the built library `name`, by mangled name, split by pipe:
    {"fma": IMAD and the other multiplies, "alu": IADD3, LOP3, SHF, PRMT,
    LEA, SEL, ISETP, MOV and the like}; not the uniform datapath, memory,
    control or tensor instructions. Read from the SASS that cuobjdump
    prints; empty where the toolkit has no cuobjdump. Each instruction of
    the listing counts once: the prologue and branches a launch never takes
    count, loop bodies count once. So it describes the build, not the
    instructions a launch executes, and not what the function needs."""
    import os
    import re

    from she_tpu_torch.ops import kernel_build

    tool = os.path.join(os.path.dirname(kernel_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(kernel_build.library_path(name))], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts, function = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            function = m.group(1)
            counts[function] = {"alu": 0, "fma": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P[T0-9]\s+)?([A-Z][A-Z0-9]*)", line)
        if function and m:
            pipe = "fma" if m.group(1) in FMA_INT_OPCODES else "alu" if m.group(1) in ALU_INT_OPCODES else None
            if pipe:
                counts[function][pipe] += 1
    return counts


def sass_count(name: str, pattern: str) -> dict | None:
    """The integer instructions by pipe of the one function of library
    `name` whose mangled name matches `pattern`, or None."""
    import re

    if name not in _SASS:
        _SASS[name] = sass_integer_counts(name)
    found = [v for k, v in _SASS[name].items() if re.search(pattern, k)]
    return found[0] if len(found) == 1 else None


def sass_issue_ms(counts: dict, threads: float) -> float:
    """The time the CUDA cores take to issue `counts` (sass_count: one
    thread's integer SASS by pipe) for each of `threads` threads: the
    larger of each pipe's instructions over its 64 lanes an SM a clock and
    of all of them over the 128 lanes an SM issues a clock. A diagnostic of
    the build, not a bound on the function: the count is the listing's,
    and a build with more instructions reads a larger time."""
    alu, fma = counts["alu"], counts["fma"]
    clocks = max(alu / INT_PIPE_LANES, fma / INT_PIPE_LANES, (alu + fma) / ISSUE_LANES)
    return 1e3 * clocks * threads / SM_CLOCKS_PER_S


def mxu_bound(shape, moduli, digits: int) -> dict:
    """The least time of one direction of the fused matrix NTT: x read
    once and written once as int64, the row matrix's and the block
    matrix's digit planes and the twist table read once,
    over the memory rate; 2 D^2 (A + 64) int8 operations an output (the row
    product, K = A, and the block product, K = 64) over the int8
    tensor-core rate; the larger bounds it."""
    numel, L, A = prod(shape), len(moduli), shape[-1] // 64
    twist_bytes = 8 if digits <= 4 else 16  # ntt_mxu_cuda.twist_table
    nbytes = 2 * numel * 8 + L * digits * (A * A + 64 * 64) + L * A * 64 * twist_bytes
    ops = 2 * digits * digits * (A + 64) * numel
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
    return dict(bytes=nbytes, operations=ops, bytes_ms=bytes_ms, operations_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def int_mm_ms(x, t) -> float:
    """The yardstick: torch._int_mm (int8 x int8 -> int32) of a forward
    direction's digit-pair products at x's shape, per modulus l one product
    of the stacked digit planes of Lf [D A, A] by the stacked digits of x
    [A, D cols] (cols = batch x 64) and one of R_f [D 64, 64] by the same
    digits read as [64, D rows] (rows = batch x A). The digit split of x
    (made before), the twist and the recombination mod q are left out.
    Held equal to a float64 product on a slice before it is timed."""
    import torch

    from she_tpu_torch.ops import digits as dg

    L, A, D = len(t.moduli), t.A, t.D
    xv = x.reshape(-1, L, A, 64)
    xd = torch.stack(dg.value_digits(xv, D))  # [D, B, L, A, 64]
    ops = []
    for l in range(L):
        ops.append((t.Lf[l].reshape(D * A, A).contiguous(), xd[:, :, l].permute(2, 0, 1, 3).reshape(A, -1).contiguous()))
        ops.append((t.R_f[l].reshape(D * 64, 64).contiguous(), xd[:, :, l].permute(3, 0, 1, 2).reshape(64, -1).contiguous()))
    del xd

    def layout(b, column_major: bool):
        return b.t().contiguous().t() if column_major else b.contiguous()

    for column_major in (False, True):  # cuBLASLt's int8 product may want the operand column-major
        try:
            probe = torch._int_mm(ops[0][0], layout(ops[0][1][:, :64], column_major))
            break
        except RuntimeError:
            if column_major:
                raise
    ops = [(a, layout(b, column_major)) for a, b in ops]
    if not torch.equal(probe.double(), ops[0][0].double() @ ops[0][1][:, :64].double()):
        raise AssertionError("torch._int_mm's digit products are not exact")

    def products():
        for a, b in ops:
            torch._int_mm(a, b)

    return cuda_ms(products, 5)


def mxu_launch_rows(paths: dict, seed: int) -> list:
    """The fused kernel at every shape the matrix route launched it with
    (and, as path "d9_check", both directions at NTT_MXU_D9's 60-bit
    moduli, 9 digits). First every launch timed beside the butterfly
    kernel of the same direction, in turns (kernel, butterfly, butterfly,
    kernel; CUDA events, 20 launches each after a warm-up), with its three
    bounds, and torch._int_mm's digit products at the widest launch of
    each path; then each held bit-equal to the plain version
    (ntt_mxu.forward_factored_plain / inverse_factored_plain) and to the
    butterfly kernel; the plain version timed last, once, at the widest
    forward launch of each path. No plain version runs before a timed
    launch."""
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.ops import ntt, ntt_cuda, ntt_mxu, ntt_mxu_cuda
    from she_tpu_torch.ops.ntt_mxu_cuda import DirectionKey

    cuda = torch.device("cuda")
    name, batch, degree = NTT_MXU_D9
    d9_moduli = tuple(paramsmod.from_predefined(name, scalar_bits=64).coefficient_moduli)
    d9_shape = batch + (len(d9_moduli), degree)
    shapes = [(label, key, count / paths[label]["batches"]) for label in NTT_MXU_PATHS
              for key, count in sorted(paths[label]["mxu_shapes"].items(), key=lambda kv: -prod(kv[0].shape))]
    shapes += [("d9_check", DirectionKey(d, d9_shape, d9_moduli), 0) for d in ntt_mxu_cuda.DIRECTIONS]
    kernels = {"forward": (ntt_mxu_cuda.ntt_mxu_forward, ntt_cuda.forward, ntt_mxu.forward_factored_plain),
               "inverse": (ntt_mxu_cuda.ntt_mxu_inverse, ntt_cuda.inverse, ntt_mxu.inverse_factored_plain)}

    def operands(i, key):
        t = ntt_mxu.tables_for(key.moduli, key.shape[-1], cuda)
        return t, random_residues(key.moduli, key.shape[:-2], key.shape[-1], seed + 100 + i)

    rows = []
    for i, (label, key, per_batch) in enumerate(shapes):  # kernels first
        t, x = operands(i, key)
        bt = ntt.build_ntt_tables(key.moduli, key.shape[-1], cuda)
        kern, butterfly, _ = kernels[key.direction]
        readings = {"kernel": [], "butterfly": []}
        for turn in ("kernel", "butterfly", "butterfly", "kernel"):
            fn = (lambda: kern(x, t)) if turn == "kernel" else (lambda: butterfly(x, bt))
            readings[turn].append(cuda_ms(fn, 20))
        ms, butterfly_ms = (statistics.mean(readings[k]) for k in ("kernel", "butterfly"))
        count = sass_count("ntt_mxu", rf"ntt_mxu_kernelILi{t.D}ELb{int(key.direction == 'forward')}E")
        bound = mxu_bound(key.shape, key.moduli, t.D)
        per = ntt_mxu_cuda.OUTPUTS_PER_THREAD
        rows.append(dict(path=label, direction=key.direction, shape=list(key.shape), moduli=list(key.moduli),
                         digits=t.D, A=t.A, launches_per_batch=per_batch, ms=ms, ms_readings=readings["kernel"],
                         butterfly_ms=butterfly_ms, butterfly_readings=readings["butterfly"], **bound,
                         share_of_bound=bound["bound_ms"] / ms,
                         sass_int_per_output=count and {k: v / per for k, v in count.items()},
                         sass_issue_ms=count and sass_issue_ms(count, prod(key.shape) / per),
                         library_ms=None, plain_ms=None))
        del x
    widest = {}  # the widest forward launch of each path
    for i, row in enumerate(rows):
        if (row["path"] in NTT_MXU_PATHS and row["direction"] == "forward"
                and prod(row["shape"]) > widest.get(row["path"], (-1,))[0]):
            widest[row["path"]] = (prod(row["shape"]), i)
    for _, i in widest.values():
        t, x = operands(i, shapes[i][1])
        rows[i]["library_ms"] = int_mm_ms(x, t)
        del x
    torch.cuda.empty_cache()
    for i, (label, key, _) in enumerate(shapes):  # then the plain versions
        t, x = operands(i, key)
        kern, butterfly, plain = kernels[key.direction]
        got = kern(x, t)
        err = int((got - plain(x, t)).abs().max())
        rows[i]["max_abs_err"] = err
        if err:
            raise AssertionError(f"{label} ntt_mxu {key.direction} at {key.shape}, moduli {key.moduli}: "
                                 f"max |kernel - plain| = {err}")
        if not torch.equal(got, butterfly(x, ntt.build_ntt_tables(key.moduli, key.shape[-1], cuda))):
            raise AssertionError(f"{label}: the matrix NTT ({key.direction}) differs from the butterfly kernel at "
                                 f"{key.shape}, moduli {key.moduli}")
        if i in [j for _, j in widest.values()]:
            rows[i]["plain_ms"] = cuda_ms(lambda: plain(x, t), 1)
        del x, got
        torch.cuda.empty_cache()
    for row in rows:
        sass = row["sass_int_per_output"]
        sass = ("not counted" if sass is None else f"{sass['alu']:.1f} ALU + {sass['fma']:.1f} FMA an output, issued "
                f"in {row['sass_issue_ms']:.4f} ms")
        log(f"{row['path']} ntt_mxu {row['direction']} {tuple(row['shape'])} (A = {row['A']}, {row['digits']} digits, "
            f"{row['launches_per_batch']:g} a batch): bit-equal to plain and to the butterfly kernel; kernel "
            f"{row['ms']:.4f} ms {[round(v, 4) for v in row['ms_readings']]}, butterfly {row['butterfly_ms']:.4f} ms; "
            f"bounds: bytes {row['bytes_ms']:.4f} ms ({row['bytes']} bytes), int8 {row['operations_ms']:.4f} ms "
            f"({row['operations']} operations); {100 * row['share_of_bound']:.1f}% of the bound by {row['bound_by']}; "
            f"the build's integer SASS (a diagnostic) {sass}"
            + (f"; torch._int_mm digit products {row['library_ms']:.4f} ms" if row["library_ms"] else "")
            + (f"; plain {row['plain_ms']:.4f} ms" if row["plain_ms"] else ""))
    return rows


def matrix_ntt_phase(seed: int, batches: int) -> dict:
    """The matrix NTT on the MulPIR cells (serve_both_routes for each of
    NTT_MXU_PATHS), then the fused kernel at every launched shape and the
    60-bit check (mxu_launch_rows). Returns the paths by label, the kernel
    rows under "ntt_mxu_rows"."""
    paths = {label: serve_both_routes(label, path, seed, n or batches)
             for label, (path, n) in NTT_MXU_PATHS.items()}
    import torch

    torch.cuda.empty_cache()
    paths[next(iter(NTT_MXU_PATHS))]["ntt_mxu_rows"] = mxu_launch_rows(paths, seed)
    return paths


def ntt_mxu_kernel_entry(rows: list, launches: dict) -> dict:
    """ntt_mxu's entry of the kernels line, at the widest forward launch of
    the w32 cell (the widest of each path in `widest`)."""
    widest = {}
    for r in rows:
        if r["plain_ms"] is not None:
            widest[r["path"]] = r
    top = widest[next(iter(NTT_MXU_PATHS))]
    return dict(
        name="ntt_mxu", route="cuda", source=KERNEL_SOURCES["ntt_mxu"],
        replaces="she_tpu/ops/ntt_mxu.py:310", launches=sum(launches.values()), launches_by_path=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
        sass_issue_ms=top["sass_issue_ms"], butterfly_ms=top["butterfly_ms"],
        library="torch._int_mm (int8 x int8 -> int32) of a forward direction's D^2 digit-pair products of both "
                "products, stacked; no digit split, twist or recombination",
        widest=widest, shapes=rows,
    )


def ntt_mxu_summary(paths: dict, entry: dict, card: str) -> str:
    parts = []
    for label in NTT_MXU_PATHS:
        v, w = paths[label], entry["widest"][label]
        issue = "not counted" if w["sass_issue_ms"] is None else f"{w['sass_issue_ms']:.4f} ms"
        parts.append(
            f"{label} ({v['params']}, {v['batches']} batch(es) of {BATCH}): butterfly route "
            f"{v['routes']['butterfly']['median_s_per_batch']:.4f} s/batch, matrix route "
            f"{v['routes']['mxu']['median_s_per_batch']:.4f} s/batch, {v['launches']['ntt_mxu']} launches; "
            f"widest forward {tuple(w['shape'])}: {w['ms']:.4f} ms against bounds of {w['bytes_ms']:.4f} ms (bytes), "
            f"{w['operations_ms']:.4f} ms (int8): {100 * w['share_of_bound']:.1f}% of the bound by "
            f"{w['bound_by']}; the build's integer SASS issues in {issue}; the butterfly kernel "
            f"{w['butterfly_ms']:.4f} ms, torch._int_mm "
            f"{w['library_ms']:.4f} ms, plain {w['plain_ms']:.4f} ms")
    return "ntt_mxu (answers bit-identical on both routes, all decrypt): " + "; ".join(parts) + f"; on {card}"


def cli_phase(seed: int) -> dict:
    """The port's command-line tools, in process, on the card (their
    default device), in a temporary directory: generate 10,000 rows x 1 B,
    shard them in 2 and process them; build, inspect and read an mmap
    dictionary of them; generate a 4,096 x 128 PNNS database and process
    it; process 16,384 x 4 KiB entries for SimplePIR with the tool's
    defaults; warm a w32 PIR config (100,000 entries, a batch of 16) and a
    PNNS one. A tool that returns non-zero fails the run, and so does the
    plain NTT on CUDA tensors. A check phase: its kernel launches are
    reported; the NTT's N = 1024 launch shapes (the SimplePIR tool's) are
    returned for shape_timing."""
    import json as jsonmod
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from she_tpu_torch.cli import (mmap_tool, pir_generate_database, pir_process_database, pir_shard_database,
                                   pnns_generate_database, pnns_process_database, simple_pir_process_database,
                                   warm)
    label = "cli"
    reset_counts()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)

        def config(name: str, values: dict) -> str:
            path = d / name
            path.write_text(jsonmod.dumps(values))
            return str(path)

        steps = [
            ("pir_generate_database", pir_generate_database, [
                "--output-database", str(d / "db.binpb"), "--row-count", str(CLI_KEYWORD_ROWS), "--value-size", "1"]),
            ("pir_shard_database", pir_shard_database, [
                "--input-database", str(d / "db.binpb"), "--output-database", str(d / "shard-SHARD_ID.binpb"),
                "--shard-count", "2"]),
            ("pir_process_database", pir_process_database, [config("pir.json", {
                "inputDatabase": str(d / "db.binpb"), "outputDatabase": str(d / "processed-SHARD_ID.bin"),
                "outputPirParameters": str(d / "params-SHARD_ID.binpb"),
                "outputEvaluationKeyConfig": str(d / "ek.binpb"), "rlweParameters": PARAMS,
                "sharding": {"shardCount": 2}, "trialsPerShard": 1})]),
            ("mmap_tool dict", mmap_tool, ["dict", "--input-database", str(d / "db.binpb"),
                                           "--output", str(d / "db.mmap")]),
            ("mmap_tool info", mmap_tool, ["info", str(d / "db.mmap")]),
            ("mmap_tool get", mmap_tool, ["get", str(d / "db.mmap"), str(CLI_KEYWORD_ROWS - 1)]),
            ("pnns_generate_database", pnns_generate_database, [
                "--output-database", str(d / "pnns.binpb"), "--row-count", str(PNNS_DB[0]),
                "--vector-dimension", str(PNNS_DB[1])]),
            ("pnns_process_database", pnns_process_database, [config("pnns.json", {
                "inputDatabase": str(d / "pnns.binpb"), "outputDatabase": str(d / "pnns-processed.binpb"),
                "rlweParameters": PNNS_PATHS["pnns_4096x128_w32_b16"][0], "trialsPerShard": 1})]),
            ("pir_generate_database (SimplePIR entries)", pir_generate_database, [
                "--output-database", str(d / "spir.binpb"), "--row-count", str(CLI_SIMPLE_PIR_DB[0]),
                "--value-size", str(CLI_SIMPLE_PIR_DB[1])]),
            ("simple_pir_process_database", simple_pir_process_database, [config("spir.json", {
                "inputDatabase": str(d / "spir.binpb"), "outputDatabase": str(d / "spir-db.npy"),
                "outputHint": str(d / "spir-hint.npy"), "outputParameters": str(d / "spir-params.binpb"),
                "seed": (seed.to_bytes(4, "little") * 8).hex()})]),
            ("warm pir", warm, ["pir", "--params", PARAMS, "--scalar-bits", "32", "--entries", str(CLI_WARM_PIR[0]),
                                "--batch", str(CLI_WARM_PIR[1])]),
            ("warm pnns", warm, ["pnns", "--params", PNNS_PATHS["pnns_4096x128_w32_b16"][0], "--scalar-bits", "32",
                                 "--rows", str(PNNS_DB[0]), "--dim", str(PNNS_DB[1]), "--batch", str(PNNS_BATCH)]),
        ]
        for name, tool, argv in steps:
            t0 = time.perf_counter()
            rc = tool.main(argv)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"[{label}] {name} exited {rc}")
            log(f"[{label}] {name}: {seconds[name]:.3f} s")
        hint = np.load(d / "spir-hint.npy")
        if hint.shape != (CLI_SIMPLE_PIR_ROWS, CLI_SIMPLE_PIR_DEGREE) or hint.dtype != np.uint64:
            raise AssertionError(f"[{label}] the SimplePIR hint is {hint.dtype} {hint.shape}")
        files = sorted(f.name for f in d.iterdir())
    launches = {k: v for k, v in kernel_launches().items() if k in NTT_AND_DIM0 + ("simple_pir_matmul", "dim0_mac")}
    # N = 1024 is the SimplePIR tool's lattice dimension alone (22-bit q')
    simple_pir_shapes = {k: v for k, v in launch_shapes_of(NTT_KERNELS).items() if k.shape[-1] == CLI_SIMPLE_PIR_DEGREE}
    if not (launches["ntt_forward"] and launches["ntt_inverse"] and launches["dim0_int8"] and launches["dim0_mac"]):
        raise AssertionError(f"[{label}] the tools did not run the kernels on the card: {launches}")
    plain = plain_on_cuda(("ntt_forward", "ntt_inverse", "dim0_mac"))
    if any(plain.values()):
        raise AssertionError(f"[{label}] a plain NTT or MAC ran on CUDA tensors: {plain}")
    log(f"[{label}] every tool exited 0 on the card in {sum(seconds.values()):.3f} s; files {files}; kernel "
        f"launches {launches}")
    return dict(seconds=seconds, launches=launches, files=files, simple_pir_launch_shapes=simple_pir_shapes)


def _mesh_pir_context(params: str, entries: int, device):
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip

    ctx = bfv.get_bfv_context(paramsmod.from_predefined(params, scalar_bits=32), device=device)
    config = ip.IndexPirConfig(
        entry_count=entries, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
        uneven_dimensions=True, key_compression=ip.PirKeyCompression.NO_COMPRESSION,
    )
    return ctx, ip.generate_parameter(config, ctx)


def _mesh_database(entries: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, size=(entries, 1), dtype=np.uint8)


def mesh_pir_inputs(label: str, entries: int, seed: int) -> dict:
    """A w32 MulPIR cell for the mesh: the database (entries x 1 B from
    default_rng(seed)), MESH_BATCH queries and the evaluation key made by
    the port's client on the card, and the single-process
    BatchedMulPirServer's raw answers to them [B, 2, 1, N], made here
    before any rank starts. The ranks get the queries and the key as host
    arrays (queries are made once, not per rank)."""
    import numpy as np
    import torch

    from she_tpu_torch import convert
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    ctx, parameter = _mesh_pir_context(PARAMS, entries, None)
    database = _mesh_database(entries, seed)
    processed = ip.MulPirServer.process(database, ctx, parameter)
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    client = ip.MulPirClient(parameter, ctx)
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"evaluation-key-err-seed-32-bytes"))
    rng = np.random.default_rng(seed + 1)
    indices = [int(i) for i in rng.integers(0, entries, size=MESH_BATCH)]
    t0 = time.perf_counter()
    queries = [client.generate_query([i], sk) for i in indices]
    query_s = time.perf_counter() - t0
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    want = torch.stack([r.ciphertexts[0][0].stacked() for r in server.compute_response_batch(queries, ek)])
    torch.cuda.synchronize()
    log(f"[{label}] {entries} x 1 B at {PARAMS}, dims {parameter.dimensions}; {MESH_BATCH} queries made in "
        f"{query_s:.3f} s; the single-process server's answers taken as the reference")
    spec = dict(entries=entries, seed=seed,
                queries=np.stack([np.stack([ct.stacked().cpu().numpy() for ct in q.ciphertexts]) for q in queries]),
                ek=convert.evaluation_key_to_limbs(ek))
    return dict(spec=spec, want=want.cpu().numpy(), indices=indices, database=database, ctx=ctx, client=client,
                sk=sk, dims=parameter.dimensions)


def mesh_pnns_inputs(seed: int) -> dict:
    """The PNNS cell pnns_4096x128_w32_b16 for the mesh: PNNS_BATCH queries
    and the key made by the port's client on the card, the single-process
    BatchedPnnsServer's answers [B, R, 2, 1, N] as the reference."""
    import numpy as np
    import torch

    from she_tpu_torch import convert
    from she_tpu_torch.pnns import pnns
    from she_tpu_torch.pnns import serving
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    label = "pnns_4096x128_w32_b16"
    client_config, server_config, vectors = _mesh_pnns_config(seed)
    processed = pnns.process_database(
        pnns.Database([pnns.DatabaseRow(i, b"", v) for i, v in enumerate(vectors)]), server_config)
    client = pnns.Client(client_config)
    sk = client.generate_secret_key(nist_aes128_ctr(seed.to_bytes(4, "little") * 8))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(b"pnns-evaluation-key-err-seed-32b"))
    query_vectors = np.random.default_rng(seed + 1).standard_normal((PNNS_BATCH, 1, PNNS_DB[1])).astype(np.float32)
    queries = [client.generate_query(v, sk, err_rng=nist_aes128_ctr(bytes([i]) * 32))
               for i, v in enumerate(query_vectors)]
    responses = serving.BatchedPnnsServer(processed).compute_response_batch(queries, ek)
    torch.cuda.synchronize()
    log(f"[mesh] {label}: {PNNS_BATCH} queries made; the single-process server's answers taken as the reference")
    spec = dict(seed=seed, ek=convert.evaluation_key_to_limbs(ek)[0],
                queries=[[[convert.ciphertext_to_limbs(ct) for ct in m.ciphertexts] for m in q.ciphertext_matrices]
                         for q in queries])
    return dict(spec=spec, want=_pnns_values(responses), client=client, sk=sk, vectors=vectors,
                query_vectors=query_vectors, scaling_factor=client_config.scaling_factor,
                server=serving.BatchedPnnsServer(processed))


def _mesh_pnns_config(seed: int):
    import numpy as np

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pnns import pnns

    params, scalar_bits = PNNS_PATHS["pnns_4096x128_w32_b16"]
    rows, dim = PNNS_DB
    ep = paramsmod.from_predefined(params, scalar_bits=scalar_bits)
    ctx = bfv.get_bfv_context(ep)
    sf = pnns.max_scaling_factor(dim, [ep.plaintext_modulus])
    ek_config = pnns.matmul_evaluation_key_config(ctx, pnns.MatrixDimensions(rows, dim), 1)
    client_config = pnns.ClientConfig.create(ep, sf, pnns.MatrixPacking.dense_row(), dim, ek_config)
    server_config = pnns.ServerConfig(client_config, pnns.MatrixPacking.diagonal(pnns.BabyStepGiantStep.create(dim)))
    vectors = np.random.default_rng(seed).standard_normal((rows, dim)).astype(np.float32)
    return client_config, server_config, vectors


def _pnns_values(responses: list):
    """pnns.Response list -> int64 numpy [B, R, 2, 1, N] (one plaintext modulus)."""
    import numpy as np

    return np.stack([np.stack([c.stacked().cpu().numpy() for c in r.ciphertext_matrices[0].ciphertexts])
                     for r in responses])


def _rank_part(label: str, mesh, run, reps: int, kernels: tuple) -> dict:
    """One part on one rank: `run` called `reps` times (the first warms
    up), each call timed to a synchronize; every call's result must equal
    the first's. The kernel counts, gloo's staging and the peak device
    memory are read around the calls: each of `kernels` must have
    launched, the int8 dim-0 kernel only where it is one of them, the
    SimplePIR kernel and the plain NTT on CUDA tensors never, and the
    key-switch kernels as key_switch_counts says (the part switches keys
    where a pass of either route is one of `kernels`, and expands queries in batches
    where expand_combine is), the BEHZ kernels as behz_counts says (the
    part multiplies ciphertexts where behz_lift is one of `kernels`), the
    dim-0 MAC as mac_counts says (the part serves a MAC where dim0_mac
    is one of `kernels`) and the mod switch as mod_switch_counts says (the
    part mod-switches where mod_switch is one of `kernels`)."""
    import torch

    from she_tpu_torch import trace

    outs, seconds = [], []
    rank = torch.distributed.get_rank()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {k: v for k, v in kernel_launches().items() if k not in ("ntt_mxu",)}
    key_switch_counts(f"{label} rank {rank}", launches, bool(set(KS_SPLIT + KS_FUSED) & set(kernels)),
                      "expand_combine" in kernels)
    behz_counts(f"{label} rank {rank}", launches, "behz_lift" in kernels)
    mac_counts(f"{label} rank {rank}", launches, "dim0_mac" in kernels)
    mod_switch_counts(f"{label} rank {rank}", launches, "mod_switch" in kernels)
    if (any(launches[k] == 0 for k in kernels) or (launches["dim0_int8"] and "dim0_int8" not in kernels)
            or launches["simple_pir_matmul"] or any(plain_on_cuda(NTT_KERNELS).values())):
        raise AssertionError(f"[{label}] rank {rank}: launches {launches} (the part's kernels: {kernels}), plain "
                             f"NTT on CUDA {plain_on_cuda(NTT_KERNELS)}")
    for out in outs[1:]:
        if any(not torch.equal(a, b) for a, b in zip(out, outs[0], strict=True)):
            raise AssertionError(f"[{label}] rank {rank}: a repeated call answered differently")
    return dict(rank=rank, s=seconds, staged_bytes=trace.counters["collective.staged_bytes"],
                staged_s=trace.counters["collective.staged_s"], peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, launch_shapes=launch_shapes_of(NTT_KERNELS),
                dim0_shapes=launch_shapes_of(("dim0_int8",)), ks_shapes=launch_shapes_of(KS_KERNELS),
                behz_shapes=launch_shapes_of(BEHZ_KERNELS), mac_shapes=launch_shapes_of(("dim0_mac",)), reps=reps,
                out=[t.cpu().numpy() for t in outs[0]])


def _rank_pir_server(spec: dict, device):
    import torch

    from she_tpu_torch import convert
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pir import serving

    ctx, parameter = _mesh_pir_context(PARAMS, spec["entries"], device)
    processed = ip.MulPirServer.process(_mesh_database(spec["entries"], spec["seed"]), ctx, parameter)
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    ek = convert.evaluation_key_from_limbs(ctx, *spec["ek"])
    queries = [
        ip.Query([bfv.Ciphertext.from_stacked(ctx, torch.from_numpy(ct).to(device),
                                              ctx.ciphertext_context.get_context(ct.shape[-2])) for ct in q], 1)
        for q in spec["queries"]
    ]
    return ctx, server, ek, queries


def mesh_world2(mesh, specs: dict) -> dict:
    """Rank side of the 2-rank world ("batch"): (a) batch-parallel MulPIR,
    (d) batch-parallel PNNS."""
    import torch

    from she_tpu_torch import convert
    from she_tpu_torch.parallel import mesh as meshmod
    from she_tpu_torch.pnns import pnns
    from she_tpu_torch.pnns import serving as pnns_serving

    _, server, ek, queries = _rank_pir_server(specs["a"], mesh.device)

    def serve_a():
        responses = meshmod.batch_parallel_response(server, queries, ek, mesh)
        return [torch.stack([r.ciphertexts[0][0].stacked() for r in responses])]

    out = {"a": _rank_part("mesh (a)", mesh, serve_a, MESH_REPS, NTT_AND_DIM0 + KS_W32 + BEHZ_KERNELS)}
    del server, queries
    torch.cuda.empty_cache()
    spec = specs["d"]
    _, server_config, vectors = _mesh_pnns_config(spec["seed"])
    processed = pnns.process_database(
        pnns.Database([pnns.DatabaseRow(i, b"", v) for i, v in enumerate(vectors)]), server_config, device=mesh.device)
    pnns_server = pnns_serving.BatchedPnnsServer(processed)
    pek = convert.evaluation_key_from_limbs(processed.contexts[0], spec["ek"], None)
    pqueries = [convert.pnns_query_from_limbs(processed.contexts, (1, PNNS_DB[1]), pnns.MatrixPacking.dense_row(), q)
                for q in spec["queries"]]

    def serve_d():
        responses = meshmod.batch_parallel_pnns_response(pnns_server, pqueries, pek, mesh)
        return [torch.stack([torch.stack([c.stacked() for c in r.ciphertext_matrices[0].ciphertexts])
                             for r in responses])]

    out["d"] = _rank_part("mesh (d)", mesh, serve_d, MESH_REPS, NTT_KERNELS + KS_FUSED + ("dim0_mac", "mod_switch"))
    return out


def mesh_world4(mesh, specs: dict) -> dict:
    """Rank side of the 4-rank world, a (batch 2, db 2) mesh: (b) the
    two-axis MulPIR response, (c) dim0_partial_psum at S = 2 (the db axis)
    and 4 (a 4-rank db mesh) on (b)'s chunk, and at 64-bit scalars on
    random residues, (e) the N-sharded NTT at S = 2 and 4, limb-parallel
    NTTs and the N-sharded ct x ct multiply; each against the
    single-process function on this rank, after the timed calls."""
    import numpy as np
    import torch

    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.core.context import get_poly_context
    from she_tpu_torch.ops import dim0_mac, ntt
    from she_tpu_torch.parallel import mesh as meshmod
    from she_tpu_torch.parallel import sharded
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr
    from she_tpu_torch.utils import nt

    dev = mesh.device
    wide4 = meshmod.make_mesh((4,), ("db",), mesh.backend, dev)
    ctx, server, ek, queries = _rank_pir_server(specs["b"], dev)
    out = {"b": _rank_part("mesh (b)", mesh, lambda: [meshmod.two_axis_response(server, queries, ek, mesh)[0][0]],
                           MESH_REPS, NTT_AND_DIM0 + KS_W32 + BEHZ_KERNELS)}

    # (c): (b)'s chunk and the expansion of its first half-batch
    ct_ctx = server.ct_ctx
    chunk = server.chunks[0][0]
    stacked, _, _ = server.stack_queries_device(queries[: MESH_BATCH // 2])
    query_eval, _ = server.dim0_query(server.expand(stacked, ek))
    del stacked
    out["c"] = {}
    # every part is held to the plain MAC, not to the dim0_mac kernel
    want = dim0_mac.dim0_mac_plain(chunk, query_eval, ct_ctx).cpu().numpy()
    for S, m in ((2, mesh), (4, wide4)):
        # the server's digits of this rank's d0 slice: at S = 2, (b)'s own
        digits = server.slice_digits(0, 0, meshmod.shard(chunk.shape[1], m, "db", "d0"))
        out["c"][f"w32_S{S}"] = _rank_part(
            f"mesh (c) S={S}", m,
            lambda m=m, digits=digits: [meshmod.dim0_partial_psum(chunk, query_eval, ct_ctx, m, "db", digits)],
            MESH_REPS, ("dim0_int8",))
        out["c"][f"w32_S{S}"]["equal"] = bool(np.array_equal(out["c"][f"w32_S{S}"]["out"][0], want))
    del query_eval, digits
    w64_moduli = paramsmod.from_predefined(PATHS["w64"][0], scalar_bits=64).coefficient_moduli[:2]
    C, d0, P, N = MESH_PSUM_W64
    ctx64 = get_poly_context(N, tuple(w64_moduli), 64, dev)
    db64, q64 = random_residues(w64_moduli, (C, d0), N, 70), random_residues(w64_moduli, (d0, P), N, 71)
    want = dim0_mac.dim0_mac_plain(db64, q64, ctx64).cpu().numpy()
    for S, m in ((2, mesh), (4, wide4)):
        part = _rank_part(f"mesh (c) w64 S={S}", m, lambda m=m: [meshmod.dim0_partial_psum(db64, q64, ctx64, m)],
                          MESH_REPS, ("dim0_mac",))
        part["equal"] = bool(np.array_equal(part["out"][0], want))
        out["c"][f"w64_S{S}"] = part
    del db64, q64, server, queries, chunk
    torch.cuda.empty_cache()

    # (e) the sharded NTTs, limb-parallel NTTs and sharded ct x ct
    out["e"] = {}
    for label, ep in (("w32", paramsmod.from_predefined(PARAMS, scalar_bits=32)),
                      ("w64", paramsmod.from_predefined(PATHS["w64"][0], scalar_bits=64))):
        moduli, n = ep.coefficient_moduli, ep.poly_degree
        tables = ntt.build_ntt_tables(tuple(moduli), n, dev)
        x = random_residues(moduli, (), n, 80)
        want = ntt.forward_ntt(x, tables)
        for S, m in ((2, mesh), (4, wide4)):
            sn = sharded.ShardedNtt(m, tables, "db")
            part = _rank_part(f"mesh (e) ShardedNtt {label} S={S}", m, lambda sn=sn: [sn.inverse(sn.forward(x))],
                              MESH_REPS, NTT_KERNELS)
            fwd = sn.forward(x)
            part["equal"] = bool(torch.equal(fwd, want) and torch.equal(sn.inverse(fwd), x)
                                 and np.array_equal(part["out"][0], x.cpu().numpy()))
            out["e"][f"sharded_ntt_{label}_S{S}"] = part
    n = paramsmod.from_predefined(PARAMS, scalar_bits=32).poly_degree
    limb_moduli = tuple(nt.generate_primes([28] * MESH_LIMB_MODULI, preferring_small=True, ntt_degree=n))
    tables = ntt.build_ntt_tables(limb_moduli, n, dev)
    x = random_residues(limb_moduli, (2,), n, 81)
    want = ntt.forward_ntt(x, tables)
    for S, m in ((2, mesh), (4, wide4)):
        fwd, inv = sharded.limb_parallel_ntt_fns(m, tables, "db")
        part = _rank_part(f"mesh (e) limb-parallel S={S}", m, lambda fwd=fwd, inv=inv: [inv(fwd(x))], MESH_REPS,
                          NTT_KERNELS)
        part["equal"] = bool(torch.equal(fwd(x), want) and np.array_equal(part["out"][0], x.cpu().numpy()))
        out["e"][f"limb_parallel_L{MESH_LIMB_MODULI}_S{S}"] = part
    ctx = bfv.get_bfv_context(paramsmod.from_predefined(PARAMS, scalar_bits=32), device=dev)
    sk = bfv.generate_secret_key(ctx, nist_aes128_ctr(b"mesh-ct-mul-secret-key-seed-32by"))
    t = ctx.plaintext_modulus
    rng = np.random.default_rng(82)
    va, vb = rng.integers(0, t, size=(2, ctx.degree))
    a, b = (bfv.encrypt(bfv.encode(ctx, [int(v) for v in vals]), sk, seed=bytes([i]) * 32,
                        err_rng=nist_aes128_ctr(bytes([i + 1]) * 32)) for i, vals in enumerate((va, vb)))
    part = _rank_part("mesh (e) sharded_ct_mul S=2", mesh, lambda: [sharded.sharded_ct_mul(a, b, mesh, "db").stacked()],
                      MESH_REPS, NTT_KERNELS + BEHZ_KERNELS)
    product = bfv.Ciphertext.from_stacked(ctx, torch.from_numpy(part["out"][0]).to(dev), ctx.ciphertext_context)
    full = np.convolve(va, vb)
    folded = full[: ctx.degree].copy()
    folded[: len(full) - ctx.degree] -= full[ctx.degree :]
    part["equal"] = bool(np.array_equal(part["out"][0], bfv.ct_mul(a, b).stacked().cpu().numpy())
                         and bfv.decode(ctx, bfv.decrypt(product, sk)) == [int(v) % t for v in folded])
    out["e"]["sharded_ct_mul_S2"] = part
    return out


def _merge_parts(label: str, parts: list) -> dict:
    """One part's rank results -> a path entry of the run: launch counts
    and shapes summed over the ranks, the per-rank seconds, staging and
    peak memory."""
    from collections import Counter

    launches, shapes, dim0, ks, bz, mac = Counter(), Counter(), Counter(), Counter(), Counter(), Counter()
    for p in parts:
        launches.update(p["launches"])
        shapes.update(p["launch_shapes"])
        dim0.update(p["dim0_shapes"])
        ks.update(p["ks_shapes"])
        bz.update(p["behz_shapes"])
        mac.update(p["mac_shapes"])
    reps = parts[0]["reps"]
    per_rank = [dict(rank=p["rank"], s_per_call=p["s"], median_s=statistics.median(p["s"][1:] or p["s"]),
                     staged_bytes=p["staged_bytes"], staged_s=p["staged_s"], peak_bytes=p["peak_bytes"])
                for p in parts]
    return dict(path=label, launches=dict(launches), launches_per_batch={k: v / reps for k, v in launches.items()},
                launch_shapes=dict(shapes), dim0_shapes=dict(dim0), ks_shapes=dict(ks), behz_shapes=dict(bz),
                mac_shapes=dict(mac), batches=reps,
                ranks=per_rank)


def _log_part(entry: dict, card: str, what: str) -> None:
    for r in entry["ranks"]:
        log(f"[{entry['path']}] rank {r['rank']}: {what} {', '.join(f'{s:.4f}' for s in r['s_per_call'])} s "
            f"(median after the first {r['median_s']:.4f} s); gloo staged {r['staged_bytes']} bytes in "
            f"{r['staged_s']:.4f} s; peak {r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.3f} GiB); on {card}")
    log(f"[{entry['path']}] kernel launches over the ranks: {entry['launches']}")


def _same_on_every_rank(label: str, parts: list):
    import numpy as np

    first = parts[0]["out"]
    for p in parts[1:]:
        if any(not np.array_equal(a, b) for a, b in zip(first, p["out"], strict=True)):
            raise AssertionError(f"[{label}] rank {p['rank']} returned another result than rank {parts[0]['rank']}")
    return first


def mesh_phase(seed: int) -> dict:
    """Multi-device serving (she_tpu_torch.parallel) with gloo ranks that
    share this card, each rank a process on cuda:0 (the script needs one
    card; NCCL takes one card a rank). A check of correctness on one
    card, not a scaling measurement: every part is held bit-equal to the
    single-process result, (a), (b) and (d) also decrypt every answer.
    (a) batch-parallel MulPIR, 1M x 1 B, 128 queries over 2 ranks; (b)
    two-axis MulPIR, 2,097,152 x 1 B (dims 32 x 32), 128 queries on a
    (batch 2, db 2) mesh of 4 ranks; (c) dim0_partial_psum on (b)'s chunk
    at S = 2, 4 (the sum branch, the int8 kernel on each rank's digit
    slice) and at 64-bit scalars on random residues (the butterfly); (d)
    batch-parallel PNNS, 16 queries over 2 ranks; (e) ShardedNtt at S = 2,
    4 on [3, 4096] w32 and [3, 8192] w64 moduli, limb-parallel NTTs of 4
    moduli and sharded_ct_mul at S = 2. The kernels are built before any
    rank starts; the ranks only load them."""
    import numpy as np
    import torch

    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.parallel import mesh as meshmod
    from she_tpu_torch.pir import index_pir as ip
    from she_tpu_torch.pnns import pnns

    card = card_line()
    a = mesh_pir_inputs("mesh (a)", ENTRY_COUNT, seed)
    b = mesh_pir_inputs("mesh (b)", MESH_TWO_AXIS_ENTRIES, seed + 2)
    if b["dims"] != MESH_TWO_AXIS_DIMS:
        raise AssertionError(f"the two-axis cell's dims are {b['dims']}, not {MESH_TWO_AXIS_DIMS}")
    d = mesh_pnns_inputs(seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[mesh] parent holds {torch.cuda.memory_allocated()} bytes before the ranks start")
    t0 = time.perf_counter()
    world2 = meshmod.run_ranks(mesh_world2, (2,), ("batch",), "gloo", "cuda", {"a": a["spec"], "d": d["spec"]})
    world2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    world4 = meshmod.run_ranks(mesh_world4, (2, 2), ("batch", "db"), "gloo", "cuda", {"b": b["spec"]})
    world4_s = time.perf_counter() - t0
    log(f"[mesh] 2 ranks ran (a) and (d) in {world2_s:.3f} s, 4 ranks (b), (c) and (e) in {world4_s:.3f} s, "
        f"spawn and set-up included; on {card}")

    paths = {}
    single = a["ctx"].ciphertext_context.get_context(1)
    for key, inputs, world, label, what in (("a", a, world2, "mesh_batch_w32", "batch-parallel call of 128 queries"),
                                            ("b", b, world4, "mesh_two_axis_w32", "two-axis call of 128 queries")):
        parts = [w[key] for w in world]
        got = _same_on_every_rank(label, parts)[0]
        if not np.array_equal(got, inputs["want"]):
            raise AssertionError(f"[{label}] differs from the single-process server")
        for v, index in zip(got, inputs["indices"]):
            response = ip.Response([[bfv.Ciphertext.from_stacked(inputs["ctx"], torch.from_numpy(v).cuda(), single)]])
            if inputs["client"].decrypt(response, [index], inputs["sk"]) != [inputs["database"][index].tobytes()]:
                raise AssertionError(f"[{label}] the answer for entry {index} does not decrypt to it")
        entry = _merge_parts(label, parts)
        _log_part(entry, card, what)
        log(f"[{label}] bit-identical to the single-process server on every rank; all {MESH_BATCH} answers decrypt")
        paths[label] = entry

    parts = [w["d"] for w in world2]
    got = _same_on_every_rank("mesh_pnns_w32", parts)[0]
    if not np.array_equal(got, d["want"]):
        raise AssertionError("[mesh_pnns_w32] differs from the single-process server")
    db_rounded = pnns.normalized_scaled_and_rounded(d["vectors"], d["scaling_factor"])
    # the mesh's answers as pnns.Response objects, through the single server's assembly
    responses = d["server"]._assemble_responses([torch.from_numpy(got).cuda().transpose(0, 1)], PNNS_BATCH)
    for qv, response in zip(d["query_vectors"], responses):
        want = db_rounded @ pnns.normalized_scaled_and_rounded(qv, d["scaling_factor"]).T
        if not np.array_equal(d["client"].scores(response, d["sk"]), want):
            raise AssertionError("[mesh_pnns_w32] scores differ from the integer dot products")
    entry = _merge_parts("mesh_pnns_w32", parts)
    _log_part(entry, card, f"batch-parallel call of {PNNS_BATCH} queries")
    log(f"[mesh_pnns_w32] bit-identical to the single-process server on every rank; all {PNNS_BATCH} x "
        f"{PNNS_DB[0]} scores equal the integer dot products")
    paths["mesh_pnns_w32"] = entry

    for key, label in (("c", "mesh_dim0_psum"), ("e", "mesh_sharded")):
        cases = world4[0][key]
        parts = []
        for case in cases:
            case_parts = [w[key][case] for w in world4]
            _same_on_every_rank(f"{label} {case}", case_parts)
            if not all(p["equal"] for p in case_parts):
                raise AssertionError(f"[{label}] {case} differs from the single-process function")
            e = _merge_parts(f"{label} {case}", case_parts)
            _log_part(e, card, "call")
            parts += case_parts
        log(f"[{label}] {', '.join(cases)}: bit-identical to the single-process functions on every rank")
        paths[label] = _merge_parts(label, parts)
    return paths


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
    for name in built:
        for line in ptxas_lines(name):
            log(f"  {name}: {line}")

    if args.only == "dim0":
        return dim0_only(args, card)
    if args.only == "simple_pir":
        return simple_pir_only(args, card)
    if args.only == "mesh":
        return mesh_only(args, card)
    if args.only == "ntt_mxu":
        return ntt_mxu_only(args, card)
    if args.only == "key_switch":
        return key_switch_only(args, card)
    if args.only == "behz":
        return behz_only(args, card)
    if args.only == "dim0_mac":
        return dim0_mac_only(args, card)
    if args.only == "ntt":
        return ntt_only(args, card)
    if args.only == "mod_switch":
        return mod_switch_only(args, card)

    checked = kernel_phase(args.seed)
    paths = {}
    for _, drive in serving_phases(args):
        paths.update(drive())
        torch.cuda.empty_cache()
    cli = cli_phase(args.seed)
    shapes = ntt_launch_timing(paths)  # every kernel's timing before any plain version
    for name, rows in ntt_kernel_timing("cli:simple_pir_process_database", cli.pop("simple_pir_launch_shapes"),
                                        1).items():
        if not rows:
            raise AssertionError(f"the SimplePIR tool did not launch {name} at N = {CLI_SIMPLE_PIR_DEGREE}")
        shapes[name].extend(rows)
    mac_rows = mac_kernel_timing(paths)  # before any plain dim-0 MAC
    behz_rows = behz_kernel_timing(paths)  # before any plain BEHZ version
    ks_rows = ks_shape_timing(paths)  # before the NTT's and dim-0's plain versions
    behz_checked = behz_plain_checks(paths, behz_rows)
    mac_checked = mac_plain_checks(paths, mac_rows)
    dim0_rows = timed_launch_shapes(paths, shapes)
    w64_check = dim0_w64_check()

    kernels = ntt_kernel_entries(shapes, paths, checked)
    if not dim0_rows:
        raise AssertionError("no served path launched the int8 dim-0 kernel")
    dim0_entry = dim0_kernel_entry(dim0_rows, w64_check, sum(p["launches"]["dim0_int8"] for p in paths.values()))
    dim0_entry["launches_by_path"] = {p: v["launches"]["dim0_int8"] for p, v in paths.items()}
    kernels.append(dim0_entry)
    simple_pir_rows = [r for p in paths.values() for r in p.get("simple_pir_rows", [])]
    if not simple_pir_rows:
        raise AssertionError("no served path launched the SimplePIR kernel")
    kernels.append(simple_pir_kernel_entry(
        simple_pir_rows, {p: v["launches"]["simple_pir_matmul"] for p, v in paths.items()}))
    mxu_entry = ntt_mxu_kernel_entry(paths[next(iter(NTT_MXU_PATHS))].pop("ntt_mxu_rows"),
                                     {p: paths[p]["launches"]["ntt_mxu"] for p in NTT_MXU_PATHS})
    kernels.append(mxu_entry)
    ks_entries = ks_kernel_entries(ks_rows, paths)
    kernels += ks_entries
    behz_entries = behz_kernel_entries(behz_rows, behz_checked, paths)
    kernels += behz_entries
    mac_entry = mac_kernel_entry(mac_rows, mac_checked, paths)
    kernels.append(mac_entry)
    if sorted(k["name"] for k in kernels) != sorted(KERNEL_SOURCES):
        raise AssertionError(f"the kernels line names {[k['name'] for k in kernels]}, not {list(KERNEL_SOURCES)}")
    widest = max(dim0_rows, key=lambda r: r["bytes"])
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
    for label in PNNS_PATHS:
        v = paths[label]
        log(f"{label} ({v['params']} at {v['scalar_bits']}-bit scalars, {v['rows']} x {v['dim']}, {v['batch']} "
            f"queries a batch): database processing {v['process_s']:.4f} s, first batch {v['first_batch_s']:.4f} s, "
            f"then median {v['median_s_per_batch']:.4f} s/batch (max {v['max_s_per_batch']:.4f} s over "
            f"{v['steady_batches']} batches), {v['queries_per_s']:.2f} queries/s; device ms by stage "
            f"{ {k: round(x, 3) for k, x in v['stages_ms'].items()} }; NTT {100 * v['profile']['ntt_share']:.1f}% of "
            f"device time, idle share {v['profile']['idle_share_of_steady_batch']:.3f}; peak {v['peak_bytes']} "
            f"bytes; smallest noise budget {v['min_noise_budget']:.3f} bits; on {card}")
    log(simple_pir_summary(paths[SIMPLE_PIR_CELL], next(k for k in kernels if k["name"] == "simple_pir_matmul"),
                           card))
    log(ntt_mxu_summary(paths, mxu_entry, card))
    log(mesh_summary(paths, card))
    log(ks_summary(ks_entries, paths, card))
    log(mod_switch_summary(next(e for e in ks_entries if e["name"] == "mod_switch"), paths, card))
    log(behz_summary(behz_entries, paths, card))
    log(mac_summary(mac_entry, next(e for e in ks_entries if e["name"] == "expand_leaves"), paths, card))
    log(f"cli: every tool exited 0 on the card, {sum(cli['seconds'].values()):.3f} s in all, on {card}")
    log(f"dim0_int8 at the widest served shape ({widest['path']}, digits {widest['digits_shape']}, query "
        f"{widest['query_shape']}): {widest['ms']:.4f} ms against a bound of {widest['bound_ms']:.4f} ms "
        f"({100 * widest['share_of_bound']:.1f}%), MAC {widest['mac_ms']:.4f} ms, digit bmm "
        f"{widest['library_ms']:.4f} ms; launches by path {dim0_entry['launches_by_path']}, on {card}")
    return report(args, card, kernels, paths=paths, kernel_build_s=built, cli=cli)


def ntt_launch_timing(paths: dict) -> dict:
    """ntt_kernel_timing at every NTT launch shape of the paths' runs (and
    of their set-ups), before any plain version: its rows by kernel."""
    shapes = {"ntt_forward": [], "ntt_inverse": []}
    for path, result in paths.items():
        for name, rows in ntt_kernel_timing(path, result["launch_shapes"], result["batches"]).items():
            shapes[name].extend(rows)
        if "setup_launch_shapes" in result:  # the set-up's NTTs (PNNS: SIMD encoding at t, to Eval)
            for name, rows in ntt_kernel_timing(f"{path}:setup", result["setup_launch_shapes"], 1).items():
                shapes[name].extend(rows)
    return shapes


def timed_launch_shapes(paths: dict, shapes: dict) -> list:
    """The NTT rows of ntt_launch_timing (`shapes`, by kernel) held to the
    plain version (ntt_plain_checks), then every int8 dim-0 launch shape of
    the paths' runs held to the plain version and timed: dim0_shape_timing's
    rows. Fails on an int8 dim-0 shape that DIM0_SERVED_SHAPES does not
    list."""
    ntt_plain_checks(shapes)
    dim0_rows = []
    for path, result in paths.items():
        dim0_rows += dim0_shape_timing(path, result["dim0_shapes"], result["batches"])
    served = {(r["C"], r["d0"], r["P"], r["digits_shape"][1]) for r in dim0_rows}
    if not served <= set(DIM0_SERVED_SHAPES.values()):
        raise AssertionError(f"served int8 dim-0 shapes {sorted(served - set(DIM0_SERVED_SHAPES.values()))} "
                             f"are missing from DIM0_SERVED_SHAPES")
    return dim0_rows


def launch_rows(path: dict) -> None:
    """A path's launch counters, keyed by ntt_cuda.LaunchKey (and
    ntt_mxu_cuda.DirectionKey, key_switch_cuda.KsKey, behz_cuda.BehzKey,
    dim0_mac_cuda.MacKey)
    and by the int8 dim-0 kernel's (digits shape, query shape, moduli), as
    JSON rows, in place."""
    for key in ("launch_shapes", "setup_launch_shapes", "mxu_shapes", "ks_shapes", "behz_shapes", "mac_shapes"):
        if key in path:
            path[key] = [dict(k._asdict(), launches=v) for k, v in path[key].items()]
    path["dim0_shapes"] = [dict(digits_shape=k[0], query_shape=k[1], moduli=k[2], launches=v)
                           for k, v in path["dim0_shapes"].items()]


def report(args, card: str, kernels: list, **summary) -> int:
    """The end of every run: the full results to --json-out (the paths'
    launch counters as rows), then the kernels line, the card line and
    the last line."""
    import torch

    for path in summary.get("paths", {}).values():
        launch_rows(path)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(card=card, device=torch.cuda.get_device_name(0), kernels=kernels, **summary), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


def serving_phases(args) -> list:
    """The serving phases of the default run, in order, as (name, drive):
    each drive returns its paths' results by name (the keyword phase also
    runs the service on the keyword cell's database)."""
    phases = [(path, lambda path=path: {path: main_path(path, args.seed, args.batches)}) for path in PATHS]
    return phases + [("keyword", lambda: keyword_and_service(args.seed, args.batches)),
                     ("keyword_large", lambda: {"keyword_large": large_value_path(args.seed)}),
                     ("spir", lambda: {"spir": spir_phase(args.seed)})] + [
        (label, lambda label=label: {label: pnns_path(label, args.seed, args.batches)}) for label in PNNS_PATHS] + [
        (SIMPLE_PIR_CELL, lambda: {SIMPLE_PIR_CELL: simple_pir_path(args.seed, args.batches)}),
        ("mesh", lambda: mesh_phase(args.seed)),
        ("ntt_mxu", lambda: matrix_ntt_phase(args.seed, args.batches))]


def dim0_only(args, card: str) -> int:
    """--only dim0: the int8 dim-0 kernel at every served shape and the w64
    check (dim0_case); then the kernels line (launches: those of this run's
    checks and timings) and the last line."""
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch import trace

    moduli = paramsmod.from_predefined(PARAMS, scalar_bits=32).coefficient_moduli[:2]
    trace.reset()
    rows = [dim0_case(label, moduli, *shape, 60 + i) for i, (label, shape) in enumerate(DIM0_SERVED_SHAPES.items())]
    w64_check = dim0_w64_check()
    entry = dim0_kernel_entry(rows, w64_check, trace.counters["launch.dim0_int8"])
    return report(args, card, [entry])


def simple_pir_summary(v: dict, entry: dict, card: str) -> str:
    return (f"{SIMPLE_PIR_CELL} ({v['params']}, {v['entries']} x {v['entry_size']} B, database "
            f"{v['database_shape']}): packing {v['pack_s']:.3f} s, hint {v['hint_s']:.3f} s, query {v['median_query_s']:.4f} "
            f"s a client (host), median {v['median_s_per_batch']:.5f} s a batch of {v['batch']} (max "
            f"{v['max_s_per_batch']:.5f} s), {v['queries_per_s']:.2f} queries/s, per-query call {v['single_s']:.5f} s, "
            f"one more batch {v['span']['wall_ms']:.4f} ms of wall, its device span {v['span']['span_ms']:.4f} ms "
            f"(idle share {v['span']['idle_share']:.3f}), peak {v['peak_bytes']} bytes; simple_pir_matmul "
            + "; ".join(f"{r['query_shape'][0]} request rows {r['ms']:.4f} ms against a bound of {r['bound_ms']:.4f} ms "
                        f"({100 * r['bound_ms'] / r['ms']:.1f}%; at p bits an entry {r['data_bound_ms']:.4f} ms, "
                        f"{100 * r['data_bound_ms'] / r['ms']:.1f}%), plain {r['plain_ms']:.4f} ms, float64 matmul "
                        f"{r['library_ms']:.4f} ms" for r in entry["shapes"])
            + f"; on {card}")


def simple_pir_only(args, card: str) -> int:
    """--only simple_pir: the SimplePIR cell alone, its NTT launch shapes
    held to the plain version and timed; then the kernels line (the NTT
    kernels and simple_pir_matmul, with this phase's launches) and the
    last line."""
    v = simple_pir_path(args.seed, args.batches)
    paths = {SIMPLE_PIR_CELL: v}
    kernels = ntt_kernel_entries(shape_timing(SIMPLE_PIR_CELL, v["launch_shapes"], v["batches"]), paths, None)
    kernels.append(simple_pir_kernel_entry(v["simple_pir_rows"], {SIMPLE_PIR_CELL: v["launches"]["simple_pir_matmul"]}))
    log(simple_pir_summary(v, kernels[-1], card))
    return report(args, card, kernels, paths=paths)


def mesh_summary(paths: dict, card: str) -> str:
    parts = []
    for label in MESH_PATHS:
        v = paths[label]
        medians = [r["median_s"] for r in v["ranks"]]
        parts.append(f"{label} median {min(medians):.4f}-{max(medians):.4f} s a call over {len(medians)} rank "
                     f"results, gloo staged {sum(r['staged_bytes'] for r in v['ranks'])} bytes")
    return "mesh (one card, gloo ranks; every part bit-identical to one process): " + "; ".join(parts) + f"; on {card}"


def mesh_only(args, card: str) -> int:
    """--only mesh: the mesh phase alone, every NTT, int8 dim-0,
    key-switch, BEHZ and dim-0 MAC launch shape of its ranks held to the
    plain version and timed in this process after the ranks have exited;
    then the kernels line (the NTT kernels, dim0_int8, the key-switch, the
    BEHZ kernels and dim0_mac, with the ranks' launches) and the last
    line."""
    paths = mesh_phase(args.seed)
    shapes = ntt_launch_timing(paths)
    mac_rows = mac_kernel_timing(paths)
    behz_rows = behz_kernel_timing(paths)
    ks_rows = ks_shape_timing(paths)
    behz_checked = behz_plain_checks(paths, behz_rows)
    mac_checked = mac_plain_checks(paths, mac_rows)
    dim0_rows = timed_launch_shapes(paths, shapes)
    kernels = ntt_kernel_entries(shapes, paths, None)
    entry = dim0_kernel_entry(dim0_rows, dim0_w64_check(), sum(p["launches"]["dim0_int8"] for p in paths.values()))
    entry["launches_by_path"] = {p: v["launches"]["dim0_int8"] for p, v in paths.items()}
    kernels.append(entry)
    kernels += ks_kernel_entries(ks_rows, paths)
    kernels += behz_kernel_entries(behz_rows, behz_checked, paths)
    kernels.append(mac_kernel_entry(mac_rows, mac_checked, paths))
    log(mesh_summary(paths, card))
    return report(args, card, kernels, paths=paths)


def ntt_mxu_only(args, card: str) -> int:
    """--only ntt_mxu: the matrix NTT phase alone (both MulPIR cells on
    both routes, the fused kernel at every launched shape and the 60-bit
    check); then the kernels line (ntt_mxu, with this phase's
    launches) and the last line."""
    paths = matrix_ntt_phase(args.seed, args.batches)
    entry = ntt_mxu_kernel_entry(paths[next(iter(NTT_MXU_PATHS))].pop("ntt_mxu_rows"),
                                 {p: paths[p]["launches"]["ntt_mxu"] for p in NTT_MXU_PATHS})
    log(ntt_mxu_summary(paths, entry, card))
    return report(args, card, [entry], paths=paths)


def key_switch_only(args, card: str) -> int:
    """--only key_switch: the w32, w64 and keyword cells (the w64 cell's
    key switches take the split route, the others' the fused one), then
    each key-switch kernel at every shape they launched it with
    (ks_shape_timing); then the kernels line (the key-switch kernels,
    with these cells' launches) and the last line."""
    paths = {path: main_path(path, args.seed, args.batches) for path in ("w32", "w64")}
    paths["keyword"] = keyword_path(args.seed, args.batches)[0]
    entries = ks_kernel_entries(ks_shape_timing(paths), paths)
    for path, p in paths.items():
        log(f"{path}: median {p['median_s_per_batch']:.4f} s/batch, device ms by stage "
            f"{ {k: round(v, 3) for k, v in p['stages_ms'].items()} }, on {card}")
    log(ks_summary(entries, paths, card))
    return report(args, card, entries, paths=paths)


def mod_switch_only(args, card: str) -> int:
    """--only mod_switch: the w64, w32, keyword and both PNNS cells, then
    mod_switch timed at every shape they launched it with, before any
    plain version, and held bit-equal to it at each (ks_shape_timing);
    then the kernels line (mod_switch, with these cells' launches) and the
    last line."""
    paths = {path: main_path(path, args.seed, args.batches) for path in ("w64", "w32")}
    paths["keyword"] = keyword_path(args.seed, args.batches)[0]
    for label in PNNS_PATHS:
        paths[label] = pnns_path(label, args.seed, args.batches)
    names = ("mod_switch",)
    entries = ks_kernel_entries(ks_shape_timing(paths, names), paths, names)
    for path, p in paths.items():
        log(f"{path}: median {p['median_s_per_batch']:.4f} s/batch, device ms by stage "
            f"{ {k: round(v, 4) for k, v in p['stages_ms'].items()} }, on {card}")
    log(mod_switch_summary(entries[0], paths, card))
    return report(args, card, entries, paths=paths)


def behz_only(args, card: str) -> int:
    """--only behz: the w32, w64 and keyword cells, then each BEHZ kernel
    timed at the widest shape of each cell and held to its plain version
    at every shape they launched it with; then the kernels line (the three
    BEHZ kernels, with these cells' launches) and the last line."""
    paths = {path: main_path(path, args.seed, args.batches) for path in PATHS}
    paths["keyword"] = keyword_path(args.seed, args.batches)[0]
    rows = behz_kernel_timing(paths)
    entries = behz_kernel_entries(rows, behz_plain_checks(paths, rows), paths)
    for path, p in paths.items():
        log(f"{path}: median {p['median_s_per_batch']:.4f} s/batch, peak {p['peak_bytes']} bytes, device ms by stage "
            f"{ {k: round(v, 3) for k, v in p['stages_ms'].items()} }, on {card}")
    log(behz_summary(entries, paths, card))
    return report(args, card, entries, paths=paths)


def dim0_mac_only(args, card: str) -> int:
    """--only dim0_mac: the w64, w32 and keyword cells and both PNNS
    cells, then dim0_mac timed at the widest shape of each path that
    launched it and held to its plain version at every shape, and
    expand_combine and its leaf instance at every shape they launched with
    (ks_shape_timing); then the kernels line (dim0_mac, expand_combine and
    expand_leaves, with these cells' launches) and the last line."""
    paths = {path: main_path(path, args.seed, args.batches) for path in ("w64", "w32")}
    paths["keyword"] = keyword_path(args.seed, args.batches)[0]
    for label in PNNS_PATHS:
        paths[label] = pnns_path(label, args.seed, args.batches)
    mac_rows = mac_kernel_timing(paths)
    names = ("expand_combine", "expand_leaves")
    ks_entries = ks_kernel_entries(ks_shape_timing(paths, names), paths, names)
    entry = mac_kernel_entry(mac_rows, mac_plain_checks(paths, mac_rows), paths)
    for path, p in paths.items():
        log(f"{path}: median {p['median_s_per_batch']:.4f} s/batch, peak {p['peak_bytes']} bytes, device ms by stage "
            f"{ {k: round(v, 3) for k, v in p['stages_ms'].items()} }, on {card}")
    log(mac_summary(entry, ks_entries[1], paths, card))
    return report(args, card, [entry] + ks_entries, paths=paths)


def keyword_widest_ntt_keys() -> dict:
    """Both NTT directions at the keyword cell's widest launch shape (its
    widest expansion level: [128, 128, 2, 3, 4096] on the key-switching
    moduli, the 32-bit route), as launch keys with no launches: what
    --only ntt times of the 32-bit route without serving that cell."""
    from she_tpu_torch import params as paramsmod
    from she_tpu_torch.ops import ntt_cuda

    ep = paramsmod.from_predefined(PARAMS, scalar_bits=32)
    moduli, n = tuple(ep.coefficient_moduli), ep.poly_degree
    return {ntt_cuda.LaunchKey(name, (BATCH, BATCH, 2, len(moduli), n), moduli, None): 0 for name in NTT_KERNELS}


def ntt_only(args, card: str) -> int:
    """--only ntt: the w32 and w64 cells, then each NTT kernel timed at
    every shape they launched it with, and at the keyword cell's widest
    shape (keyword_widest_ntt_keys), before any plain version, then held
    bit-equal to the plain version at each; then the kernels line (the
    NTT kernels, with these cells' launches) and the last line."""
    paths = {path: main_path(path, args.seed, args.batches) for path in PATHS}
    shapes = ntt_launch_timing(paths)
    keyword_widest = ntt_kernel_timing("keyword widest (timed, not served here)", keyword_widest_ntt_keys(), 1)
    ntt_plain_checks(shapes)
    ntt_plain_checks(keyword_widest)
    kernels = ntt_kernel_entries(shapes, paths, None)
    for path, p in paths.items():
        kernel_ms = p["profile"]["kernel_ms"]
        log(f"{path}: median {p['median_s_per_batch']:.4f} s/batch, NTT kernels {kernel_ms['ntt_forward']:.3f} + "
            f"{kernel_ms['ntt_inverse']:.3f} ms of the profiled batch's {p['profile']['busy_ms']:.3f} busy ms, idle "
            f"share {p['profile']['idle_share_of_steady_batch']:.3f}, device ms by stage "
            f"{ {k: round(v, 3) for k, v in p['stages_ms'].items()} }, on {card}")
    for name, rows in shapes.items():
        for r in rows:
            log(f"{name} {r['path']} {tuple(r['shape'])}: {r['ms']:.4f} ms ({100 * r['share_of_bound']:.1f}% of the "
                f"{r['bound_ms']:.4f} ms byte bound), {r['launches_per_batch']:g} a batch, copy_ {r['copy_ms']:.4f} ms, "
                f"on {card}")
    for name, rows in keyword_widest.items():
        log(f"{name} at the keyword cell's widest shape {tuple(rows[0]['shape'])}: {rows[0]['ms']:.4f} ms "
            f"({100 * rows[0]['share_of_bound']:.1f}% of bound), on {card}")
    return report(args, card, kernels, paths=paths, keyword_widest=keyword_widest)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=3, help="query batches to serve (>= 3)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the database, keys and indices")
    parser.add_argument("--json-out", default=None, help="also write the full results to this file")
    parser.add_argument("--only", choices=["dim0", "simple_pir", "mesh", "ntt_mxu", "key_switch", "behz", "dim0_mac",
                                           "ntt", "mod_switch"],
                        default=None,
                        help="run one phase alone: dim0, the int8 dim-0 kernel at every served shape; "
                             "simple_pir, the SimplePIR cell; mesh, multi-device serving with gloo ranks; "
                             "ntt_mxu, the matrix NTT (SHE_TPU_NTT_MXU=1) on the MulPIR cells; key_switch, "
                             "the w32 and keyword cells and the key-switch kernels at their shapes; behz, the w32, "
                             "w64 and keyword cells and the BEHZ kernels at their shapes; dim0_mac, the w64, w32, "
                             "keyword and PNNS cells, dim0_mac and the expansion's leaf kernel at their shapes; ntt, the "
                             "w32 and w64 cells and the NTT kernels at their shapes; mod_switch, the w64, w32, keyword "
                             "and PNNS cells and the mod switch kernel at their shapes")
    args = parser.parse_args(argv)
    if args.batches < 3:
        parser.error("--batches must be at least 3")
    return args


def main() -> int:
    args = parse_args()
    try:
        return run(args)
    except Exception as exc:  # any failed phase: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
