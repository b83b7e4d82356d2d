"""Keyword PIR served in batches: she_tpu_torch's BatchedKeywordPirServer
over a cuckoo table made by process_database.process, one shard.

The configuration names the keyword count, key and value sizes, the cuckoo
table, the BFV parameters and the dim-0 form; the traffic names the batch,
how many batches the pool holds and how often a query asks for a keyword
that is not in the table.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from hebench import checks, inputs
from hebench.reference import pir as refpir


def keyword_rows(seed: int, count: int, value_bytes: int, absent: int):
    """`count` distinct 8-byte keywords with their values, and `absent`
    further distinct keywords that are not in the table."""
    rng = np.random.default_rng([seed, 3])
    raw = np.unique(rng.integers(0, 2**63 - 1, size=count + absent + 16, dtype=np.int64))
    raw = rng.permutation(raw)[: count + absent]
    if raw.size != count + absent:
        raise ValueError("too few distinct keywords drawn")
    blob = raw.astype(">u8").tobytes()
    keywords = [blob[8 * i : 8 * i + 8] for i in range(count + absent)]
    values = rng.integers(0, 256, size=count * value_bytes, dtype=np.uint8).tobytes()
    rows = {keywords[i]: values[i * value_bytes : (i + 1) * value_bytes] for i in range(count)}
    return rows, keywords[count:]


class Served:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        from she_tpu_torch import params as paramsmod
        from she_tpu_torch.bfv import bfv
        from she_tpu_torch.pir import index_pir as ip
        from she_tpu_torch.pir import keyword_pir as kp
        from she_tpu_torch.pir import process_database as pd
        from she_tpu_torch.pir import serving

        if config["key_bytes"] != 8:
            raise ValueError("keywords are drawn as 8-byte strings")
        batch, pool_batches = traffic["batch"], traffic["pool_batches"]
        absent_every = traffic["absent_every"]
        absent_count = pool_batches * (batch // absent_every)
        ep = paramsmod.from_predefined(config["parameters"], scalar_bits=config["scalar_bits"])
        self.context = ctx = bfv.get_bfv_context(ep, device)
        self.rows, absent = keyword_rows(seed, config["keywords"], config["value_bytes"], absent_count)
        cuckoo = config["cuckoo"]
        bucket_bytes = kp.default_max_serialized_bucket_size(config["value_bytes"], ep.bytes_per_plaintext)
        table = kp.CuckooTableConfig(
            hash_function_count=cuckoo["hash_functions"], max_eviction_count=cuckoo["max_evictions"],
            max_serialized_bucket_size=bucket_bytes,
            bucket_count=kp.CuckooBucketConfig("allowExpansion", cuckoo["expansion_factor"], cuckoo["load_factor"]),
        )
        keyword_config = kp.KeywordPirConfig(
            dimension_count=config["dimension_count"], cuckoo_table_config=table, uneven_dimensions=True,
            key_compression=ip.PirKeyCompression(config["key_compression"]),
        )
        arguments = pd.Arguments(pd.KeywordDatabaseConfig(kp.Sharding("shardCount", config["shards"]), keyword_config), ep)
        processed = pd.process(self.rows, arguments, rng=random.Random(seed), device=device)
        shard = processed.shards["0"]
        parameter = shard.pir_parameter
        got = dict(bucket_bytes=bucket_bytes, dimensions=list(parameter.dimensions),
                   plaintexts=shard.database.count, galois_keys=len(parameter.evaluation_key_config.galois_elements),
                   expanded_per_query=parameter.expanded_query_count * cuckoo["hash_functions"])
        self.shape_mismatch = {k: (v, config["shape"][k]) for k, v in got.items() if config["shape"][k] != v}
        log(f"keyword database: {len(self.rows)} keywords, {got}")

        self.secret = inputs.secret_bytes(seed, ctx.degree)
        sk = bfv.generate_secret_key(ctx, inputs.FixedBytes(self.secret))
        client = kp.KeywordPirClient(shard.keyword_pir_parameter, parameter, ctx)
        self.evaluation_key = client.generate_evaluation_key(sk, inputs.SeededBytes(seed))
        self.server = serving.BatchedKeywordPirServer(ctx, shard, use_dim0_int8=config["dim0_form"] == "int8")

        rng = np.random.default_rng([seed, 4])
        present = list(self.rows)
        unasked = iter(absent)
        # every absent_every-th query of a batch asks for a keyword not in the table
        self.intents = [
            [next(unasked) if i % absent_every == absent_every - 1 else present[int(rng.integers(0, len(present)))]
             for i in range(batch)]
            for _ in range(pool_batches)
        ]
        hashes = cuckoo["hash_functions"]
        total = parameter.expanded_query_count * hashes
        ones = [inputs.one_indices(client.index_client, kp.hash_indices(kw, parameter.entry_count, hashes))
                for kws in self.intents for kw in kws]
        flat = inputs.make_queries(ctx, sk, ones, total, hashes, seed)
        self.pool = [flat[b * batch : (b + 1) * batch] for b in range(pool_batches)]
        self.chunks = ip.chunk_count(parameter, ctx)
        self.q = ctx.ciphertext_context.moduli[0]
        self.t = ctx.plaintext_modulus
        self.degree = ctx.degree

    def serve(self, queries: list, on_stage=None) -> list:
        return self.server.compute_response_batch(queries, self.evaluation_key, on_stage)

    answer_tensor = staticmethod(checks.answer_tensor)

    def judge(self, pool_index: int, plain: torch.Tensor) -> list:
        """Per query of pool batch `pool_index`, whether its decrypted
        replies (int [B, R, N]) give the keyword's value, or nothing for an
        absent keyword."""
        out = []
        for kw, rows in zip(self.intents[pool_index], plain.cpu().numpy()):
            replies = [rows[h : h + self.chunks] for h in range(0, rows.shape[0], self.chunks)]
            out.append(refpir.keyword_value(replies, kw, self.t) == self.rows.get(kw))
        return out


def build(config: dict, traffic: dict, seed: int, device, log) -> Served:
    return Served(config, traffic, seed, device, log)
