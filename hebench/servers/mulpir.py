"""Index PIR (MulPIR) served in batches: she_tpu_torch's
BatchedMulPirServer over a database of random entries processed by
MulPirServer.process.

The configuration names the entry count and size, the BFV parameters and
the dim-0 form; the traffic names the batch and how many batches the pool
holds. Each query asks for one entry, drawn uniformly.
"""

from __future__ import annotations

import numpy as np
import torch

from hebench import checks, inputs
from hebench.reference import pir as refpir


class Served:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        from she_tpu_torch import params as paramsmod
        from she_tpu_torch.bfv import bfv
        from she_tpu_torch.pir import index_pir as ip
        from she_tpu_torch.pir import serving

        batch, pool_batches = traffic["batch"], traffic["pool_batches"]
        ep = paramsmod.from_predefined(config["parameters"], scalar_bits=config["scalar_bits"])
        self.context = ctx = bfv.get_bfv_context(ep, device)
        index_config = ip.IndexPirConfig(
            entry_count=config["entries"], entry_size_in_bytes=config["entry_bytes"],
            dimension_count=config["dimension_count"], batch_size=1, uneven_dimensions=True,
            key_compression=ip.PirKeyCompression(config["key_compression"]),
        )
        parameter = ip.generate_parameter(index_config, ctx)
        rng = np.random.default_rng([seed, 3])
        self.database = rng.integers(0, 256, size=(config["entries"], config["entry_bytes"]), dtype=np.uint8)
        processed = ip.MulPirServer.process(self.database, ctx, parameter)
        got = dict(dimensions=list(parameter.dimensions), plaintexts=processed.count,
                   galois_keys=len(parameter.evaluation_key_config.galois_elements),
                   expanded_per_query=parameter.expanded_query_count)
        self.shape_mismatch = {k: (v, config["shape"][k]) for k, v in got.items() if config["shape"][k] != v}
        log(f"index database: {config['entries']} x {config['entry_bytes']} B, {got}")

        self.secret = inputs.secret_bytes(seed, ctx.degree)
        sk = bfv.generate_secret_key(ctx, inputs.FixedBytes(self.secret))
        client = ip.MulPirClient(parameter, ctx)
        self.evaluation_key = client.generate_evaluation_key(sk, inputs.SeededBytes(seed))
        self.server = serving.BatchedMulPirServer(parameter, ctx, [processed],
                                                  use_dim0_int8=config["dim0_form"] == "int8")

        picks = np.random.default_rng([seed, 4]).integers(0, config["entries"], size=(pool_batches, batch))
        self.intents = [[int(i) for i in row] for row in picks]
        ones = [inputs.one_indices(client, [i]) for row in self.intents for i in row]
        flat = inputs.make_queries(ctx, sk, ones, parameter.expanded_query_count, 1, seed)
        self.pool = [flat[b * batch : (b + 1) * batch] for b in range(pool_batches)]
        self.q = ctx.ciphertext_context.moduli[0]
        self.t = ctx.plaintext_modulus
        self.degree = ctx.degree

    def serve(self, queries: list, on_stage=None) -> list:
        return self.server.compute_response_batch(queries, self.evaluation_key, on_stage)

    answer_tensor = staticmethod(checks.answer_tensor)

    def judge(self, pool_index: int, plain: torch.Tensor) -> list:
        """Per query of pool batch `pool_index`, whether its decrypted reply
        (int [B, 1, N]) is the plaintext that holds its entry."""
        if plain.shape[1] != 1:
            raise ValueError("entries larger than a plaintext are not judged")
        got = plain[:, 0].cpu().numpy()
        return [bool(np.array_equal(row, refpir.index_plaintext(self.database, index, self.degree, self.t)))
                for index, row in zip(self.intents[pool_index], got)]


def build(config: dict, traffic: dict, seed: int, device, log) -> Served:
    return Served(config, traffic, seed, device, log)
