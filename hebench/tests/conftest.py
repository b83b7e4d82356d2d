"""Tiny cells of both server kinds, runnable on the CPU.

`tiny_root` is a directory laid out as a checkout's benchmark: a copy of
hebench/'s configurations, traffic mixes, server kinds and metrics, two
tiny configurations and a tiny mix beside them, and a BENCHMARK.json that
names them with the repository's metrics. Its keyword cell is the keyword
configuration cut down and keeps its shapes at TINY_SEED (a cuckoo table's
size depends on its seed); its index MulPIR cell, at 64-bit words, is
written out whole, since BENCHMARK.json has no index configuration.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_SEED = 123456789012

KEYWORD_TINY = {
    "parameters": "insecure_n_8_logq_5x18_logt_5", "keywords": 60,
    "shape": {"degree": 8, "ciphertext_moduli_bits": [18, 18, 18, 18], "key_switch_modulus_bits": 18,
              "bucket_bytes": 12, "dimensions": [10, 4], "plaintexts": 240, "galois_keys": 3,
              "expanded_per_query": 28, "chunks": 3, "query_ciphertexts": 4, "indices": 2},
    "limits": {"noise_share": 0.0015},
}
MULPIR_TINY = {
    "name": "mulpir_tiny", "server": "mulpir", "parameters": "insecure_n_512_logq_4x60_logt_20", "scalar_bits": 64,
    "entries": 20000, "entry_bytes": 1, "dimension_count": 2, "key_compression": "noCompression",
    "dim0_form": "mac", "kernels": ["ntt", "key_switch", "behz", "dim0_mac"],
    "shape": {"degree": 512, "ciphertext_moduli_bits": [60, 60, 60], "key_switch_modulus_bits": 60,
              "dimensions": [9, 2], "plaintexts": 18, "galois_keys": 4, "expanded_per_query": 11,
              "chunks": 1, "query_ciphertexts": 1, "indices": 1},
    "limits": {"noise_share": 1e-6},
}
TRAFFIC_TINY = {"batch": 4, "pool_batches": 2, "absent_every": 2}


def tiny_config(base: str, name: str, changes: dict) -> dict:
    config = json.loads((REPO / "hebench" / "configs" / f"{base}.json").read_text())
    config.update({k: v for k, v in changes.items() if k != "shape"}, name=name)
    config["shape"] = dict(config["shape"], **changes["shape"])
    return config


def write_tiny_root(root: Path) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    dest = root / "hebench"
    for part in ("configs", "traffic", "servers", "metrics"):
        shutil.copytree(REPO / "hebench" / part, dest / part, ignore=shutil.ignore_patterns("__pycache__"))
    cells = {
        "keyword_tiny": tiny_config("keyword_1m_x_1B_w32", "keyword_tiny", KEYWORD_TINY),
        "mulpir_tiny": MULPIR_TINY,
    }
    for name, config in cells.items():
        (dest / "configs" / f"{name}.json").write_text(json.dumps(config, indent=1))
    (dest / "traffic" / "b4.json").write_text(json.dumps(TRAFFIC_TINY))
    bench["configs"] = [dict(name=n, source="test", file=f"hebench/configs/{n}.json", reduced=[], why="test")
                        for n in cells]
    bench["workloads"] = [dict(name=f"{n}.b4", config=n, traffic="b4", chips=1, why="test") for n in cells]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_tiny_root(tmp_path)


@pytest.fixture(autouse=True, scope="session")
def one_thread_a_worker():
    """One CPU thread a test process: several workers, each with a thread
    a core, slow each other's tensor work many times over."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
