"""The port's command-line tools (she_tpu_torch.cli) on the CPU, in
process, against she_tpu's (the port's side of test_tools.py's CLI tests).

Where a tool's output follows from its inputs, the files are compared with
she_tpu's tool's byte for byte: the generated keyword and PNNS databases,
the shards, the mmap dictionary, the processed PNNS database, and the
SimplePIR database, hint and parameters with a seed. The keyword PIR
processing draws its cuckoo table's randomness, so it is run and read
back, not compared. The warm tool runs at insecure sizes. Every tool that
computes takes --device and, with no card and none given, raises.
"""

import json

import numpy as np
import pytest
import torch

from she_tpu.cli import mmap_tool as jmmap_tool
from she_tpu.cli import pir_generate_database as jgen
from she_tpu.cli import pir_shard_database as jshard
from she_tpu.cli import pnns_generate_database as jpgen
from she_tpu.cli import pnns_process_database as jpproc
from she_tpu.cli import simple_pir_process_database as jspproc
from she_tpu_torch.cli import (mmap_tool, pir_generate_database, pir_process_database, pir_shard_database,
                               pnns_generate_database, pnns_process_database, simple_pir_process_database, warm)
from she_tpu_torch.cli.pir_generate_database import MersenneWords
from she_tpu_torch.io import mmap_dict, pb

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def _generate(tmp_path, name, *args):
    """The same database from both tools: (port's bytes, she_tpu's bytes)."""
    paths = (tmp_path / f"t-{name}.binpb", tmp_path / f"j-{name}.binpb")
    assert pir_generate_database.main(["--output-database", str(paths[0]), *args]) == 0
    assert jgen.main(["--output-database", str(paths[1]), *args]) == 0
    return paths


@pytest.mark.parametrize("args", [
    ["--row-count", "10", "--value-size", "1"],
    ["--row-count", "25", "--value-size", "0..40", "--first-keyword", "7"],
    ["--row-count", "12", "--value-size", "3..9", "--value-type", "repeated"],
    ["--row-count", "4", "--value-size", "300"],
])
def test_generate_database_equals_she_tpu(tmp_path, args):
    tpath, jpath = _generate(tmp_path, "db", *args)
    assert tpath.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 1), (0, 255), (3, 300), (4096, 4096)])
def test_mersenne_words_draw_pythons_values(lo, hi):
    import random

    rng, words = random.Random(5), MersenneWords(random.Random(5))
    for _ in range(20):
        size = rng.randint(lo, hi)
        assert lo + words.below(hi - lo + 1) == size
        assert words.bytes_below_256(size) == bytes(rng.randrange(256) for _ in range(size))


def test_shard_and_mmap_equal_she_tpu(tmp_path, capsys):
    tdb, _ = _generate(tmp_path, "db", "--row-count", "40", "--value-size", "1..6")
    for tool, prefix in ((pir_shard_database, "t"), (jshard, "j")):
        assert tool.main(["--input-database", str(tdb), "--output-database", str(tmp_path / f"{prefix}-SHARD_ID.binpb"),
                          "--shard-count", "3"]) == 0
    for shard in range(3):
        assert (tmp_path / f"t-{shard}.binpb").read_bytes() == (tmp_path / f"j-{shard}.binpb").read_bytes()
    for tool, prefix in ((mmap_tool, "t"), (jmmap_tool, "j")):
        assert tool.main(["dict", "--input-database", str(tdb), "--output", str(tmp_path / f"{prefix}.mmap")]) == 0
    assert (tmp_path / "t.mmap").read_bytes() == (tmp_path / "j.mmap").read_bytes()
    capsys.readouterr()
    outputs = []
    for tool, prefix in ((mmap_tool, "t"), (jmmap_tool, "j")):
        assert tool.main(["info", str(tmp_path / f"{prefix}.mmap")]) == 0
        assert tool.main(["get", str(tmp_path / f"{prefix}.mmap"), "13"]) == 0
        assert tool.main(["get", str(tmp_path / f"{prefix}.mmap"), "missing"]) == 1
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "entries: 40" in outputs[0]
    d = mmap_dict.MMapDictionary(str(tmp_path / "t.mmap"))
    db = pb.pir_pb2.KeywordDatabase.FromString(tdb.read_bytes())
    assert all(d.get(bytes(r.keyword)) == bytes(r.value) for r in db.rows)
    d.close()


@pytest.mark.parametrize("args", [["--row-count", "6", "--vector-dimension", "4"],
                                  ["--row-count", "5", "--vector-dimension", "3", "--vector-type", "unit",
                                   "--metadata-size", "7"]])
def test_pnns_generate_and_process_equal_she_tpu(tmp_path, args):
    for tool, prefix in ((pnns_generate_database, "t"), (jpgen, "j")):
        assert tool.main(["--output-database", str(tmp_path / f"{prefix}-pnns.binpb"), *args]) == 0
    assert (tmp_path / "t-pnns.binpb").read_bytes() == (tmp_path / "j-pnns.binpb").read_bytes()
    for tool, prefix, extra in ((pnns_process_database, "t", ["--device", "cpu"]), (jpproc, "j", [])):
        config = {"inputDatabase": str(tmp_path / "t-pnns.binpb"), "rlweParameters": PARAMS, "trialsPerShard": 1,
                  "outputDatabase": str(tmp_path / f"{prefix}-processed.binpb")}
        (tmp_path / f"{prefix}.json").write_text(json.dumps(config))
        assert tool.main([str(tmp_path / f"{prefix}.json"), *extra]) == 0
    assert (tmp_path / "t-processed.binpb").read_bytes() == (tmp_path / "j-processed.binpb").read_bytes()


@pytest.mark.parametrize("p,b,n,rows,size", [(4, 16, 16, 8, 2), (9, 21, 16, 30, 40), (9, 40, 32, 11, 7)])
def test_simple_pir_process_database_equals_she_tpu(tmp_path, p, b, n, rows, size):
    tdb, _ = _generate(tmp_path, "spir", "--row-count", str(rows), "--value-size", str(size))
    for tool, prefix, extra in ((simple_pir_process_database, "t", ["--device", "cpu"]), (jspproc, "j", [])):
        config = {"inputDatabase": str(tdb), "outputDatabase": str(tmp_path / f"{prefix}-db.npy"),
                  "outputHint": str(tmp_path / f"{prefix}-hint.npy"),
                  "outputParameters": str(tmp_path / f"{prefix}-params.binpb"),
                  "plaintextModulusBits": p, "ciphertextModulusBits": b, "latticeDimension": n,
                  "securityLevel": "unchecked", "seed": bytes(range(32)).hex()}
        (tmp_path / f"{prefix}.json").write_text(json.dumps(config))
        assert tool.main([str(tmp_path / f"{prefix}.json"), *extra]) == 0
    for name in ("db.npy", "hint.npy", "params.binpb"):
        assert (tmp_path / f"t-{name}").read_bytes() == (tmp_path / f"j-{name}").read_bytes(), name
    assert np.load(tmp_path / "t-hint.npy").shape[1] == n


def test_pir_pipeline(tmp_path, capsys):
    tdb, _ = _generate(tmp_path, "db", "--row-count", "10", "--value-size", "1")
    config = {
        "inputDatabase": str(tdb),
        "outputDatabase": str(tmp_path / "processed-SHARD_ID.bin"),
        "outputPirParameters": str(tmp_path / "params-SHARD_ID.binpb"),
        "outputEvaluationKeyConfig": str(tmp_path / "ekconfig.binpb"),
        "rlweParameters": PARAMS,
        "sharding": {"shardCount": 2},
        "trialsPerShard": 1,
    }
    (tmp_path / "config.json").write_text(json.dumps(config))
    assert pir_process_database.main([str(tmp_path / "config.json"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("noiseBudget") == 2
    for shard in range(2):
        assert (tmp_path / f"processed-{shard}.bin").stat().st_size > 0
        params = pb.pir_pb2.PirParameters.FromString((tmp_path / f"params-{shard}.binpb").read_bytes())
        assert params.num_entries > 0
    assert pb.he_pb2.EvaluationKeyConfig.FromString((tmp_path / "ekconfig.binpb").read_bytes()).has_relin_key


@pytest.mark.parametrize("argv", [
    ["pir", "--params", PARAMS, "--scalar-bits", "32", "--entries", "200", "--entry-size", "3", "--batch", "3"],
    ["pir", "--params", "insecure_n_512_logq_4x60_logt_20", "--scalar-bits", "64", "--entries", "200",
     "--entry-size", "3", "--batch", "2"],
    ["pnns", "--params", PARAMS, "--scalar-bits", "32", "--rows", "6", "--dim", "4", "--batch", "2"],
], ids=["pir_w32", "pir_w64", "pnns"])
def test_warm(argv):
    assert warm.main([*argv, "--device", "cpu"]) == 0


def test_tools_need_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    tdb, _ = _generate(tmp_path, "spir", "--row-count", "4", "--value-size", "2")
    config = {"inputDatabase": str(tdb), "outputDatabase": str(tmp_path / "db.npy"),
              "outputHint": str(tmp_path / "hint.npy"), "outputParameters": str(tmp_path / "p.binpb"),
              "plaintextModulusBits": 4, "ciphertextModulusBits": 16, "latticeDimension": 16,
              "securityLevel": "unchecked"}
    (tmp_path / "s.json").write_text(json.dumps(config))
    with pytest.raises(RuntimeError):
        simple_pir_process_database.main([str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError):
        warm.main(["pnns", "--params", PARAMS, "--scalar-bits", "32", "--rows", "4", "--dim", "2", "--batch", "1"])
