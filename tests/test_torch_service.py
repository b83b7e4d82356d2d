"""The PIR service envelope across the two packages, in bytes (mirrors
tests/test_service.py).

she_tpu and the port process the same keyword rows into the same shards;
each package's PirService serves them. Every request is serialized by one
package and answered by the other's service, and the answer is parsed back
from bytes: config requests, evaluation-key uploads, PIR requests (present
and absent keywords) and OPRF requests. Where both services answer the same
request deterministically, their answers are the same bytes.
"""

import random

import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.io import pb as jpb
from she_tpu.io import proto_conversion as jpc
from she_tpu.pir import keyword_pir as jkp
from she_tpu.pir import oprf as joprf
from she_tpu.pir import process_database as jpd
from she_tpu.pir import service as jsvc
from she_tpu.pir import symmetric_pir as jspir
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.io import pb as tpb
from she_tpu_torch.io import proto_conversion as tpc
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.pir import oprf as toprf
from she_tpu_torch.pir import process_database as tpd
from she_tpu_torch.pir import service as tsvc
from she_tpu_torch.pir import symmetric_pir as tspir
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"
USECASE = "test-db"


def _bytes(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


@pytest.fixture(scope="module")
def services():
    tep, jep = tparams.from_predefined(PARAMS, 32), jparams.from_predefined(PARAMS, 32)
    tctx, jctx = tbfv.get_bfv_context(tep, device="cpu"), jbfv.get_bfv_context(jep)
    rows = {f"kw{i}".encode(): bytes([i]) for i in range(8)}
    bucket = tkp.default_max_serialized_bucket_size(1, tep.bytes_per_plaintext)
    targs = tpd.Arguments(tpd.KeywordDatabaseConfig(
        tkp.Sharding("shardCount", 2), tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(bucket))),
        tep, trials_per_shard=0)
    jargs = jpd.Arguments(jpd.KeywordDatabaseConfig(
        jkp.Sharding("shardCount", 2), jkp.KeywordPirConfig(2, jkp.CuckooTableConfig.default_keyword_pir(bucket))),
        jep, trials_per_shard=0)
    tprocessed = tpd.process(rows, targs, rng=random.Random(5), device="cpu")
    jprocessed = jpd.process(rows, jargs, rng=random.Random(5))
    tservice, jservice = tsvc.PirService(), jsvc.PirService()
    tservice.add_keyword_pir_usecase(USECASE, tctx, tprocessed)
    jservice.add_keyword_pir_usecase(USECASE, jctx, jprocessed)
    return dict(tctx=tctx, jctx=jctx, rows=rows, tprocessed=tprocessed, jprocessed=jprocessed,
                tservice=tservice, jservice=jservice)


def _config(service, usecases=()):
    request = tpb.api_pb2.ConfigRequest()
    request.usecases.extend(usecases)
    return service.handle_config_request(jpb.api_pb2.ConfigRequest.FromString(_bytes(request)))


def test_config_request_answers_match(services):
    got = _bytes(_config(services["tservice"], [USECASE]))
    assert got == _bytes(_config(services["jservice"], [USECASE]))
    response = tpb.api_pb2.ConfigResponse.FromString(got)
    config = response.configs[USECASE]
    assert len(config.pir_config.shard_configs) == len(services["tprocessed"].shards) == 2
    assert config.pir_config.keyword_pir_params.num_hash_functions == 2
    assert len(config.config_id) == 32
    assert _bytes(_config(services["tservice"])) == got  # no usecases: all of them
    assert not _config(services["tservice"], ["unknown"]).configs


def _keys_message(ek, identifier: bytes, timestamp: int, pc, pb):
    msg = pb.api_shared_pb2.EvaluationKeys()
    entry = msg.keys.add()
    entry.metadata.timestamp = timestamp
    entry.metadata.identifier = identifier
    entry.evaluation_key.CopyFrom(pc.evaluation_key_to_proto(ek))
    return _bytes(msg)


def _request_bytes(query, config_hash: bytes, shard_id: str, identifier: bytes, pc, pb) -> bytes:
    request = pb.api_pir_pb2.PIRRequest()
    request.query.CopyFrom(pc.pir_query_to_proto(query))
    request.evaluation_key_metadata.identifier = identifier
    request.configuration_hash = config_hash
    request.shard_id = shard_id
    return _bytes(request)


def test_she_tpu_requests_answered_by_the_port(services):
    """she_tpu's client uploads its key and sends its requests as bytes; the
    port's service answers them with she_tpu's service's bytes, and
    she_tpu's client decrypts the port's answers."""
    jctx, rows = services["jctx"], services["rows"]
    config_hash = bytes(_config(services["tservice"]).configs[USECASE].config_id)
    jsk = jbfv.generate_secret_key(jctx, jrng(b"s" * 32))
    shard0 = services["jprocessed"].shards["0"]
    jclient = jkp.KeywordPirClient(shard0.keyword_pir_parameter, shard0.pir_parameter, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng(b"k" * 32))
    keys = _keys_message(jek, b"client-1", 123, jpc, jpb)
    services["tservice"].store_evaluation_keys(tpb.api_shared_pb2.EvaluationKeys.FromString(keys), services["tctx"])
    services["jservice"].store_evaluation_keys(jpb.api_shared_pb2.EvaluationKeys.FromString(keys), jctx)
    status = _config(services["tservice"]).key_info
    assert [s.timestamp for s in status] == [123]
    for keyword in (b"kw3", b"kw6", b"absent"):
        shard_id = str(jkp.shard_index_sha256(keyword, 2))
        shard = services["jprocessed"].shards[shard_id]
        client = jkp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, jctx)
        raw = _request_bytes(client.generate_query(keyword, jsk), config_hash, shard_id, b"client-1", jpc, jpb)
        answer = _bytes(services["tservice"].handle_pir_request(USECASE, tpb.api_pir_pb2.PIRRequest.FromString(raw)))
        assert answer == _bytes(services["jservice"].handle_pir_request(
            USECASE, jpb.api_pir_pb2.PIRRequest.FromString(raw)))
        replies = list(jpb.api_pir_pb2.PIRResponse.FromString(answer).replies)
        assert client.decrypt(jpc.pir_response_from_proto(replies, jctx), keyword, jsk) == rows.get(keyword)


def test_port_requests_answered_by_she_tpu(services):
    """The port's client sends its evaluation key inside the request; she_tpu's
    service answers, and the port's client decrypts."""
    tctx, rows = services["tctx"], services["rows"]
    config_hash = bytes(jpb.api_pb2.ConfigResponse.FromString(
        _bytes(_config(services["jservice"], [USECASE]))).configs[USECASE].config_id)
    tsk = tbfv.generate_secret_key(tctx, trng(b"t" * 32))
    keyword = b"kw5"
    shard_id = str(tkp.shard_index_sha256(keyword, 2))
    shard = services["tprocessed"].shards[shard_id]
    client = tkp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, tctx)
    request = tpb.api_pir_pb2.PIRRequest.FromString(
        _request_bytes(client.generate_query(keyword, tsk), config_hash, shard_id, b"unknown", tpc, tpb))
    request.evaluation_key.evaluation_key.CopyFrom(
        tpc.evaluation_key_to_proto(client.generate_evaluation_key(tsk, trng(b"u" * 32))))
    raw = _bytes(request)
    answer = _bytes(services["jservice"].handle_pir_request(USECASE, jpb.api_pir_pb2.PIRRequest.FromString(raw)))
    assert answer == _bytes(services["tservice"].handle_pir_request(
        USECASE, tpb.api_pir_pb2.PIRRequest.FromString(raw)))
    replies = list(tpb.api_pir_pb2.PIRResponse.FromString(answer).replies)
    assert client.decrypt(tpc.pir_response_from_proto(replies, tctx), keyword, tsk) == rows[keyword]


def test_pir_request_refusals(services):
    service = services["tservice"]
    request = tpb.api_pir_pb2.PIRRequest()
    request.configuration_hash = b"\x00" * 32
    with pytest.raises(errors.PirError, match="hash"):
        service.handle_pir_request(USECASE, request)
    with pytest.raises(errors.PirError, match="usecase"):
        service.handle_pir_request("unknown", request)
    request.configuration_hash = bytes(_config(service).configs[USECASE].config_id)
    request.evaluation_key_metadata.identifier = b"nobody"
    with pytest.raises(errors.PirError, match="evaluation key"):
        service.handle_pir_request(USECASE, request)


def test_oprf_requests_across_packages():
    key = bytes(47) + b"\x05"
    tservice, jservice = tsvc.PirService(), jsvc.PirService()
    tservice.add_oprf_usecase(b"cfg1", tspir.SymmetricPirConfig(key))
    jservice.add_oprf_usecase(b"cfg1", jspir.SymmetricPirConfig(key))
    for client, service, pb, oprf in (
        (jspir.OprfClient(jspir.SymmetricPirConfig(key).client_config()), tservice, tpb, toprf),
        (tspir.OprfClient(tspir.SymmetricPirConfig(key).client_config()), jservice, jpb, joprf),
    ):
        context = client.query_context(b"keyword")
        request = pb.api_pir_pb2.OPRFRequest()
        request.query_element = context.query
        request.config_id = b"cfg1"
        raw = _bytes(service.handle_oprf_request(pb.api_pir_pb2.OPRFRequest.FromString(_bytes(request))))
        response = pb.api_pir_pb2.OPRFResponse.FromString(raw)
        parsed = client.parse(oprf.BlindEvaluation(bytes(response.evaluated_element), bytes(response.proof)),
                              context)
        assert parsed.oblivious_keyword == tspir.ParsedOprfOutput.parse(
            toprf.OprfPrivateKey(key).evaluate(b"keyword"), tspir.SymmetricPirConfigType(
                "OPRF_P384_AES_GCM_192_NONCE_96_TAG_128")).oblivious_keyword
    request = tpb.api_pir_pb2.OPRFRequest()
    request.config_id = b"other"
    with pytest.raises(errors.PirError):
        tservice.handle_oprf_request(request)
    assert len(tspir.SymmetricPirConfig(key).client_config().server_public_key) == 49


@pytest.mark.parametrize("trials", [1, 2])
def test_validate_shard_sizes_match_she_tpu(services, trials):
    """process_database.validate_shard: the serialized sizes of the
    evaluation key, query and response equal she_tpu's for the same shard,
    and every trial decrypts the row with budget to spare."""
    shard_id, tshard = next(iter(services["tprocessed"].shards.items()))
    jshard = services["jprocessed"].shards[shard_id]
    row = next((kw, v) for kw, v in services["rows"].items()
               if str(tkp.shard_index_sha256(kw, 2)) == shard_id)
    got = tpd.validate_shard(tshard, row, trials, services["tctx"], rng=trng(bytes(range(32))))
    want = jpd.validate_shard(jshard, row, 1, services["jctx"])
    assert (got.evaluation_key_size, got.query_size, got.response_size) == (
        want.evaluation_key_size, want.query_size, want.response_size)
    assert got.noise_budget > 0 and len(got.compute_times) == trials
    with pytest.raises(errors.PirError):
        tpd.validate_shard(tshard, row, 0, services["tctx"])
    with pytest.raises(errors.PirError):
        tpd.validate_shard(tshard, (row[0], b"\xff\xff"), 1, services["tctx"])
