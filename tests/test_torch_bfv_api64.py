"""test_torch_bfv_api.py's tests at insecure_n_512_logq_4x60_logt_20,
64-bit scalars: 60-bit moduli, so every modular product of the port takes
the exact wide route (ops/wide.py) and she_tpu its two-limb words; t =
525313 = 1 mod 1024 gives SIMD slots at N = 512. ct_mul_relin is left to the 32-bit file:
its parts at 64 bits, ct_mul and relinearize, are held to she_tpu in
test_torch_bfv64.py, and the operators' ct * ct here."""

import pytest

from test_torch_bfv_api import (  # noqa: F401  (the tests, collected here with this file's env)
    make_env,
    test_ciphertext_operators_match,
    test_ct_mul_pt_simd,
    test_ct_neg_and_plaintext_add_sub,
    test_encode_decode_match,
    test_encode_decode_signed_match,
    test_encode_simd_batch_equals_single_encodes,
    test_error_types,
    test_is_transparent,
    test_plaintext_to_eval_moduli_count,
    test_rotate_columns_match,
    test_simd_matrix_and_dimensions,
    test_swap_rows_match,
)


@pytest.fixture(scope="module")
def env():
    return make_env("insecure_n_512_logq_4x60_logt_20", 64)
