"""Falcon through the port, against the JAX package, on the CPU: the
shared tests of tests/test_torch_ln_archs.py with this file's `arch`
variants, falcon (7B-style: 4 query heads over 1 KV head, the fused qkv,
one norm with its bias feeding attention and FFN under the parallel
residual) and falcon-40b (40B-style: 4 over 2, an FFN norm with its bias).
The tolerances and what is held are that file's."""
import pytest

from tests.test_torch_ln_archs import (  # noqa: F401
    _one_torch_thread, files, jax_refs, test_ln_carried_weights_equal_loaded,
    test_ln_config_matches_jax, test_ln_decode_matches_jax, test_ln_engine_and_cli_match_jax,
    test_ln_paged_decode_matches_jax, test_ln_prefill_matches_jax,
    test_ln_served_alone_and_beside_others)


@pytest.fixture(scope="module", params=["falcon", "falcon-40b"])
def arch(request):
    return request.param
