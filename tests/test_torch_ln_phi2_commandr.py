"""Phi-2 and Command-R through the port, against the JAX package, on the
CPU: the shared tests of tests/test_torch_ln_archs.py with this file's
`arch` variants (phi2: head_dim 80, rope on 32 of its dims, a shared norm,
the head's bias, Q8_0 as its quantized type; command-r: SwiGLU, LayerNorm
without bias, a shared norm, interleaved rope, logit_scale 0.0625). The
tolerances and what is held are that file's."""
import pytest

from tests.test_torch_ln_archs import (  # noqa: F401
    _one_torch_thread, files, jax_refs, test_ln_carried_weights_equal_loaded,
    test_ln_config_matches_jax, test_ln_decode_matches_jax, test_ln_engine_and_cli_match_jax,
    test_ln_paged_decode_matches_jax, test_ln_prefill_matches_jax,
    test_ln_served_alone_and_beside_others)


@pytest.fixture(scope="module", params=["phi2", "command-r"])
def arch(request):
    return request.param
