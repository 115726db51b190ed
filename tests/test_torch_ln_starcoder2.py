"""StarCoder2 through the port, against the JAX package, on the CPU: the
shared tests of tests/test_torch_ln_archs.py with this file's `arch`
(starcoder2: separate q/k/v, every bias, the sequential residual, full
rope; phi2 and command-r are in tests/test_torch_ln_phi2_commandr.py). The
tolerances and what is held are that file's; here also, on starcoder2's
F32 file, the HTTP server at 2 slots (texts together equal to texts alone)
and the embeddings against the JAX package's within 1e-3."""
import concurrent.futures as cf

import numpy as np
import pytest

from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.server.embed import llama_embed_many
from llamafile_tpu_torch.server.http import Server
from llamafile_tpu_torch.utils.flags import Flags
from tests.test_torch_embed import TEXTS
from tests.test_torch_gemma import _complete
from tests.test_torch_q4km import _interpreted
from tests.test_torch_server import _start
from tests.test_torch_ln_archs import ARCHS, MAX_LEN, make_tiny_ln_gguf
from tests.test_torch_ln_archs import (  # noqa: F401
    _one_torch_thread, files, jax_refs, test_ln_carried_weights_equal_loaded,
    test_ln_config_matches_jax, test_ln_decode_matches_jax, test_ln_engine_and_cli_match_jax,
    test_ln_paged_decode_matches_jax, test_ln_prefill_matches_jax,
    test_ln_served_alone_and_beside_others)


@pytest.fixture(scope="module", params=["starcoder2"])
def arch(request):
    return request.param


EMBED_TOL = 1e-3


@pytest.fixture(scope="module")
def starcoder2_f32(tmp_path_factory):
    return make_tiny_ln_gguf(str(tmp_path_factory.mktemp("sc2") / "tiny-starcoder2-F32.gguf"),
                             "starcoder2", "F32")


def test_ln_http_server_alone_and_together(starcoder2_f32):
    """The port's HTTP server (the --server path, in process) at 2 slots
    on a starcoder2 GGUF: two greedy completions sent at once give the
    texts each gives sent alone."""
    eng = load_engine(starcoder2_f32, device="cpu", max_seq_len=MAX_LEN)
    srv = Server(Flags(model="tiny-starcoder2.gguf", slots=2, temp=0.0, device="cpu"), eng)
    base, loop = _start(srv)
    try:
        prompts = ["hello", "the quick brown fox"]
        with cf.ThreadPoolExecutor(2) as ex:
            together = list(ex.map(lambda p: _complete(base, p), prompts))
        alone = [_complete(base, p) for p in prompts]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
    assert together == alone and all(alone)


def test_ln_embeddings_match_jax(starcoder2_f32):
    """/v1/embeddings' llama_embed_many (a fresh prefill's hidden states
    through the output LayerNorm with its bias, masked mean, unit length)
    against the JAX package's, within EMBED_TOL (max abs; the port's
    embeddings limit)."""
    from llamafile_tpu.server.embed import llama_embed_many as j_embed_many

    def run():
        cfg, params, tok, _ = j_load_llama(starcoder2_f32)
        return np.asarray(j_embed_many(JEngine(cfg, params, tok, max_seq_len=MAX_LEN))(TEXTS))
    want = _interpreted(run)
    got = np.asarray(llama_embed_many(load_engine(starcoder2_f32, device="cpu",
                                                  max_seq_len=MAX_LEN))(TEXTS))
    assert got.shape == want.shape == (len(TEXTS), ARCHS["starcoder2"]["d"])
    assert np.abs(got - want).max() <= EMBED_TOL
