"""The port's synthetic models against the JAX package's, and on its Engine.

make_synthetic_llama builds the weights of chip_smoke.py's main path; here
the `tiny` preset checks on the CPU that its layout carries the reference's
byte counts (the decode roofline's numerator) and that it runs end to end.
"""
import pytest
import torch

from llamafile_tpu.models import synthetic as JS
from llamafile_tpu_torch.models import synthetic as TS
from llamafile_tpu_torch.runtime.engine import Engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams
from llamafile_tpu_torch.runtime.tokenizer import Tokenizer


@pytest.mark.parametrize("fuse", [False, True])
def test_byte_counts_match_reference(fuse):
    jcfg, jparams = JS.make_synthetic_llama("tiny", "Q4_K", seed=0, fuse=fuse)
    cfg, params = TS.make_synthetic_llama("tiny", "Q4_K", seed=0, fuse=fuse,
                                          device="cpu")
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    assert TS.param_bytes(params) == JS.param_bytes(jparams)
    assert TS.decode_read_bytes(params, cfg) == JS.decode_read_bytes(jparams, jcfg)


@pytest.mark.parametrize("quant", ["Q8_0", "Q6_K"])
def test_int8_byte_counts_match_reference(quant):
    """int8-stored synthetic weights (g 32 for Q8_0, 16 for Q6_K) carry the
    reference's layout and byte counts, and the fused model concatenates
    (not interleaves) its gate|up."""
    jcfg, jparams = JS.make_synthetic_llama("tiny", quant, seed=0, fuse=True)
    cfg, params = TS.make_synthetic_llama("tiny", quant, seed=0, fuse=True,
                                          device="cpu")
    assert TS.param_bytes(params) == JS.param_bytes(jparams)
    assert TS.decode_read_bytes(params, cfg) == JS.decode_read_bytes(jparams, jcfg)
    l0 = params.layers[0]
    assert (l0.wqkv.kind, l0.wqkv.g) == ("q8b", 16 if quant == "Q6_K" else 32)
    assert l0.wqkv.qs.dtype == torch.int8 and l0.wqkv.bias is None
    assert not l0.w_gate_up.il and l0.w_gate_up.shape == (2 * cfg.d_ff, cfg.d_model)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=256, device="cpu")
    ids = [t for t, _ in eng.generate("", max_tokens=4,
                                      sampling=SamplingParams(temperature=0.0),
                                      stop_on_eog=False, prompt_ids=list(range(3, 140)))]
    assert len(ids) == 4 and all(0 <= t < cfg.n_vocab for t in ids)


def test_fused_model_generates_on_the_cpu():
    """Greedy generation through Engine on the fused, stacked tiny model:
    the tokens are in range and the same on a second run."""
    cfg, params = TS.make_synthetic_llama("tiny", "Q4_K", seed=1, fuse=True,
                                          device="cpu")
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=256, device="cpu")
    prompt = [5, 17, 300, 41, 9, 1000, 2]
    runs = [[t for t, _ in eng.generate("", max_tokens=12,
                                        sampling=SamplingParams(temperature=0.0),
                                        stop_on_eog=False, prompt_ids=prompt)]
            for _ in range(2)]
    assert len(runs[0]) == 12
    assert all(0 <= t < cfg.n_vocab for t in runs[0])
    assert runs[0] == runs[1]


def test_cuda_model_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        TS.make_synthetic_llama("tiny", device="cuda")


def _q4b_bytes(ns: int, k: int) -> int:
    """A q4b tensor of storage width ns over depth k: packed nibbles, then
    bf16 scales and biases per 32."""
    return k // 2 * ns + 2 * (k // 32 * ns * 2)


@pytest.mark.parametrize("preset,n_layers", [("llama3.2-3b", 28), ("llama3.2-3b-2l", 2)])
def test_llama32_3b_shapes_and_read_bytes(preset, n_layers):
    """Llama-3.2-3B's published widths (a head group of 3), fused, on the
    meta device (the layout with no data): the config, every weight's shape,
    and decode_read_bytes against a count from the storage layout (storage
    N padded to 2048 in each unfused matrix, the fused q|k|v concatenated
    unpadded, the fused gate|up 2 d_ff wide)."""
    cfg, params = TS.make_synthetic_llama(preset, "Q4_K", fuse=True, device="meta")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.n_vocab, cfg.rope_theta) == (n_layers, 3072, 24, 8, 128, 8192,
                                                       128256, 500000.0)
    assert cfg.n_heads // cfg.n_kv_heads == 3
    assert len(params.layers) == n_layers and params.tok_embd.shape == (128256, 3072)
    for layer in params.layers:
        assert layer.wq is None and layer.w_gate is None
        assert layer.wqkv.shape == (5120, 3072) and layer.wqkv.qs.shape == (1536, 5120)
        assert layer.wo.shape == (3072, 3072) and layer.wo.qs.shape == (1536, 4096)
        assert layer.w_gate_up.shape == (16384, 3072) and layer.w_gate_up.il
        assert layer.w_down.shape == (3072, 8192) and layer.w_down.qs.shape == (4096, 4096)
    assert params.output.shape == (128256, 3072) and params.output.qs.shape == (1536, 129024)
    per_layer = (_q4b_bytes(5120, 3072) + _q4b_bytes(4096, 3072) + _q4b_bytes(16384, 3072)
                 + _q4b_bytes(4096, 8192) + 2 * 3072 * 4)
    want = n_layers * per_layer + _q4b_bytes(129024, 3072) + 3072 * 4
    assert TS.decode_read_bytes(params, cfg) == want
    assert TS.param_bytes(params) == want + 128256 * 3072 * 2


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_meta_layout_matches_cpu_build(preset):
    """The meta device's layout carries the bytes of a built model."""
    for fuse in (False, True):
        cfg, meta = TS.make_synthetic_llama(preset, "Q4_K", fuse=fuse, device="meta")
        _, cpu = TS.make_synthetic_llama(preset, "Q4_K", fuse=fuse, device="cpu")
        assert TS.param_bytes(meta) == TS.param_bytes(cpu)
        assert TS.decode_read_bytes(meta, cfg) == TS.decode_read_bytes(cpu, cfg)
