"""The port's synthetic models against the JAX package's, and on its Engine.

make_synthetic_llama builds the weights of chip_smoke.py's main path; here
the `tiny` preset checks on the CPU that its layout carries the reference's
byte counts (the decode roofline's numerator) and that it runs end to end.
"""
import pytest
import torch

from llamafile_tpu.models import synthetic as JS
from llamafile_tpu_torch.models import llama as TL
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


def _q8b_bytes(ns: int, k: int, g: int) -> int:
    """A q8b tensor: int8 codes, then bf16 scales per g."""
    return k * ns + k // g * ns * 2


@pytest.mark.parametrize("preset,n_layers", [("gemma-2-9b", 42), ("gemma-2-9b-2l", 2)])
def test_gemma2_9b_shapes_and_read_bytes(preset, n_layers):
    """Gemma-2-9B's published widths with the gemma2 features, fused, on the
    meta device: the config, every weight's shape (q 4096 wide over d 3584:
    head_dim 256 is not d / h), the post norms, the Q6_K head, and
    decode_read_bytes from the storage layout (o and down padded from 3584
    to 4096 columns)."""
    cfg, params = TS.make_synthetic_llama(preset, "Q4_K", fuse=True, device="meta")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.n_vocab, cfg.rms_eps, cfg.max_context) == (
        n_layers, 3584, 16, 8, 256, 14336, 256000, 1e-6, 8192)
    assert (cfg.swa_window, cfg.swa_pattern, cfg.attn_softcap, cfg.final_softcap) == (
        4096, 2, 50.0, 30.0)
    assert cfg.rope_neox and cfg.ffn_gelu and cfg.post_norms and cfg.embd_scale == 3584 ** 0.5
    for layer in params.layers:
        assert layer.wqkv.shape == (8192, 3584) and layer.wqkv.qs.shape == (1792, 8192)
        assert layer.wo.shape == (3584, 4096) and layer.wo.qs.shape == (2048, 4096)
        assert layer.w_gate_up.shape == (28672, 3584) and layer.w_gate_up.il
        assert layer.w_down.shape == (3584, 14336) and layer.w_down.qs.shape == (7168, 4096)
        assert layer.attn_post_norm.shape == layer.ffn_post_norm.shape == (3584,)
    assert params.output.kind == "q8b" and params.output.g == 16
    assert params.output.qs.shape == (3584, 256000)
    per_layer = (_q4b_bytes(8192, 3584) + _q4b_bytes(4096, 4096) + _q4b_bytes(28672, 3584)
                 + _q4b_bytes(4096, 14336) + 4 * 3584 * 4)
    want = n_layers * per_layer + _q8b_bytes(256000, 3584, 16) + 3584 * 4
    assert TS.decode_read_bytes(params, cfg) == want


@pytest.mark.parametrize("preset,n_layers", [("gemma-7b", 28), ("gemma-7b-2l", 2)])
def test_gemma_7b_shapes_and_read_bytes(preset, n_layers):
    """Gemma-7B's published widths with the gemma branches, fused, on the
    meta device: 16 query heads over 16 KV heads of head_dim 256 (q, k and
    v each 4096 wide over d 3072), no window, softcap or post norms, the
    Q6_K head; o and down padded from 3072 to 4096 columns."""
    cfg, params = TS.make_synthetic_llama(preset, "Q4_K", fuse=True, device="meta")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.n_vocab, cfg.rms_eps, cfg.max_context) == (
        n_layers, 3072, 16, 16, 256, 24576, 256000, 1e-6, 8192)
    assert cfg.rope_neox and cfg.ffn_gelu and cfg.embd_scale == 3072 ** 0.5
    assert (cfg.swa_window, cfg.attn_softcap, cfg.post_norms, cfg.qk_norm) == (0, 0.0, False,
                                                                              False)
    for layer in params.layers:
        assert layer.wqkv.shape == (12288, 3072) and layer.wqkv.qs.shape == (1536, 12288)
        assert layer.wo.shape == (3072, 4096) and layer.wo.qs.shape == (2048, 4096)
        assert layer.w_gate_up.shape == (49152, 3072) and layer.w_gate_up.il
        assert layer.w_down.shape == (3072, 24576) and layer.w_down.qs.shape == (12288, 4096)
        assert layer.attn_post_norm is None and layer.q_norm is None
    per_layer = (_q4b_bytes(12288, 3072) + _q4b_bytes(4096, 4096) + _q4b_bytes(49152, 3072)
                 + _q4b_bytes(4096, 24576) + 2 * 3072 * 4)
    want = n_layers * per_layer + _q8b_bytes(256000, 3072, 16) + 3072 * 4
    assert TS.decode_read_bytes(params, cfg) == want


@pytest.mark.parametrize("preset,n_layers", [("gemma-3-27b", 62), ("gemma-3-27b-6l", 6)])
def test_gemma3_27b_shapes_and_read_bytes(preset, n_layers):
    """Gemma-3-27B's published widths with the gemma3 branches, fused, on
    the meta device: K = 5376 (21 superblocks) on qkv and gate|up, K =
    21504 on down, o and down padded from 5376 to 6144 columns, the q/k
    norms, the query scale 168^-1/2, the window on five layers of each six
    and the two rope bases; decode_read_bytes about 18.35 GB at 62 layers."""
    cfg, params = TS.make_synthetic_llama(preset, "Q4_K", fuse=True, device="meta")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.n_vocab, cfg.rms_eps) == (
        n_layers, 5376, 32, 16, 128, 21504, 262144, 1e-6)
    assert (cfg.swa_window, cfg.swa_pattern, cfg.rope_theta, cfg.rope_scale,
            cfg.swa_rope_theta) == (1024, 6, 1e6, 1 / 8, 10000.0)
    assert cfg.qk_norm and cfg.post_norms and cfg.attn_scale == 1 / 168 ** 0.5
    assert [TL.layer_window(cfg, li) for li in range(6)] == [1024] * 5 + [None]
    for layer in params.layers:
        assert layer.wqkv.shape == (8192, 5376) and layer.wqkv.qs.shape == (2688, 8192)
        assert layer.wo.shape == (5376, 4096) and layer.wo.qs.shape == (2048, 6144)
        assert layer.w_gate_up.shape == (43008, 5376) and layer.w_gate_up.il
        assert layer.w_down.shape == (5376, 21504) and layer.w_down.qs.shape == (10752, 6144)
        assert layer.q_norm.shape == layer.k_norm.shape == (128,)
    per_layer = (_q4b_bytes(8192, 5376) + _q4b_bytes(6144, 4096) + _q4b_bytes(43008, 5376)
                 + _q4b_bytes(6144, 21504) + 4 * 5376 * 4 + 2 * 128 * 4)
    want = n_layers * per_layer + _q8b_bytes(262144, 5376, 16) + 5376 * 4
    assert TS.decode_read_bytes(params, cfg) == want
    if n_layers == 62:
        assert 18.3e9 < want < 18.4e9


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_meta_layout_matches_cpu_build(preset):
    """The meta device's layout carries the bytes of a built model."""
    for fuse in (False, True):
        cfg, meta = TS.make_synthetic_llama(preset, "Q4_K", fuse=fuse, device="meta")
        _, cpu = TS.make_synthetic_llama(preset, "Q4_K", fuse=fuse, device="cpu")
        assert TS.param_bytes(meta) == TS.param_bytes(cpu)
        assert TS.decode_read_bytes(meta, cfg) == TS.decode_read_bytes(cpu, cfg)
