"""The port's paged KV cache (runtime/paged.py) and paged decode forward
against the JAX package's, on the CPU.

Both packages get the same pools, tables and tokens, made with numpy or a
seeded torch.Generator on the CPU. The JAX side runs on its plain CPU
backend: there `paged_attend` takes its f32 gather reference and `qmatmul`
interprets its Pallas kernels by itself. (The `pallas_kernels` fixture of
tests/test_torch_llama.py would send `paged_attend` to the TPU kernel.)

Tolerances: paged attention is f32 on both sides over the same bf16 (or
int8 x f32 scale) values, only the order of the sums differs, so it is held
within 1e-5 of each (row, head)'s largest output; two faulty versions (one
masked key made visible, each row's last page dropped) must fail that
limit. The paged decode follows the rule of test_prefill_then_decode_matches_jax.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.models import llama as JL
from llamafile_tpu.runtime import paged as JP
from llamafile_tpu_torch.convert import config_from_fields, paged_from_numpy
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.runtime import paged as TP
from llamafile_tpu_torch.testing import paged_case, paged_controls, row_rel_err
from tests.test_torch_llama import carry_across, close, jax_model

PS, MAXP = 16, 8
EDGE = [1, PS - 1, PS, PS + 1, MAXP * PS]


def np32(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def jnp_of(t):
    a = np32(t)
    return jnp.asarray(a, jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(a)


def test_page_allocator_scripted_sequence():
    j, t = JP.PageAllocator(20, 4, 3, 32), TP.PageAllocator(20, 4, 3, 32)
    script = [("ensure", 0, 9), ("ensure", 1, 3), ("share_prefix", 0, 2, 2),
              ("ensure", 2, 13), ("truncate", 0, 5), ("ensure", 0, 16),
              ("release", 1), ("share_prefix", 2, 1, 3), ("truncate", 2, 0),
              ("ensure", 2, 7), ("release", 0), ("ensure", 1, 14)]
    for op, *args in script:
        getattr(j, op)(*args)
        getattr(t, op)(*args)
        assert (t.tables, t.lengths, t.refs, t.free) == (j.tables, j.lengths,
                                                         j.refs, j.free), op
        assert [t.shared_page_count(r) for r in range(3)] == \
               [j.shared_page_count(r) for r in range(3)]
        for only in (None, [1]):
            np.testing.assert_array_equal(
                t.device_tables(3, only, device="cpu").numpy(),
                np.asarray(j.device_tables(3, only)))


@pytest.mark.parametrize("int8", [False, True])
def test_copy_gather_and_write_token_match_jax(int8):
    L, H, D, S, n_pages = 2, 2, 64, 64, 12
    rng = np.random.default_rng(int8)
    dk = rng.standard_normal((L, 1, S, H * D)).astype(np.float32)
    dv = rng.standard_normal((L, 1, S, H * D)).astype(np.float32)
    dk_t = torch.from_numpy(dk).to(torch.bfloat16)
    dv_t = torch.from_numpy(dv).to(torch.bfloat16)
    pages = np.asarray([7, 2, 9, 4], np.int32)
    dt = "int8" if int8 else jnp.bfloat16
    jpool = JP.init_paged(L, H, n_pages, PS, D, dtype=dt)
    jpool = JP.copy_row_to_pages(jpool, jnp.asarray(dk, jnp.bfloat16),
                                 jnp.asarray(dv, jnp.bfloat16),
                                 jnp.asarray(pages), ps=PS)
    tpool = TP.init_paged(L, H, n_pages, PS, D, dtype="int8" if int8 else "bf16",
                          device="cpu")
    TP.copy_row_to_pages(tpool, dk_t, dv_t, torch.from_numpy(pages), PS)

    def same_pool():
        for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
            a, b = getattr(jpool, name), getattr(tpool, name)
            if a is None:
                assert b is None
                continue
            a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
            if name.endswith("scale"):      # within one f32 ulp
                np.testing.assert_allclose(b.numpy(), a, rtol=1.2e-7, atol=0)
            else:
                np.testing.assert_array_equal(np32(b), a, err_msg=name)
    same_pool()
    jk, jv = JP.gather_pages_to_row(jpool, jnp.asarray(pages), ps=PS, max_len=S)
    tk, tv = TP.gather_pages_to_row(tpool, torch.from_numpy(pages), PS, S)
    np.testing.assert_array_equal(np32(tk), np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(np32(tv), np.asarray(jv.astype(jnp.float32)))
    if not int8:                   # the round trip is exact for bf16 pages
        np.testing.assert_array_equal(np32(tk), np32(dk_t))
    # one new token a row, a parked row on the trash page 0 (jitted, as the
    # batcher runs it: XLA's numerics of _q8 are the reference's)
    kn = rng.standard_normal((3, H, D)).astype(np.float32)
    vn = rng.standard_normal((3, H, D)).astype(np.float32)
    pg, off = np.asarray([9, 0, 4], np.int32), np.asarray([3, 0, 15], np.int32)
    lay = 1
    scales = ((jpool.k_scale[lay], jpool.v_scale[lay]) if int8 else ())
    out = jax.jit(JP.write_token_kv)(jpool.k_pages[lay], jpool.v_pages[lay],
                            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pg),
                            jnp.asarray(off), *scales)
    names = ("k_pages", "v_pages", "k_scale", "v_scale")
    jpool = JP.PagedKV(*[getattr(jpool, n) if getattr(jpool, n) is None
                         else getattr(jpool, n).at[lay].set(o)
                         for n, o in zip(names, list(out) + [None] * 2)])
    TP.write_token_kv(tpool.k_pages[lay], tpool.v_pages[lay],
                      torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(pg), torch.from_numpy(off),
                      *((tpool.k_scale[lay], tpool.v_scale[lay]) if int8 else ()))
    same_pool()


def test_find_mid_delete_matches_jax():
    rng = np.random.default_rng(0)
    hist = list(rng.integers(0, 50, 120))
    for prefix, cut, tail in ((10, 30, 40), (0, 5, 100), (50, 8, 3), (20, 1, 60)):
        ids = hist[:prefix] + hist[prefix + cut:prefix + cut + tail] + [999] * 4
        assert TP.find_mid_delete(hist, ids, prefix) == \
               JP.find_mid_delete(hist, ids, prefix)
    assert TP.find_mid_delete(hist, [1, 2], 0) == JP.find_mid_delete(hist, [1, 2], 0)


@pytest.mark.parametrize("int8", [False, True])
def test_relocate_span_matches_jax(int8):
    jcfg, _ = jax_model()
    tcfg = config_from_fields({f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})
    g = torch.Generator().manual_seed(5)
    q, kp, vp, ks, vs, lens, tables = paged_case(
        g, [100, 40], 2, 1, 128, PS, MAXP, n_layers=2, int8=int8)
    row = torch.cat([tables[0], torch.zeros(4, dtype=torch.int32)])
    jpool = JP.PagedKV(*[None if a is None else jnp_of(a) for a in (kp, vp, ks, vs)])
    tpool = TP.PagedKV(*[None if a is None else a.clone() for a in (kp, vp, ks, vs)])
    jpool = JP.relocate_span(jpool, jcfg, jnp.asarray(row.numpy()), jnp.int32(37),
                             jnp.int32(12), n_move=64)
    TP.relocate_span(tpool, tcfg, row, 37, 12, 64)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = getattr(jpool, name), getattr(tpool, name)
        if a is None:
            continue
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        b = np32(b).astype(np.float32)
        if int8 and name == "k_pages":     # a code may round the other way
            assert np.abs(b - a).max() <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 1)])
def test_paged_attention_plain_matches_jax(int8, hq, hkv):
    g = torch.Generator().manual_seed(hq * 10 + hkv + int8)
    q, kp, vp, ks, vs, lens, tables = paged_case(g, EDGE, hq, hkv, 64, PS, MAXP,
                                                 n_layers=2, int8=int8)
    lay = 1
    args = (q, kp[lay], vp[lay], lens, tables,
            None if ks is None else ks[lay], None if vs is None else vs[lay])
    got = TP.paged_attention_plain(*args)
    want = torch.from_numpy(np.asarray(JP.paged_attend(
        jnp.asarray(q.numpy()), jnp_of(kp[lay]), jnp_of(vp[lay]),
        jnp.asarray(lens.numpy()), jnp.asarray(tables.numpy()),
        k_scale_l=None if ks is None else jnp.asarray(ks[lay].numpy()),
        v_scale_l=None if vs is None else jnp.asarray(vs[lay].numpy()))))
    assert row_rel_err(got, want) <= 1e-5
    assert row_rel_err(TP.paged_attend(*args[:5], k_scale_l=args[5],
                                       v_scale_l=args[6]), want) <= 1e-5
    for control in paged_controls(*args[:3], args[5], args[6], lens, tables, PS):
        assert row_rel_err(control, want) > 1e-5


j_paged_decode = jax.jit(JL.forward_paged_decode, static_argnames=("cfg",))


@pytest.mark.parametrize("quant,int8", [("Q4_K", False), ("Q8_0", False),
                                        ("Q4_K", True)])
def test_forward_paged_decode_matches_jax(quant, int8):
    """R = 3 rows at different positions, 4 teacher-forced steps, over a
    pool seeded with random K/V and shuffled tables."""
    jcfg, jp = jax_model(seed=11, quant=quant)
    tcfg, tp = carry_across(jcfg, jp)
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    g = torch.Generator().manual_seed(2)
    pos0 = [5, 40, 63]
    _, kp, vp, ks, vs, _, tables = paged_case(
        g, [p + 4 for p in pos0], 2, 1, 128, PS, MAXP, n_layers=2, int8=int8)
    tpool = paged_from_numpy(*[None if a is None else np32(a)
                               for a in (kp, vp, ks, vs)], device="cpu")
    jpool = JP.PagedKV(*[None if a is None else jnp_of(a) for a in (kp, vp, ks, vs)])
    toks = np.random.default_rng(4).integers(3, jcfg.n_vocab, (4, 3)).astype(np.int32)
    errs = []
    for i in range(4):
        pos = np.asarray(pos0, np.int32) + i
        jl, jpool = j_paged_decode(jst, jcfg, jnp.asarray(toks[i]), jnp.asarray(pos),
                                   jpool, jnp.asarray(tables.numpy()))
        tl, _ = TL.forward_paged_decode(tst, tcfg, torch.from_numpy(toks[i]),
                                        torch.from_numpy(pos), tpool, tables)
        errs.append(close(tl.numpy(), jl))
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    assert sum(e <= 1e-4 for e in errs) >= len(errs) // 2, errs
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = getattr(jpool, name), getattr(tpool, name)
        if a is None:
            continue
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        if name.endswith("pages") and int8:   # a code may round the other way
            assert np.abs(np32(b).astype(np.float32) - a).max() <= 1
        else:
            close(np32(b), a)
