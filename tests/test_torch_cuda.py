"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere. They import neither jax
nor the JAX package, so they run on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU parity tests: q4b products within 1e-5 of
their largest magnitude (exact int32 group dots, f32 sums in another order),
the fused FFN within 2e-3 (one requantized code may move by one step),
attention within 2e-2 (bf16 p rounded against another running max) with the
written cache rows exactly equal.
"""
import pytest
import torch

from llamafile_tpu_torch.ops import attention as A
from llamafile_tpu_torch.ops import qmatmul as Q

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from llamafile_tpu_torch import resolve_device
    return resolve_device("cuda")


def rand_q4b(gen, layers, n, k, dev):
    qs = torch.randint(0, 256, (layers, k // 2, n), generator=gen, device=dev,
                       dtype=torch.uint8)
    sc = torch.empty((layers, k // 32, n), device=dev).uniform_(1e-3, 2e-2, generator=gen)
    b = torch.empty((layers, k // 32, n), device=dev).uniform_(-0.1, 0.0, generator=gen)
    return qs, sc.to(torch.bfloat16), b.to(torch.bfloat16)


def assert_close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("n,k", [(4096, 4096), (6144, 1024), (1044, 512), (2048, 14336)])
@pytest.mark.parametrize("bias", [True, False])
def test_txn_m1_matches_plain(dev, n, k, bias):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    b = b[1] if bias else None
    xq, sx = Q.quantize_activations_g32(torch.randn(1, k, generator=gen, device=dev),
                                        torch.rand(k, generator=gen, device=dev) + 0.5, 1e-5)
    n0 = Q.qmm_txn_m1.launches
    got = Q.qmm_txn_m1(xq, sx, qs[1], sc[1], b)
    assert Q.qmm_txn_m1.launches == n0 + 1
    assert_close(got, Q.qmm_txn_m1_plain(xq, sx, qs[1], sc[1], b), 1e-5)


@pytest.mark.parametrize("m", [2, 8, 16, 31, 32])
@pytest.mark.parametrize("n,k", [(4096, 4096), (1040, 1024), (512, 14336)])
def test_txn_matches_plain(dev, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(m * n + k)
    qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(m, k, generator=gen, device=dev))
    n0 = Q.qmm_txn.launches
    got = Q.qmm_txn(xq, sx, qs[0], sc[0], b[0])
    assert Q.qmm_txn.launches == n0 + 1
    assert_close(got, Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b[0]), 1e-5)


@pytest.mark.parametrize("d,dff", [(256, 1024), (4096, 14336)])
def test_moe_m1_matches_plain(dev, d, dff):
    gen = torch.Generator(device=dev).manual_seed(d)
    gq, gs, gb = rand_q4b(gen, 2, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, 2, d, dff, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(1, d, generator=gen, device=dev))
    args = (xq, sx, gq[1], gs[1], gb[1], dq[1], ds[1], db[1], 0.75)
    n0 = Q.qmm_moe_m1.launches
    got = Q.qmm_moe_m1(*args)
    assert Q.qmm_moe_m1.launches == n0 + 2        # gate|up kernel, down kernel
    assert_close(got, Q.qmm_moe_m1_plain(*args), 2e-3)


@pytest.mark.parametrize("hq,hkv", [(32, 8), (8, 8), (16, 8), (16, 2)])
@pytest.mark.parametrize("pos,s_limit", [((0, 5), None), ((700, 1023), 1024),
                                         ((1, 2000), None)])
def test_flash_decode_write_matches_plain(dev, hq, hkv, pos, s_limit):
    gen = torch.Generator(device=dev).manual_seed(hq * 10 + hkv)
    nl, b, s, d = 3, 2, 2048, 128
    k3 = torch.randn((nl, b, s, hkv * d), generator=gen, device=dev).to(torch.bfloat16)
    v3 = torch.randn((nl, b, s, hkv * d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    kn = torch.randn((b, hkv, d), generator=gen, device=dev)
    vn = torch.randn((b, hkv, d), generator=gen, device=dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    k3b, v3b = k3.clone(), v3.clone()
    n0 = A.flash_decode_write_stacked.launches
    got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 1, p, 0.088, hkv,
                                       s_limit=s_limit)
    assert A.flash_decode_write_stacked.launches == n0 + 1
    s_eff = s_limit if s_limit is not None else s
    want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 1, p, 0.088, hkv, s_eff)
    assert_close(got, want, 2e-2)
    assert torch.equal(k3, k3b) and torch.equal(v3, v3b)


def test_wrapper_rejects_bad_inputs(dev):
    xq = torch.zeros(1, 256, dtype=torch.int8, device=dev)
    sx = torch.zeros(1, 8, device=dev)
    qs = torch.zeros(128, 512, dtype=torch.uint8, device=dev)
    sc = torch.zeros(8, 512, device=dev)                      # f32, not bf16
    with pytest.raises(TypeError):
        Q.qmm_txn_m1(xq, sx, qs, sc)
    with pytest.raises(ValueError):
        Q.qmm_txn_m1(xq, sx, qs.cpu(), sc.to(torch.bfloat16).cpu())
