"""The port's sampling chain against the JAX package's, on the CPU.

Both packages get the same logits and penalty counts, made with numpy from a
seed, and the same Gumbel noise: the JAX side draws it from its keys
(`jax.random.categorical` is argmax(logits + gumbel(key)); under
`sample_batched`'s vmap each row's key gives 64 values), and the port
receives those values through its `_gumbel`. Token ids must be equal.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.runtime import sampling as JS
from llamafile_tpu_torch.runtime import sampling as TS

V, R = 300, 4
HIST = [5, 7, 7, 9, 11, 5, 5, 200, 3, 7]

CASES = {
    "greedy": dict(temperature=0.0),
    "top_k_0": dict(top_k=0, top_p=1.0, min_p=0.0, temperature=1.0),
    "top_k_5": dict(top_k=5, temperature=1.2),
    "top_k_40": dict(top_k=40, top_p=1.0, min_p=0.0),
    "top_p": dict(top_k=0, top_p=0.6, min_p=0.0),
    "min_p": dict(top_k=0, top_p=1.0, min_p=0.2),
    "tfs_z": dict(top_k=0, top_p=1.0, min_p=0.0, tfs_z=0.7),
    "typical_p": dict(top_k=0, top_p=1.0, min_p=0.0, typical_p=0.6),
    "dynatemp": dict(top_k=30, dynatemp_range=0.6, dynatemp_exponent=1.5),
    "penalties": dict(repeat_penalty=1.3, presence_penalty=0.5,
                      frequency_penalty=0.3, top_k=20),
    "penalties_greedy": dict(temperature=0.0, repeat_penalty=2.0,
                             presence_penalty=1.0),
    "logit_bias": dict(logit_bias=((3, 4.0), (250, -2.0), (17, 6.5))),
}


def _logits(seed, rows=R):
    return (np.random.default_rng(seed).standard_normal((rows, V)) * 3
            ).astype(np.float32)


def _windows(rows, last_n):
    j = [JS.penalty_window_init(HIST[: 4 + r], V, last_n, ring_size=16)
         for r in range(rows)]
    t = [TS.penalty_window_init(HIST[: 4 + r], V, last_n, ring_size=16,
                                device="cpu") for r in range(rows)]
    return j, t


def _same_window(jw, tw):
    for name in ("counts", "ring", "rlen", "last_n"):
        np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                      np.asarray(getattr(jw, name)), err_msg=name)


@pytest.mark.parametrize("last_n,ring", [(4, None), (64, 16), (-1, 8), (0, 8)])
def test_penalty_window_init_and_push(last_n, ring):
    jw = JS.penalty_window_init(HIST, V, last_n, ring_size=ring)
    tw = TS.penalty_window_init(HIST, V, last_n, ring_size=ring, device="cpu")
    _same_window(jw, tw)
    for tok in (9, 9, 299, 0, 5, 7, 7, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        jw = JS.penalty_window_push(jw, jnp.asarray([tok], jnp.int32))
        TS.penalty_window_push(tw, torch.tensor([tok], dtype=torch.int32))
        _same_window(jw, tw)


def _sps(case, rows=R):
    return [JS.SamplingParams(seed=r, **CASES[case]) for r in range(rows)], \
           [TS.SamplingParams(seed=r, **CASES[case]) for r in range(rows)]


def test_row_params_from_sp_same_arrays():
    jsps = [JS.SamplingParams(**c) for c in CASES.values()]
    tsps = [TS.SamplingParams(**c) for c in CASES.values()]
    jrp = JS.row_params_from_sp(jsps, V)
    trp = TS.row_params_from_sp(tsps, V, device="cpu")
    for name in JS.RowParams._fields:
        a, b = getattr(jrp, name), getattr(trp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _stacked_counts(rows, last_n=64):
    j, t = _windows(rows, last_n)
    return (jnp.concatenate([w.counts for w in j]),
            torch.cat([w.counts for w in t]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_batched_same_ids(monkeypatch, case):
    jsps, tsps = _sps(case)
    logits = _logits(sorted(CASES).index(case))
    jc, tc = _stacked_counts(R)
    keys = jax.random.split(jax.random.PRNGKey(11), R)
    noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (JS.K_BUDGET,))))
             for k in keys]
    it = iter(noise)
    monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: next(it))
    want = JS.sample_batched(jnp.asarray(logits), keys,
                             JS.row_params_from_sp(jsps, V), jc)
    got = TS.sample_batched(torch.from_numpy(logits), [object()] * R,
                            TS.row_params_from_sp(tsps, V, device="cpu"), tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_batched_mixed_rows(monkeypatch):
    """Rows with different knobs in one call, greedy and sampled."""
    names = ["greedy", "top_k_5", "tfs_z", "dynatemp", "penalties", "logit_bias"]
    jsps = [JS.SamplingParams(**CASES[n]) for n in names]
    tsps = [TS.SamplingParams(**CASES[n]) for n in names]
    logits = _logits(5, len(names))
    jc, tc = _stacked_counts(len(names))
    keys = jax.random.split(jax.random.PRNGKey(3), len(names))
    it = iter([torch.from_numpy(np.array(jax.random.gumbel(k, (JS.K_BUDGET,))))
               for k in keys])
    monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: next(it))
    want = JS.sample_batched(jnp.asarray(logits), keys,
                             JS.row_params_from_sp(jsps, V), jc)
    got = TS.sample_batched(torch.from_numpy(logits), [object()] * len(names),
                            TS.row_params_from_sp(tsps, V, device="cpu"), tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_with_counts_same_ids(monkeypatch, case):
    """The single-row chain over the whole vocabulary (admission's draw)."""
    jsp, tsp = JS.SamplingParams(**CASES[case]), TS.SamplingParams(**CASES[case])
    for seed in range(3):
        logits = _logits(100 + seed + sorted(CASES).index(case), 1)
        jw, tw = _windows(1, 16)
        key = jax.random.PRNGKey(seed)
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, (1, V))))
        monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: noise)
        want = JS.sample(jnp.asarray(logits), key, jsp, jw[0].counts)
        got = TS.sample(torch.from_numpy(logits), None, tsp, tw[0].counts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_raises_for_mirostat(monkeypatch):
    """`sample` no longer raises for mirostat: like the reference's, it runs
    the chain and leaves mu to `sample_stateful` (the Engine's draw; the
    server refuses mirostat, ROADMAP C.10). Same ids as the reference's."""
    jsp = JS.SamplingParams(mirostat=2, top_k=20)
    tsp = TS.SamplingParams(mirostat=2, top_k=20)
    logits = _logits(77, 1)
    key = jax.random.PRNGKey(5)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (1, V))))
    monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: noise)
    want = JS.sample(jnp.asarray(logits), key, jsp)
    got = TS.sample(torch.from_numpy(logits), None, tsp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok, mu = TS.sample_stateful(torch.from_numpy(logits), None, tsp, None,
                                 TS.mirostat_init(tsp, 1, device="cpu"))
    assert tok.shape == (1,) and mu.shape == (1,)
