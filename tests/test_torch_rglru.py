"""The port's RG-LRU pieces (`repro_torch/models/rglru.py`) held to the
JAX package's on the same numpy inputs in f32: `rg_lru` (the torch
log-depth scan where the reference calls `lax.associative_scan`),
`causal_conv1d` and `_block_diag` within 1e-5, the scan itself against a
sequential recurrence within 1e-5, `_to_ring` bit for bit, the decode
attention block over a wrapped ring; the layer plan, the parameter
specs, `a_param` kept f32 in a bf16 model, and `scale_embed`'s constant
rounded to the model's dtype as the reference rounds it."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import rglru as JG
from repro_torch.configs import get_config, reduced
from repro_torch.models import rglru as G
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(layers=3, dtype="float32"):
    j = dataclasses.replace(
        jreduced(jget_config("recurrentgemma-2b"), layers=layers), dtype=dtype)
    t = dataclasses.replace(
        reduced(get_config("recurrentgemma-2b"), layers=layers), dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _rng_f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _block_params(rng, W, nb):
    bw = W // nb
    return {"rg_a": _rng_f32(rng, (nb, bw, bw), 1 / math.sqrt(bw)),
            "rg_a_b": _rng_f32(rng, (W,), 0.1),
            "rg_x": _rng_f32(rng, (nb, bw, bw), 1 / math.sqrt(bw)),
            "rg_x_b": _rng_f32(rng, (W,), 0.1),
            "a_param": np.linspace(-3.0, 0.0, W, dtype=np.float32)}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_rg_lru_matches_reference(S):
    rng = np.random.default_rng(S)
    W, nb = 32, 4
    p = _block_params(rng, W, nb)
    u = _rng_f32(rng, (2, S, W))
    h0 = _rng_f32(rng, (2, W))
    jh, jT = jax.jit(JG.rg_lru)(jnp.asarray(u), {k: jnp.asarray(v) for k, v
                                                 in p.items()},
                                jnp.asarray(h0))
    th, tT = G.rg_lru(torch.from_numpy(u), params_from_numpy(p, device="cpu"),
                      torch.from_numpy(h0))
    assert th.dtype == torch.float32 and th.shape == (2, S, W)
    _close(th, jh)
    _close(tT, jT)


@pytest.mark.parametrize("S", [1, 3, 16, 17, 300])
def test_linear_scan_matches_sequential_recurrence(S):
    """The Hillis–Steele scan against h_t = a_t h_{t-1} + b_t step by step."""
    rng = np.random.default_rng(S + 1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32))
    b = torch.from_numpy(_rng_f32(rng, (2, S, 8)))
    a_cum, h = G.linear_scan(a, b)
    want_h, want_a = [], []
    hh = torch.zeros(2, 8)
    aa = torch.ones(2, 8)
    for t in range(S):
        hh = a[:, t] * hh + b[:, t]
        aa = aa * a[:, t]
        want_h.append(hh)
        want_a.append(aa)
    np.testing.assert_allclose(h.numpy(), torch.stack(want_h, 1).numpy(),
                               **TOL)
    np.testing.assert_allclose(a_cum.numpy(), torch.stack(want_a, 1).numpy(),
                               **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_causal_conv1d_and_block_diag_match_reference(S):
    rng = np.random.default_rng(7)
    W, cw = 16, 4
    u, w = _rng_f32(rng, (2, S, W)), _rng_f32(rng, (cw, W))
    b, state = _rng_f32(rng, (W,)), _rng_f32(rng, (2, cw - 1, W))
    jo, js = JG.causal_conv1d(*(jnp.asarray(t) for t in (u, w, b, state)))
    to, ts = G.causal_conv1d(*(torch.from_numpy(t) for t in (u, w, b, state)))
    _close(to, jo)
    _close(ts, js, atol=0, rtol=0)
    bd = _rng_f32(rng, (4, 4, 4))
    _close(G._block_diag(torch.from_numpy(u), torch.from_numpy(bd),
                         torch.from_numpy(b)),
           JG._block_diag(jnp.asarray(u), jnp.asarray(bd), jnp.asarray(b)))


@pytest.mark.parametrize("S", [3, 8, 11, 16, 21])
def test_to_ring_matches_reference(S):
    k = np.arange(2 * S * 2 * 3, dtype=np.float32).reshape(2, S, 2, 3)
    got = G._to_ring(torch.from_numpy(k), 8)
    assert tuple(got.shape) == (2, 8, 2, 3)
    _close(got, JG._to_ring(jnp.asarray(k), 8), atol=0, rtol=0)


@pytest.mark.parametrize("pos", [5, 31, 32, 45])
def test_attention_block_decode_matches_reference(pos):
    """One decode token written at pos % window into a full ring."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(pos)
    d, H, K, hd = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, \
        tcfg.head_dim
    win = tcfg.rglru.attention_window
    p = {"wq": _rng_f32(rng, (d, H, hd), 0.2),
         "wk": _rng_f32(rng, (d, K, hd), 0.2),
         "wv": _rng_f32(rng, (d, K, hd), 0.2),
         "wo": _rng_f32(rng, (H, hd, d), 0.2)}
    st = {"k": _rng_f32(rng, (2, win, K, hd)),
          "v": _rng_f32(rng, (2, win, K, hd))}
    x = _rng_f32(rng, (2, 1, d))
    jo, jst = JG.attention_block(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()}, decode=True,
        pos=jnp.asarray(pos, jnp.int32))
    tst = params_from_numpy(st, device="cpu")
    to, tnew = G.attention_block(
        tcfg, params_from_numpy(p, device="cpu"), torch.from_numpy(x), tst,
        decode=True, pos=torch.tensor(pos, dtype=torch.int32))
    _close(to, jo)
    for key in ("k", "v"):
        _close(tnew[key], jst[key])
    assert np.array_equal(tst["k"].numpy(), st["k"])   # a new ring


def test_layer_plan_param_specs_and_a_param_dtype():
    for layers in (3, 5, 26):
        j, t = _cfgs(layers)
        assert G.layer_plan(t) == JG.layer_plan(j)
        assert G.param_specs(t) == JG.param_specs(j)
    assert G.layer_plan(get_config("recurrentgemma-2b")) == \
        (8, ("recurrent", "recurrent"))
    _, t16 = _cfgs(5, "bfloat16")
    params = G.init_params(t16, torch.Generator().manual_seed(0))
    meta = G.abstract_params(t16)
    for name, v in params.items():
        want = torch.float32 if name.endswith("a_param") else torch.bfloat16
        assert v.dtype == meta[name].dtype == want, name
    a = params["super/0/a_param"]
    assert float(a.min()) == -3.0 and float(a.max()) == 0.0
    assert not params["tail/0/conv_b"].any()
    jcfg = _cfgs(5, "bfloat16")[0]
    jp = jax.jit(lambda key: JG.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    carried = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    assert carried["super/0/a_param"].dtype == torch.float32
    assert carried["super/0/wx"].dtype == torch.bfloat16


def test_scale_embed_rounds_the_constant_to_the_dtype():
    """sqrt(2560) is 50.596; the reference multiplies bf16 embeddings by
    it rounded to bf16 (50.5)."""
    _, t = _cfgs(3, "bfloat16")
    t = dataclasses.replace(t, d_model=2560)
    rng = np.random.default_rng(9)
    table = rng.standard_normal((16, 2560)).astype(np.float32)
    tok = np.array([[3, 0, 15]], dtype=np.int32)
    want = jnp.take(jnp.asarray(table, jnp.bfloat16), jnp.asarray(tok),
                    axis=0) * jnp.asarray(math.sqrt(2560), jnp.bfloat16)
    got = G.embed_tokens(t, torch.from_numpy(table).to(torch.bfloat16),
                         torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    ones = G.embed_tokens(t, torch.ones((1, 2560), dtype=torch.bfloat16),
                          torch.zeros((1, 1), dtype=torch.int32))
    assert float(ones[0, 0, 0]) == 50.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rg_lru_step_matches_reference(seed):
    """One token, (B, 1, W), through the reference's `rg_lru_step`."""
    rng = np.random.default_rng(100 + seed)
    W, nb = 32, 4
    p = _block_params(rng, W, nb)
    u = _rng_f32(rng, (3, 1, W))
    h0 = _rng_f32(rng, (3, W))
    jh, jT = jax.jit(JG.rg_lru_step)(
        jnp.asarray(u), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(h0))
    th, tT = G.rg_lru_step(torch.from_numpy(u),
                           params_from_numpy(p, device="cpu"),
                           torch.from_numpy(h0))
    assert th.shape == (3, 1, W) and tT.shape == (3, W)
    _close(th, jh)
    _close(tT, jT)
