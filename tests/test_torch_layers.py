"""The port's model layers held to the JAX package's `models/layers.py`
on the same numpy inputs, in f32: rotary tables and application,
sinusoidal embeddings, activations, soft cap, kv expansion, chunked
prefill attention ("masked" and "tri"), local window attention, decode
attention (grouped and expanded), MLPs, pad-logit masking and RMSNorm.
Tolerance 2e-5, the reference attention tests' own (tests/test_attention.py),
unless a case states another."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **(tol or TOL))


def _qkv(seed, B, S, H, D, K=None):
    K = K or H
    q, k, v = _rand(seed, B, S, H, D), _rand(seed + 1, B, S, K, D), \
        _rand(seed + 2, B, S, K, D)
    return q, k, v


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_tables_and_application(theta):
    pos = np.arange(37, dtype=np.int32)
    jc, js = JL.rope_tables(jnp.asarray(pos), 16, theta)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 16, theta)
    _close(tc, jc, atol=1e-5, rtol=1e-5)     # f32 pow/cos: ulps apart
    _close(ts, js, atol=1e-5, rtol=1e-5)
    x = _rand(1, 2, 37, 3, 16)
    _close(TL.rope_for_seq(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope_for_seq(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-4, rtol=1e-5)             # angles up to 36 rad
    bpos = np.stack([pos, pos + 5])          # (B, S) positions
    _close(TL.rope_for_seq(torch.from_numpy(x), torch.from_numpy(bpos),
                           theta),
           JL.rope_for_seq(jnp.asarray(x), jnp.asarray(bpos), theta),
           atol=1e-4, rtol=1e-5)
    # apply_rope leaves alignment to the caller: (S, 1, half) tables
    _close(TL.apply_rope(torch.from_numpy(x), tc[:, None], ts[:, None]),
           JL.apply_rope(jnp.asarray(x), jc[:, None], js[:, None]),
           atol=1e-4, rtol=1e-5)


def test_sinusoidal_activations_softcap_and_mask():
    pos = np.arange(11, dtype=np.int32)
    _close(TL.sinusoidal_pos_embed(torch.from_numpy(pos), 32),
           JL.sinusoidal_pos_embed(jnp.asarray(pos), 32), atol=1e-5,
           rtol=1e-5)
    x = _rand(3, 4, 33) * 3
    for act in ("silu", "gelu", "relu2"):
        _close(TL.activate(torch.from_numpy(x), act),
               JL.activate(jnp.asarray(x), act), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        TL.activate(torch.from_numpy(x), "tanh")
    _close(TL.soft_cap(torch.from_numpy(x), 5.0),
           JL.soft_cap(jnp.asarray(x), 5.0))
    t = torch.from_numpy(x)
    assert TL.soft_cap(t, 0.0) is t
    logits = _rand(4, 2, 3, 40)
    _close(TL.mask_pad_logits(torch.from_numpy(logits), 33),
           JL.mask_pad_logits(jnp.asarray(logits), 33))
    scale = x[0].copy()
    _close(TL.rms_norm(t, torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), atol=1e-5,
           rtol=1e-5)


def test_expand_kv_and_mlps():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    _close(TL.expand_kv(torch.from_numpy(k), 6),
           JL.expand_kv(jnp.asarray(k), 6))
    x, wg, wu, wd = _rand(5, 2, 3, 8), _rand(6, 8, 16), _rand(7, 8, 16), \
        _rand(8, 16, 8)
    t = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    j = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    _close(TL.mlp_glu(*t, "silu"), JL.mlp_glu(*j, "silu"), atol=1e-4,
           rtol=1e-5)
    _close(TL.mlp_classic(t[0], t[2], t[3], "gelu"),
           JL.mlp_classic(j[0], j[2], j[3], "gelu"), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("S,bq,bk", [(16, 4, 4), (37, 8, 16), (64, 64, 64),
                                     (100, 32, 8)])
@pytest.mark.parametrize("impl", ["masked", "tri"])
def test_chunked_attention(S, bq, bk, impl):
    q, k, v = _qkv(S, 2, S, 4, 16)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=bq, block_k=bk,
                                impl=impl)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), block_q=bq, block_k=bk,
                               impl=impl)
    _close(got, want)


def test_chunked_attention_window_and_kv_len():
    q, k, v = _qkv(3, 2, 40, 4, 16)
    kw = dict(block_q=16, block_k=8, window=12, kv_len=33)
    _close(TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("S,w", [(64, 16), (100, 32), (32, 64)])
def test_local_window_attention(S, w):
    q, k, v = _qkv(S + w, 2, S, 4, 16)
    _close(TL.local_chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                      window=w, block_q=16),
           JL.local_chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      window=w, block_q=16))


@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention_grouped_and_expanded(window):
    B, S, H, K, D = 3, 24, 6, 2, 16
    q = _rand(1, B, 1, H, D)
    k, v = _rand(2, B, S, K, D), _rand(3, B, S, K, D)
    lens = np.array([5, 24, 17], dtype=np.int32)
    for clen in (lens, 19):
        _close(TL.decode_attention_grouped(
            *map(torch.from_numpy, (q, k, v)),
            torch.as_tensor(clen), window=window),
            JL.decode_attention_grouped(*map(jnp.asarray, (q, k, v)),
                                        jnp.asarray(clen), window=window))
        ke, ve = (np.repeat(a, H // K, axis=2) for a in (k, v))
        _close(TL.decode_attention(*map(torch.from_numpy, (q, ke, ve)),
                                   torch.as_tensor(clen), window=window),
               JL.decode_attention(*map(jnp.asarray, (q, ke, ve)),
                                   jnp.asarray(clen), window=window))
