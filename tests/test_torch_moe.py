"""The port's MoE FFN (`repro_torch/models/moe.py`) held to the JAX
package's on reduced configs in f32, with the reference's own weights
carried over through `params_from_numpy`: `moe_ffn` with and without
capacity drops for both MoE configs within 1e-4, its aux loss within
1e-6, the dispatch (`disp`, `gate_slot`) bit for bit, the chosen experts
as sets per token (`torch.topk` and `lax.top_k` may order exact ties
differently), and the shared expert's gate in `transformer._ffn`; then
the cases of tests/test_moe.py run against the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as M
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

MOE_ARCHS = ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(name, cap_factor):
    def tiny(cfg):
        cfg = dataclasses.replace(cfg, dtype="float32")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap_factor))
    return (tiny(jreduced(jget_config(name))),
            tiny(reduced(get_config(name))))


def _layer_params(jcfg, seed=0):
    """Layer 0 of the reference's init_params, as JAX arrays and as the
    port's tensors."""
    p = jax.jit(lambda key: JT.init_params(jcfg, key))(
        jax.random.PRNGKey(seed))
    _, lyr = JT._split_layers(p)
    jlp = {k: v[0] for k, v in lyr.items()}
    return jlp, params_from_numpy({k: np.asarray(v) for k, v in jlp.items()},
                                  device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("cap_factor", [8.0, 1.0, 0.25])
def test_moe_ffn_matches_reference(name, cap_factor):
    jcfg, tcfg = _cfgs(name, cap_factor)
    jlp, tlp = _layer_params(jcfg)
    x = _x((3, 24, jcfg.d_model), 1)
    jy, ja = jax.jit(lambda p, x: JM.moe_ffn(jcfg, p, x))(jlp,
                                                          jnp.asarray(x))
    ty, ta = M.moe_ffn(tcfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert abs(float(ta) - float(ja)) < 1e-6
    # the same (token, expert) pairs are kept: dispatch on the same route
    m = jcfg.moe
    xf = x.reshape(-1, jcfg.d_model)
    _, jg, jids = JM.router_probs(jcfg, jlp, jnp.asarray(xf))
    _, tg, tids = M.router_probs(tcfg, tlp, torch.from_numpy(xf))
    assert [set(r) for r in tids.tolist()] == \
        [set(r) for r in np.asarray(jids).tolist()]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    cap = M.capacity(tcfg, 24)
    assert cap == JM.capacity(jcfg, 24)
    jd, jgs = jax.vmap(lambda i, g: JM.dispatch_indices(
        i, g, m.num_experts, cap))(jids.reshape(3, 24, m.top_k),
                                   jg.reshape(3, 24, m.top_k))
    # the port's own route: the same slots (a token's order among its
    # k experts does not move a slot), gates within rounding
    td, tgs = M.dispatch_indices(tids.reshape(3, 24, m.top_k),
                                 tg.reshape(3, 24, m.top_k),
                                 m.num_experts, cap)
    assert td.dtype == torch.int32
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), atol=1e-6)
    # the reference's route through the port's dispatch: bit for bit
    rd, rgs = M.dispatch_indices(
        torch.from_numpy(np.array(jids).reshape(3, 24, m.top_k)),
        torch.from_numpy(np.array(jg).reshape(3, 24, m.top_k)),
        m.num_experts, cap)
    assert np.array_equal(rd.numpy(), np.asarray(jd))
    assert np.array_equal(rgs.numpy(), np.asarray(jgs))
    dropped = 3 * 24 * m.top_k - int((td < 24).sum())
    assert (dropped == 0) == (cap_factor == 8.0)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50), T=st.sampled_from([1, 5, 30]),
       cap=st.sampled_from([4, 12]))
def test_dispatch_indices_match_reference(seed, T, cap):
    """The same ids and gates (with many ties between tokens) give the
    same slots, also batched over groups where the reference vmaps."""
    rng = np.random.default_rng(seed)
    E, k, G = 6, 2, 3
    ids = np.stack([np.stack([rng.choice(E, k, replace=False)
                              for _ in range(T)]) for _ in range(G)])
    gates = rng.random((G, T, k)).astype(np.float32)
    jd, jg = jax.vmap(lambda i, g: JM.dispatch_indices(i, g, E, cap))(
        jnp.asarray(ids, jnp.int32), jnp.asarray(gates))
    td, tg = M.dispatch_indices(torch.from_numpy(ids), torch.from_numpy(gates),
                                E, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    one_d, one_g = M.dispatch_indices(torch.from_numpy(ids[0]),
                                      torch.from_numpy(gates[0]), E, cap)
    assert torch.equal(one_d, td[0]) and torch.equal(one_g, tg[0])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_ffn_with_shared_expert_matches_reference(name):
    jcfg, tcfg = _cfgs(name, 1.25)
    jlp, tlp = _layer_params(jcfg, seed=3)
    if jcfg.moe.num_shared_experts:
        # a nonzero shared gate (init leaves it at zero)
        g = _x((jcfg.d_model,), 4)
        jlp["shared_gate"], tlp["shared_gate"] = jnp.asarray(g), \
            torch.from_numpy(g)
    x = _x((2, 16, jcfg.d_model), 5)
    jy, ja = JT._ffn(jcfg, jlp, jnp.asarray(x))
    ty, ta = TT._ffn(tcfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert abs(float(ta) - float(ja)) < 1e-6


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_ffn_dense_matches_reference(name):
    jcfg, tcfg = _cfgs(name, 1.0)
    jlp, tlp = _layer_params(jcfg, seed=6)
    x = _x((2, 9, jcfg.d_model), 7)
    jy, ja = JM.moe_ffn_dense(jcfg, jlp, jnp.asarray(x))
    ty, ta = M.moe_ffn_dense(tcfg, tlp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert abs(float(ta) - float(ja)) < 1e-6


# ---- tests/test_moe.py's cases against the port --------------------------

def tiny_moe(cap_factor=8.0, name="granite-moe-1b-a400m"):
    return _cfgs(name, cap_factor)[1]


def layer_params(cfg, seed=0):
    p = TT.init_params(cfg, torch.Generator().manual_seed(seed))
    _, lyr = TT._split_layers(p)
    return {k: v[0] for k, v in lyr.items()}


def test_matches_dense_oracle_no_drops():
    cfg = tiny_moe(8.0)
    lp = layer_params(cfg)
    x = torch.from_numpy(_x((2, 10, cfg.d_model), 1))
    y1, a1 = M.moe_ffn(cfg, lp, x)
    y2, a2 = M.moe_ffn_dense(cfg, lp, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)
    assert abs(float(a1 - a2)) < 1e-6


def test_shared_expert_arch_matches_oracle():
    cfg = tiny_moe(8.0, "qwen2-moe-a2.7b")
    lp = layer_params(cfg)
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 2))
    y1, _ = M.moe_ffn(cfg, lp, x)
    y2, _ = M.moe_ffn_dense(cfg, lp, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 50), S=st.integers(4, 24))
def test_dispatch_conservation(seed, S):
    """Every (token, expert) pair is either placed in exactly one slot with
    its gate weight, or dropped by capacity — never duplicated."""
    cfg = tiny_moe(1.0)
    m = cfg.moe
    gen = torch.Generator().manual_seed(seed)
    probs = torch.softmax(torch.randn((S, m.num_experts), generator=gen), -1)
    gate_vals, ids = torch.topk(probs, m.top_k)
    cap = M.capacity(cfg, S)
    disp, gate_slot = M.dispatch_indices(ids, gate_vals, m.num_experts, cap)
    disp, gate_slot = disp.numpy(), gate_slot.numpy()
    pairs = set()
    for slot, tok in enumerate(disp):
        if tok >= S:
            continue
        e = slot // cap
        assert (tok, e) not in pairs, "duplicate dispatch"
        assert e in ids[tok].tolist()
        pairs.add((tok, e))
        assert gate_slot[slot] > 0
    for e in range(m.num_experts):
        assert (disp[e * cap:(e + 1) * cap] < S).sum() <= cap


def test_capacity_drops_are_graceful():
    """With capacity factor << 1, output degrades but never NaNs."""
    cfg = tiny_moe(0.1)
    lp = layer_params(cfg)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), 3))
    y, aux = M.moe_ffn(cfg, lp, x)
    assert not torch.isnan(y).any()
    assert torch.isfinite(aux)
