"""The port's transformer held to the JAX package's on reduced configs in
f32, with the reference's own `init_params` weights carried over through
`params_from_numpy`: forward logits, prefill logits and caches, and
decode steps over both cache layouts (paged through the reference's
gather on the CPU, contiguous), all within 1e-4; plus the reference's
decode-vs-teacher-forcing check (tests/test_models_smoke.py) for the
dense, vlm and audio families (the MoE family's are in
tests/test_torch_moe.py and tests/test_torch_models_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import build_model as jbuild
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
TRANSFORMER_ARCHS = [n for n in ARCH_NAMES
                     if get_config(n).family in ("dense", "vlm", "audio")]


def _cfgs(name):
    j = dataclasses.replace(jreduced(jget_config(name)), dtype="float32")
    t = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _models(name, **kw):
    jcfg, tcfg = _cfgs(name)
    jm, tm = jbuild(jcfg, **kw), build_model(tcfg, **kw)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jm, tm, jp, tp


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_prefill_and_decode_match_reference(name, layout):
    jm, tm, jp, tp = _models(name, kv_layout=layout, page_size=4)
    rng = np.random.default_rng(1)
    B, S, steps = 2, 10, 4
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S + steps)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_len=16)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    if layout == "paged":
        assert torch.equal(tc["block_table"],
                           torch.from_numpy(np.array(jc["block_table"])))
    k_pool = tc["k"]
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode_step(jp, {"token": jnp.asarray(tok)}, jc)
        tl, tc = tm.decode_step(tp, {"token": torch.from_numpy(tok)}, tc)
        _close(tl, jl)
        assert int(tc["len"]) == int(jc["len"]) == S + i + 1
        assert tc["k"] is k_pool                 # updated in place
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("impl", ["masked", "tri"])
def test_forward_matches_reference(name, impl):
    jm, tm, jp, tp = _models(name, attn_impl=impl)
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert aux == 0.0
    _close(tl, jl)


def test_paged_cache_helpers_match_reference():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((3, 5, 4, 2, 8)).astype(np.float32)
    table = np.stack([rng.permutation(5) for _ in range(3)]).astype(np.int32)
    _close(TT._gather_pages(torch.from_numpy(pool), torch.from_numpy(table)),
           JT._gather_pages(jnp.asarray(pool), jnp.asarray(table)))
    val = rng.standard_normal((3, 2, 8)).astype(np.float32)
    for pos in (0, 7, 19):
        want = JT._scatter_token(jnp.asarray(pool), jnp.asarray(table),
                                 jnp.asarray(pos, jnp.int32),
                                 jnp.asarray(val))
        tpool = torch.from_numpy(pool.copy())
        got = TT._scatter_token(tpool, torch.from_numpy(table),
                                torch.tensor(pos, dtype=torch.int32),
                                torch.from_numpy(val))
        assert got is tpool                      # written in place
        _close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
def test_param_specs_and_counts_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    assert TT.param_specs(tcfg) == JT.param_specs(jcfg)
    tm, jm = build_model(tcfg), jbuild(jcfg)
    assert tm.param_count() == jm.param_count()
    params = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: s for k, (s, _) in JT.param_specs(jcfg).items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    assert torch.equal(params["final_norm"],
                       torch.ones_like(params["final_norm"]))
    # normal * 1/sqrt(fan_in), fan_in = shape[-2] (the padded vocab for
    # the embedding, as in the reference)
    emb = params["embed"]
    assert abs(float(emb.std()) * np.sqrt(emb.shape[0]) - 1.0) < 0.05


@pytest.mark.parametrize("name", TRANSFORMER_ARCHS)
def test_decode_matches_teacher_forcing(name):
    """tests/test_models_smoke.py::test_decode_matches_teacher_forcing on
    the port, with the reference's weights."""
    jm, m, jp, params = _models(name, kv_layout="paged", page_size=4)
    cfg = m.cfg
    B, S = 2, 12
    rng = np.random.default_rng(1)
    if cfg.frontend.kind == "audio":
        emb = torch.from_numpy(rng.standard_normal(
            (B, S + 1, cfg.d_model)).astype(np.float32))
        full, _ = m.forward(params, {"frame_embeds": emb})
        _, cache = m.prefill(params, {"frame_embeds": emb[:, :S]},
                             max_len=16)
        lg, _ = m.decode_step(params, {"frame_embed": emb[:, S:S + 1]},
                              cache)
    elif cfg.frontend.kind == "vlm":
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
        pe = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend.num_prefix_embeds,
             cfg.frontend.patch_embed_dim)).astype(np.float32))
        full, _ = m.forward(params, {"tokens": toks, "patch_embeds": pe})
        _, cache = m.prefill(params, {"tokens": toks[:, :S],
                                      "patch_embeds": pe}, max_len=32)
        lg, _ = m.decode_step(params, {"token": toks[:, S:S + 1]}, cache)
    else:
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
        full, _ = m.forward(params, {"tokens": toks})
        _, cache = m.prefill(params, {"tokens": toks[:, :S]}, max_len=16)
        lg, _ = m.decode_step(params, {"token": toks[:, S:S + 1]}, cache)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    assert err < 5e-4, f"{name}: decode mismatch {err}"


def test_init_cache_layouts():
    _, tcfg = _cfgs("qwen3-1.7b")
    m = build_model(tcfg, kv_layout="paged", page_size=4)
    c = m.init_cache(2, 10, device="cpu")
    assert tuple(c["k"].shape) == (2, 2, 3, 4, tcfg.num_kv_heads,
                                   tcfg.head_dim)
    assert c["block_table"].tolist() == [[0, 1, 2]] * 2
    c = build_model(tcfg, kv_layout="contiguous").init_cache(2, 10,
                                                             device="cpu")
    assert tuple(c["k"].shape) == (2, 2, 10, tcfg.num_kv_heads,
                                   tcfg.head_dim)
    assert int(c["len"]) == 0


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_count_tree_matches_reference(name):
    """Every architecture's reduced params, abstract in both packages and
    nested in a tree, counted element for element."""
    jcfg = jreduced(jget_config(name))
    tcfg = reduced(get_config(name))
    jp, tp = jbuild(jcfg).abstract_params(), build_model(tcfg) \
        .abstract_params()
    want = JT.param_count_tree(jp)
    assert TT.param_count_tree(tp) == want
    assert TT.param_count_tree({"params": tp, "copies": [tp, (tp,)]}) \
        == 3 * want
