"""The four architectures of the MoE, ssm (RWKV6) and hybrid (RG-LRU)
families on the port, at reduced sizes in f32 on the CPU.

Held to the JAX package with the reference's own weights carried over
by `params_from_numpy` (and its train state by `train_state_from_numpy`):
`forward`, `loss_fn`, `prefill` (logits and every state leaf) and four
`decode_step`s within 1e-4, one `make_train_step` step over 2
microbatches within 1e-5 (as tests/test_torch_train.py). Then
tests/test_models_smoke.py's cases run against the port for these
architectures (forward and loss finite, one train step moves every
parameter, decode equal to teacher forcing within 5e-4), and
`build_model` runs all ten architectures of `ARCH_NAMES`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import build_model as jbuild
from repro_torch.configs import ARCH_NAMES, ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

NEW_ARCHS = [n for n in ARCH_NAMES
             if get_config(n).family in ("moe", "ssm", "hybrid")]
# recurrentgemma needs a full (rec, rec, attn) unit; 5 layers add the
# (rec, rec) tail of the published 26
LAYERS = {"recurrentgemma-2b": 5}
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")


def _tiny(cfg, reduce, layers):
    cfg = dataclasses.replace(reduce(cfg, layers=layers), dtype="float32")
    if cfg.moe is not None:
        # drop-free capacity so decode == teacher forcing exactly
        # (capacity drops are held to the reference in test_torch_moe.py)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _cfgs(name, layers=None):
    layers = layers or LAYERS.get(name, 2)
    j = _tiny(jget_config(name), jreduced, layers)
    t = _tiny(get_config(name), reduced, layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    """The reference's init_params (PRNGKey 0) of the reduced config, as
    numpy (drawn once per architecture: every test reads the same)."""
    jm = jbuild(_cfgs(name)[0])
    return {k: np.asarray(v) for k, v in
            jax.jit(jm.init_params)(jax.random.PRNGKey(0)).items()}


def _models(name, **kw):
    jcfg, tcfg = _cfgs(name)
    jm, tm = jbuild(jcfg, **kw), build_model(tcfg, **kw)
    arrays = _reference_params(name)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jm, tm, jp, params_from_numpy(arrays, device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(train_state_to_numpy(got), np.asarray(want),
                               **(tol or TOL))


def _close_tree(got, want, **tol):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _close_tree(got[key], want[key], **tol)
        else:
            assert tuple(got[key].shape) == want[key].shape, key
            _close(got[key], want[key], **tol)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_forward_and_loss_match_reference(name):
    jm, tm, jp, tp = _models(name)
    toks = _tokens(tm.cfg, 2, 21, 2)
    labels = _tokens(tm.cfg, 2, 21, 3)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jloss, jmet = jax.jit(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})
    tloss, tmet = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert tloss.dim() == 0
    _close(tloss, jloss)
    _close(tmet["ce"], jmet["ce"])
    _close(torch.as_tensor(tmet["aux"]), jmet["aux"], atol=1e-6)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_prefill_and_decode_match_reference(name):
    """A 37-token prompt (past the reduced RG-LRU window of 32, not a
    multiple of it), then four decode steps; logits and every state or
    cache leaf."""
    jm, tm, jp, tp = _models(name, page_size=8)
    B, S, steps = 2, 37, 4
    toks = _tokens(tm.cfg, B, S + steps, 1)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=48))(
        jp, {"tokens": jnp.asarray(toks[:, :S])})
    jdecode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_len=48)
    _close(tl, jl)
    _close_tree(tc, jc)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, {"token": jnp.asarray(tok)}, jc)
        tl, tc = tm.decode_step(tp, {"token": torch.from_numpy(tok)}, tc)
        _close(tl, jl)
        assert tc["len"].dtype == torch.int32 and tc["len"].dim() == 0
        assert int(tc["len"]) == int(jc["len"]) == S + i + 1
    _close_tree(tc, jc)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_train_step_matches_reference(name):
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import adamw as jadamw
    jm, tm, jp, _ = _models(name)
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tstate = train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    batch = make_batch(tm.cfg, SHAPE, step=0, num_microbatches=2, seed=2)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    tcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    jnew, jo, jmet = jax.jit(jmake(jm, jcfg))(
        jstate["params"], jstate["opt"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, to, tmet = make_train_step(tm, tcfg)(
        tstate["params"], tstate["opt"],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tmet["loss"], jmet["loss"], **STEP_TOL)
    # the grad norm sums every gradient: the MoE models' (granite's
    # attention outputs differ between the packages by 5e-6 of their
    # scale, its embedding gradient by 4e-5) differ by 1.5e-5 of it
    _close(tmet["grad_norm"], jmet["grad_norm"], rtol=3e-5, atol=0)
    for part in ("mu", "nu"):
        _close_tree(to[part], jo[part], **STEP_TOL)
    # an element whose gradient is within f32 rounding of zero (nonzero,
    # below 1e-6 of its tensor's largest) takes the sign of rounding
    # noise in Adam's m / (sqrt(v) + eps), in either package: those
    # elements are left out of the updated weights' comparison, and
    # there are few
    noisy = 0
    for k, want in jnew.items():
        g = np.abs(np.asarray(jo["mu"][k]))
        live = (g == 0) | (g >= 1e-6 * g.max())
        noisy += int((~live).sum())
        for got, ref in ((tnew[k], want), (to["master"][k], jo["master"][k])):
            np.testing.assert_allclose(train_state_to_numpy(got)[live],
                                       np.asarray(ref)[live], **STEP_TOL)
    assert noisy <= 1e-3 * sum(v.size for v in jnew.values()), noisy
    assert int(to["count"]) == int(jo["count"]) == 1


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_param_specs_and_counts_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    tm, jm = build_model(tcfg), jbuild(jcfg)
    assert tm.param_count() == jm.param_count()
    params = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jm.abstract_params().items()}
    full = get_config(name)
    jfull = jget_config(name)
    assert build_model(full).param_count() == jbuild(jfull).param_count()


# ---- tests/test_models_smoke.py's cases against the port -----------------

def make_train_batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
            "labels": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_forward_and_loss_no_nan(name):
    cfg = _cfgs(name)[1]
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0))
    batch = make_train_batch(cfg)
    loss, _ = m.loss_fn(params, batch)
    assert torch.isfinite(loss), name
    logits, _ = m.forward(params, batch)
    assert not torch.isnan(logits).any(), name
    assert logits.shape[-1] >= cfg.vocab_size   # padded vocab


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_one_train_step_updates_params(name):
    cfg = _cfgs(name)[1]
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0))
    opt = adamw.adamw_init(params)
    batch = {k: v[None] for k, v in make_train_batch(cfg).items()}
    step = make_train_step(m, adamw.AdamWConfig(lr=1e-3, warmup_steps=1))
    new_params, _, metrics = step(params, opt, batch)
    assert torch.isfinite(metrics["loss"]) and \
        torch.isfinite(metrics["grad_norm"]), name
    delta = max(float((a - new_params[k]).abs().max())
                for k, a in params.items())
    assert delta > 0, f"{name}: params unchanged"
    assert not any(torch.isnan(p).any() for p in new_params.values()), name


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_decode_matches_teacher_forcing(name):
    """tests/test_models_smoke.py::test_decode_matches_teacher_forcing on
    the port (wkv_impl="scan"), with the reference's weights."""
    _, m, _, params = _models(name, page_size=4, wkv_impl="scan")
    B, S = 2, 12
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, m.cfg.vocab_size, (B, S + 1)).astype(np.int32))
    full, _ = m.forward(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :S]}, max_len=16)
    lg, _ = m.decode_step(params, {"token": toks[:, S:S + 1]}, cache)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    assert err < 5e-4, f"{name}: decode mismatch {err}"


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend.kind == "audio":
        return {"frame_embeds": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))}
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.frontend.kind == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend.num_prefix_embeds,
             cfg.frontend.patch_embed_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_build_model_runs_every_architecture(name):
    """build_model builds each of the ten architectures; forward, loss_fn,
    prefill and decode_step run on its reduced config on the CPU."""
    cfg = _cfgs(name)[1] if name in NEW_ARCHS else dataclasses.replace(
        reduced(get_config(name)), dtype="float32")
    m = build_model(cfg, page_size=4)
    params = m.init_params(torch.Generator().manual_seed(1))
    B, S = 2, 8
    batch = _inputs(cfg, B, S, 4)
    logits, _ = m.forward(params, batch)
    assert torch.isfinite(logits.float()).all()
    labels_shape = logits.shape[:-1]
    labels = torch.zeros(labels_shape, dtype=torch.int32)
    loss, _ = m.loss_fn(params, dict(batch, labels=labels))
    assert torch.isfinite(loss)
    _, cache = m.prefill(params, batch, max_len=16)
    if cfg.frontend.kind == "audio":
        step = {"frame_embed": batch["frame_embeds"][:, -1:]}
    else:
        step = {"token": batch["tokens"][:, -1:]}
    lg, cache = m.decode_step(params, step, cache)
    assert torch.isfinite(lg.float()).all()
    assert int(cache["len"]) == logits.shape[1] + 1 + (
        cfg.frontend.num_prefix_embeds if cfg.frontend.kind == "vlm" else 0)
    fresh = m.init_cache(B, 16, device="cpu")
    assert int(fresh["len"]) == 0


@pytest.mark.parametrize("name", ["rwkv6-3b", "recurrentgemma-2b"])
def test_recurrent_state_defaults_to_the_card(name):
    """init_cache (the families' init_state) allocates on the card unless
    the caller asks for another device."""
    m = build_model(_cfgs(name)[1])
    cpu = m.init_cache(2, 16, device="cpu")
    leaves = [t for v in cpu.values()
              for t in (v.values() if isinstance(v, dict) else [v])]
    assert all(t.device.type == "cpu" for t in leaves)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        m.init_cache(2, 16)
