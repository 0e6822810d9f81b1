"""One `make_train_step` step of the architectures that neither
tests/test_torch_train.py nor tests/test_torch_models_smoke.py steps:
Qwen3-14B and Qwen1.5-110B (dense), InternVL2-1B (vlm) and
MusicGen-large (audio), at reduced sizes in f32 on the CPU, held to the
JAX package's step on the reference's own train state (carried over by
`convert.train_state_from_numpy`) at rtol = atol = 1e-5: loss, grad norm,
every new parameter and every `mu` / `nu` / `master` leaf.

MusicGen's loss does not use its token embedding (its frontend embeds
frames): `jax.grad` gives that leaf a zero gradient and AdamW decays it,
so the port's step must too (`launch/steps._mean_grads`)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

ARCHS = ["qwen3-14b", "qwen1.5-110b", "internvl2-1b", "musicgen-large"]
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want):
    np.testing.assert_allclose(train_state_to_numpy(got), np.asarray(want),
                               **STEP_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.launch.steps import make_train_step as jmake
    from repro.models import build_model as jbuild
    from repro.optim import adamw as jadamw
    jcfg = dataclasses.replace(jreduced(jget_config(name)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tstate = train_state_from_numpy(_numpy_tree(jstate), device="cpu")
    batch = make_batch(tm.cfg, SHAPE, step=0, num_microbatches=2, seed=2)
    jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    topt = adamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    jnew, jo, jmet = jax.jit(jmake(jm, jopt))(
        jstate["params"], jstate["opt"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, to, tmet = make_train_step(tm, topt)(
        tstate["params"], tstate["opt"],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "lr"):
        _close(tmet[key], jmet[key])
    # the raw gradient's norm, before clipping, sums f32 rounding over
    # every gradient: Qwen1.5-110B's reads 22.028498 in the port and
    # 22.028086 in the reference, either side of the port's float64
    # recomputation, 22.028375 (tests/test_torch_models_smoke.py holds
    # the MoE models' norm at the same 3e-5)
    np.testing.assert_allclose(train_state_to_numpy(tmet["grad_norm"]),
                               np.asarray(jmet["grad_norm"]), rtol=3e-5,
                               atol=0)
    assert set(tnew) == set(jnew)
    for k in jnew:
        _close(tnew[k], jnew[k])
    for part in ("mu", "nu", "master"):
        assert set(to[part]) == set(jo[part])
        for k in jo[part]:
            _close(to[part][k], jo[part][k])
    assert int(to["count"]) == int(jo["count"]) == 1
    if tcfg.frontend.kind == "audio":
        # the unused embedding: no moment, decayed weights
        assert not to["mu"]["embed"].any() and not to["nu"]["embed"].any()
        before = tstate["params"]["embed"]
        assert not torch.equal(tnew["embed"], before)
        assert torch.all(tnew["embed"].abs() <= before.abs())
