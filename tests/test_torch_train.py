"""The port's training path held to the JAX package's on reduced configs
in f32: the loss (`softmax_cross_entropy`, `loss_fn`), one
`make_train_step` step over 2 microbatches (loss, grad norm, new params
and the new `mu`/`nu`/`master`/`count`) at rtol = atol = 1e-5, with the
reference's weights and optimizer state carried over by
`convert.train_state_from_numpy`; the data pipeline bit for bit; remat
against no remat; the RMSNorm gradient (plain backward on the CPU, the
kernel's autograd Function against the plain version's gradients on the
card, `-m cuda`); and the launcher's CPU run and its refusal without a
card.

The JAX package is imported inside the parity tests only, so the CUDA
test runs on a machine that has no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import TokenPipeline, make_batch
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm.ops import rms_norm_backward, rms_norm_op
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import make_store_for_checkpoints, train
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen1.5-0.5b", "qwen3-1.7b"]
SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfgs(name):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    j = dataclasses.replace(jreduced(jget_config(name)), dtype="float32")
    t = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _reference_state(name, seed=0):
    """Both packages' models and the reference's initial train state
    ({"params", "opt"}), as JAX arrays and carried over to the port."""
    import jax
    from repro.models import build_model as jbuild
    from repro.optim import adamw as jadamw
    jcfg, tcfg = _cfgs(name)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tstate = train_state_from_numpy(_numpy_tree(jstate), device="cpu")
    return jm, tm, jstate, tstate


def _close(got, want, **tol):
    np.testing.assert_allclose(train_state_to_numpy(got), np.asarray(want),
                               **(tol or TOL))


def test_make_batch_matches_reference():
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.data.pipeline import TokenPipeline as JPipe
    for name in ("qwen1.5-0.5b", "internvl2-1b", "musicgen-large"):
        jcfg, tcfg = jreduced(jget_config(name)), reduced(get_config(name))
        shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
        jpipe = JPipe(jcfg, shape, num_microbatches=2, seed=5, start_step=3)
        tpipe = TokenPipeline(tcfg, shape, num_microbatches=2, seed=5,
                              start_step=3)
        for _ in range(2):
            want, got = next(jpipe), next(tpipe)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key]), (name, key)
        assert np.array_equal(
            make_batch(tcfg, shape, step=4, num_microbatches=2,
                       seed=5)["labels"], want["labels"])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_cross_entropy_matches_reference(masked, z_loss):
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32) if masked else None

    def jloss(lg):
        return JL.softmax_cross_entropy(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), z_loss)

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = TL.softmax_cross_entropy(
        tl, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss)
    (grad,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want)
    _close(grad, want_grad)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_matches_reference(name):
    import jax.numpy as jnp
    jm, tm, jstate, tstate = _reference_state(name)
    batch = make_batch(tm.cfg, SHAPE, step=0, seed=1)
    mb = {k: v[0] for k, v in batch.items()}
    want, wm = jm.loss_fn(jstate["params"],
                          {k: jnp.asarray(v) for k, v in mb.items()})
    got, gm = tm.loss_fn(tstate["params"],
                         {k: torch.from_numpy(v) for k, v in mb.items()})
    _close(got, want)
    _close(gm["ce"], wm["ce"])
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import adamw as jadamw
    jm, tm, jstate, tstate = _reference_state(name)
    batch = make_batch(tm.cfg, SHAPE, step=0, num_microbatches=2, seed=2)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    tcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, jo, jmet = jax.jit(jmake(jm, jcfg))(
        jstate["params"], jstate["opt"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tmet = make_train_step(tm, tcfg)(
        tstate["params"], tstate["opt"],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        assert tmet[key].dim() == 0
        _close(tmet[key], jmet[key])
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        _close(tp[k], jp[k])
    assert set(to) == set(jo) == {"mu", "nu", "master", "count"}
    for part in ("mu", "nu", "master"):
        assert set(to[part]) == set(jo[part])
        for k in jo[part]:
            _close(to[part][k], jo[part][k])
    assert to["count"].dtype == torch.int32 and to["count"].dim() == 0
    assert int(to["count"]) == int(jo["count"]) == 1
    # the update is functional: the state it was given is unchanged
    assert int(tstate["opt"]["count"]) == 0
    assert not tstate["opt"]["mu"]["embed"].any()


def test_opt_state_layout_matches_reference():
    import jax
    from repro.optim import adamw as jadamw
    _, tm, jstate, tstate = _reference_state("qwen1.5-0.5b")
    mine = adamw.adamw_init(tstate["params"])
    ref = jstate["opt"]
    assert set(mine) == set(ref)
    for part in ("mu", "nu", "master"):
        for k, v in ref[part].items():
            assert mine[part][k].dtype == torch.float32
            assert tuple(mine[part][k].shape) == v.shape
    _close(mine["master"]["embed"], ref["master"]["embed"], rtol=0, atol=0)
    assert mine["master"]["embed"].data_ptr() != \
        tstate["params"]["embed"].data_ptr()
    abstract = adamw.abstract_opt_state(tm.abstract_params())
    jabs = jadamw.abstract_opt_state(jax.eval_shape(
        lambda: jstate["params"]))
    assert abstract["count"].device.type == "meta"
    for part in ("mu", "nu", "master"):
        for k, v in jabs[part].items():
            assert tuple(abstract[part][k].shape) == v.shape


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_gradients(name):
    _, tcfg = _cfgs(name)
    gen = torch.Generator().manual_seed(4)
    params = {k: v.requires_grad_(True)
              for k, v in TT.init_params(tcfg, gen).items()}
    batch = make_batch(tcfg, SHAPE, step=0, seed=6)
    mb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    names = sorted(params)
    grads = {}
    for remat in (True, False):
        loss, _ = TT.loss_fn(tcfg, params, mb, remat=remat)
        grads[remat] = torch.autograd.grad(loss, [params[k] for k in names])
    for k, a, b in zip(names, grads[True], grads[False]):
        assert torch.equal(a, b), k
        assert a.abs().sum() > 0, k     # every parameter gets a gradient


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_autograd_of_plain(dtype):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 7, 256)).astype(
        np.float32)).to(dtype).requires_grad_(True)
    scale = torch.from_numpy((rng.standard_normal(256) * 0.1 + 1.0).astype(
        np.float32)).to(dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((3, 7, 256)).astype(
        np.float32)).to(dtype)
    want = torch.autograd.grad(rms_norm_ref(x, scale, 1e-6), (x, scale), dy)
    got = rms_norm_backward(x.detach(), scale.detach(), 1e-6, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=RMS_TOL[dtype],
                                   atol=RMS_TOL[dtype])
    dx, dscale = rms_norm_backward(x.detach(), scale.detach(), 1e-6, dy,
                                   need_dx=False)
    assert dx is None and dscale is not None


def test_train_cli_runs_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr("sys.argv", [
        "train", "--device", "cpu", "--steps", "3", "--seq-len", "16",
        "--batch", "4", "--checkpoint-every", "2"])
    train_mod.main()
    assert "trained 3 steps" in capsys.readouterr().out


def test_train_and_store_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, SHAPE, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_store_for_checkpoints()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradients_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn((4, 64, 1024), generator=gen, device=cuda_device).to(
        dtype).requires_grad_(True)
    scale = (torch.randn(1024, generator=gen, device=cuda_device) * 0.1
             + 1.0).to(dtype).requires_grad_(True)
    dy = torch.randn((4, 64, 1024), generator=gen, device=cuda_device).to(
        dtype)
    before = rms_kernel.launches
    y = rms_norm_op(x, scale)
    assert rms_kernel.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad(y, (x, scale), dy)
    want = torch.autograd.grad(rms_norm_ref(x, scale), (x, scale), dy)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=RMS_TOL[dtype],
                                   atol=RMS_TOL[dtype])
