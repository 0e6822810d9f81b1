"""The port's int8 error-feedback gradient compression held to the JAX
package's `optim/compression.py`.

`quantize_int8` bit for bit (q and the scale) on seeded numpy inputs,
values that fall exactly on a half included (both round half to even);
`dequantize` and `compress_decompress` bit for bit; error feedback
converging on a repeated gradient (the reference test's bound, 1e-4,
and every round bit for bit); `psum_compressed` over two gloo CPU
processes against the reference evaluated as
`vmap(psum_compressed, axis_name="pod")`: the new errors bit for bit,
the mean within 2 ulp of its f32 value (rtol 2.4e-7: both reduce
s0 q0 + s1 q1, in an order each library picks), bit-identical on the two
ranks; with one rank the exchange returns g + e's round trip exactly;
`dcn_bytes_per_step` equal to the reference's."""
import numpy as np
import pytest
import torch

import _torch_pods
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.optim import compression as C

MEAN_RTOL = 2.4e-7              # 2 ulp of f32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(1000).astype(np.float32) * 3.0,
          rng.standard_normal((17, 33)).astype(np.float32) * 1e-3,
          (rng.standard_normal((4, 8, 16)) * 1e6).astype(np.float32),
          np.zeros(5, np.float32)]
    # exact halves of the scale: round half to even decides q
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5],
                      np.float32)
    xs.append(halves)
    return xs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bit_for_bit(seed):
    from repro.optim import compression as JC
    for x in _inputs(seed):
        jq, js = JC.quantize_int8(x)
        tq, ts = C.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        jx = np.asarray(JC.dequantize(jq, js))
        np.testing.assert_array_equal(C.dequantize(tq, ts).numpy(), jx)
        jh, je = JC.compress_decompress(x)
        th, te = C.compress_decompress(torch.from_numpy(x))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        # error bounded by half an LSB
        assert float((torch.from_numpy(x) - th).abs().max()) \
            <= float(ts) * 0.5 + 1e-6


def test_error_feedback_accumulates_to_truth():
    from repro.optim import compression as JC
    g = np.random.default_rng(1).standard_normal(512).astype(
        np.float32) * 0.01
    tg = torch.from_numpy(g)
    err, sent = torch.zeros_like(tg), torch.zeros_like(tg)
    jerr, jsent = np.zeros_like(g), np.zeros_like(g)
    for _ in range(20):
        xhat, err = C.compress_decompress(tg + err)
        sent = sent + xhat
        jxhat, jerr = JC.compress_decompress(g + jerr)
        jsent = np.asarray(jsent + jxhat)
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(sent.numpy(), jsent)
    np.testing.assert_allclose((sent / 20).numpy(), g, atol=1e-4)


def test_psum_compressed_two_pods_matches_reference(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.optim import compression as JC
    rng = np.random.default_rng(7)
    shapes = {"a": (64,), "b": (8, 24), "c": (3, 5, 7)}
    g = {k: rng.standard_normal((2,) + s).astype(np.float32)
         for k, s in shapes.items()}
    e = {k: (rng.standard_normal((2,) + s) * 1e-3).astype(np.float32)
         for k, s in shapes.items()}
    for r in range(2):
        np.savez(tmp_path / f"in_r{r}.npz",
                 **{f"g/{k}": v[r] for k, v in g.items()},
                 **{f"e/{k}": v[r] for k, v in e.items()})
    ranks = _torch_pods.run("psum", tmp_path)
    jmean, jerr = jax.vmap(lambda gg, ee: JC.psum_compressed(gg, "pod", ee),
                           axis_name="pod")(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()})
    for k in shapes:
        np.testing.assert_array_equal(ranks[0][f"mean/{k}"],
                                      ranks[1][f"mean/{k}"])
        for r in range(2):
            np.testing.assert_array_equal(ranks[r][f"err/{k}"],
                                          np.asarray(jerr[k])[r])
            np.testing.assert_allclose(ranks[r][f"mean/{k}"],
                                       np.asarray(jmean[k])[r],
                                       rtol=MEAN_RTOL, atol=0)


def test_psum_compressed_single_rank_identity():
    mesh = make_test_mesh(1, 1, device="cpu")
    group = mesh.group("data")
    gen = torch.Generator().manual_seed(2)
    g = {"w": torch.randn(64, generator=gen)}
    e = {"w": torch.randn(64, generator=gen) * 1e-3}
    out, new_e = C.psum_compressed(g, group, e)
    xhat, resid = C.compress_decompress(g["w"] + e["w"])
    assert torch.equal(out["w"], xhat) and torch.equal(new_e["w"], resid)
    np.testing.assert_allclose((out["w"] + new_e["w"]).numpy(),
                               (g["w"] + e["w"]).numpy(), atol=1e-5)


def test_dcn_bytes_per_step():
    import jax.numpy as jnp
    from repro.models import build_model as jbuild_model
    from repro.optim import compression as JC
    params = {"a": torch.zeros(1000), "b": torch.zeros(50, 50)}
    full = C.dcn_bytes_per_step(params, compressed=False)
    comp = C.dcn_bytes_per_step(params, compressed=True)
    assert full == 4 * 3500
    assert comp < full / 3.9
    jparams = {"a": jnp.zeros((1000,)), "b": jnp.zeros((50, 50))}
    assert (full, comp) == (JC.dcn_bytes_per_step(jparams, compressed=False),
                            JC.dcn_bytes_per_step(jparams, compressed=True))
    # Qwen1.5-0.5B at full width, from meta tensors: 463,987,712 params
    from repro.configs import get_config as jget_config
    ap = build_model(get_config("qwen1.5-0.5b")).abstract_params()
    jap = jbuild_model(jget_config("qwen1.5-0.5b")).abstract_params()
    for compressed in (False, True):
        assert C.dcn_bytes_per_step(ap, compressed=compressed) == \
            JC.dcn_bytes_per_step(jap, compressed=compressed)
    assert C.dcn_bytes_per_step(ap, compressed=True) == \
        463_987_712 + 4 * len(ap)
