"""RWKV6's cells executed over mesh axes larger than one rank, held to
the JAX package's cells jitted on the same meshes.

Gloo worlds of two and four CPU processes (`tests/_torch_mesh_ranks.py`,
mode "family") run `build_cell`'s train (4 x 16 tokens), prefill (4
prompts of 16) and decode (4 greedy steps) cells of reduced f32
RWKV6-3B on DTensors: each rank's heads of the time mix
(`rwkv6._heads_local`, r/k/v/g gathered over `model` first), the
channel mix's projections, the vocab-parallel lookup, RMSNorm on each
rank's rows. The reference's cells run jitted on its
`make_test_mesh(data, model)` over as many XLA host devices
(`tests/_torch_mesh_families.py`). Meshes (2, 1), (1, 2) and, at d_model
96 (6 heads of 16), (1, 4): GSPMD pads the heads to 8, two a rank.

The train state is held within 1e-5, but the grad norm is not: the
WKV's backward amplifies rounding, so any reordering of f32 sums moves
the gradients upstream of the final norm by a few 1e-5 (the reference's
own grad norm is 9.747210 on one device, 9.747366 on (1, 2) and
9.747654 on (2, 1)). So the grad norm is held within the reference's own
spread between its meshes and no looser (`fam.grad_norm_tol`), and
rounding is told from a fault by the rounding floor: perturbing every
param by f32's unit roundoff moves each gradient about as far as the
mesh does (`fam.rounding_floor`: 6.3e-5 of the grad norm), and every
gradient of the mesh, and of the reference, sits within 4x of that
floor; a lost or doubled term would sit orders of magnitude past it.
Prefill logits and state within 1e-5, decode tokens equal."""
import numpy as np
import pytest

import _torch_mesh_families as fam

RWKV = "rwkv6-3b"
SPECS = {
    "2x1": dict(arch=RWKV, data=2, model=1, single=True),
    "1x2": dict(arch=RWKV, data=1, model=2),
    "pad_1x4": dict(arch=RWKV, data=1, model=4, d_model=96, heads=6,
                    single=True),
}
CONFIGS = {"2x1": ["2x1", "1x2"], "1x2": ["2x1", "1x2"],
           "pad_1x4": ["pad_1x4"]}
MESHES = list(SPECS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.Runs(SPECS, tmp_path_factory.mktemp("mesh_rwkv"))


@pytest.mark.parametrize("name", MESHES)
def test_train_cell_matches_reference(name, runs):
    ranks, ref, inp = runs.get(name)
    refs = [runs.get(n)[1] for n in CONFIGS[name]]
    fam.check_train(ranks, ref, inp, fam.grad_norm_tol(refs))


@pytest.mark.parametrize("name", MESHES)
def test_train_gradients_within_rounding_floor(name, runs):
    ranks, ref, inp = runs.get(name)
    plain, floors = fam.rounding_floor(inp)
    for got in ranks + [ref]:
        fam.check_floor(got, inp, plain, floors)


def test_rounding_floor_sees_a_lost_term(runs):
    """The floor's check fails for gradients that lost a tenth of one
    leaf's (what a dropped partial sum would do), and for the plain
    step's own gradients it passes."""
    ranks, _, inp = runs.get("1x2")
    plain, floors = fam.rounding_floor(inp)
    got = dict(ranks[0])
    k = "layers/u"
    got[f"mu/{k}"] = got[f"mu/{k}"] * np.float32(0.9)
    with pytest.raises(AssertionError):
        fam.check_floor(got, inp, plain, floors)


@pytest.mark.parametrize("name", MESHES)
def test_prefill_cell_matches_reference(name, runs):
    ranks, ref, _ = runs.get(name)
    fam.check_prefill(ranks, ref)


@pytest.mark.parametrize("name", MESHES)
def test_decode_tokens_equal_reference(name, runs):
    ranks, ref, _ = runs.get(name)
    assert ref["tokens"].shape[:2] == (4, 5)
    for got in ranks:
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])


@pytest.mark.parametrize("name", MESHES)
def test_plain_tensors_are_the_same_on_every_rank(name, runs):
    ranks, _, _ = runs.get(name)
    assert fam.check_plain_tensors(ranks)


@pytest.mark.parametrize("name", MESHES)
def test_each_rank_holds_its_part_of_every_leaf(name, runs):
    ranks, _, inp = runs.get(name)
    for tag in ("train/params", "serve/params"):
        assert fam.check_local_shapes(ranks, inp, tag)


def test_padded_heads_are_gspmds_shares(runs):
    """6 heads over 4 ranks: 2 a rank at rank * 2 (r, k, v, g, u and the
    state), the last rank's past the end."""
    ranks, _, _ = runs.get("pad_1x4")
    assert fam.check_padded(ranks, 4)
