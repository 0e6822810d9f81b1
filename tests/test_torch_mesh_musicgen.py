"""MusicGen's cells executed over mesh axes larger than one rank, held
to the JAX package's cells jitted on the same meshes.

Gloo worlds of two and four CPU processes (`tests/_torch_mesh_ranks.py`,
mode "family") run `build_cell`'s train (4 x 16 frames), prefill (4
prompts of 16 frames) and decode (4 greedy steps, each fed its frame)
cells of reduced f32 MusicGen-large on DTensors: the audio frontend's
frames, the transformer's projections, the per-shard paged cache, the
4-codebook head as a column-parallel projection and its greedy tokens
over vocab-split logits (`steps._greedy`). The reference's cells run
jitted on its `make_test_mesh(data, model)` over as many XLA host
devices (`tests/_torch_mesh_families.py`). Meshes (2, 1), (1, 2) and,
at d_model 96 (6 heads of 16), (1, 4) for the train and prefill cells:
GSPMD pads the heads to 8. Its decode cell is not run there: 6 kv heads
do not divide 4 ranks, so the pool is split over head_dim, which the
paged kernel's per-shard call refuses (`transformer._paged_kernel`).

Held: the train state, loss and grad norm within 1e-5, every
gradient within 4x its rounding floor; prefill logits and cache within
1e-5; decode tokens (B, 1, 4 codebooks a step) equal."""
import numpy as np
import pytest

import _torch_mesh_families as fam

MG = "musicgen-large"
SPECS = {
    "2x1": dict(arch=MG, data=2, model=1),
    "1x2": dict(arch=MG, data=1, model=2),
    "pad_1x4": dict(arch=MG, data=1, model=4, d_model=96, heads=6,
                    cells="train,prefill"),
}
MESHES = list(SPECS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.Runs(SPECS, tmp_path_factory.mktemp("mesh_musicgen"))


@pytest.mark.parametrize("name", MESHES)
def test_train_cell_matches_reference(name, runs):
    ranks, ref, inp = runs.get(name)
    fam.check_train(ranks, ref, inp, fam.strict_gn_tol(ref))


@pytest.mark.parametrize("name", MESHES)
def test_train_gradients_within_rounding_floor(name, runs):
    ranks, ref, inp = runs.get(name)
    plain, floors = fam.rounding_floor(inp)
    for got in ranks + [ref]:
        fam.check_floor(got, inp, plain, floors)


@pytest.mark.parametrize("name", MESHES)
def test_prefill_cell_matches_reference(name, runs):
    ranks, ref, _ = runs.get(name)
    fam.check_prefill(ranks, ref)


@pytest.mark.parametrize("name", ["2x1", "1x2"])
def test_decode_codebook_tokens_equal_reference(name, runs):
    ranks, ref, _ = runs.get(name)
    assert ref["tokens"].shape == (4, 5, 1, 4)
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
    ranks, _, _ = runs.get("pad_1x4")
    assert fam.check_padded(ranks, 4)


def test_codebook_head_is_split_over_vocab(runs):
    """The 4-codebook head's columns split over `model` at (1, 2): each
    rank holds half of every codebook's vocab."""
    ranks, _, inp = runs.get("1x2")
    heads = [k for k in ranks[0] if k.startswith("local/train/params/")
             and "head" in k]
    assert heads
    for k in heads:
        whole = inp["p/" + k[len("local/train/params/"):]].shape
        assert tuple(ranks[0][k]) != whole, (k, whole)
