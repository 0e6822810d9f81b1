"""The MoE cells executed over mesh axes larger than one rank, held to
the JAX package's cells jitted on the same meshes.

Gloo worlds of two and four CPU processes (`tests/_torch_mesh_ranks.py`,
mode "family", one rank per process) run `build_cell`'s train (4 x 16
tokens), prefill (4 prompts of 16) and decode (4 greedy steps) cells of
reduced f32 MoE configs on DTensors; the reference's cells run jitted
with their shardings on its `make_test_mesh(data, model)` over as many
XLA host devices, in a subprocess (`tests/_torch_mesh_families.py`).
Both shardings: Qwen1.5-MoE's `ffn` (each rank a slice of every
expert's hidden dim) on (2, 1), (1, 2) and (2, 2), and Granite-MoE's
`expert` (each rank its own experts, `moe._experts_local`) on (2, 1),
(1, 2) and, with 6 experts, on (1, 4): GSPMD pads the experts to 8, two a
rank, the last rank's all padding.

Held: the new params, AdamW moments and master copy and the loss within
1e-5; the grad norm within 1e-5, Granite's on (2, 1) and (1, 2)
within the larger of 1e-5 and the reference's own spread between those
meshes (the router's top-k turns rounding into ~3e-5 of it: the
reference's is 23.559448 on (1, 2), 23.560156 on (2, 1));
every gradient within 4x its rounding floor of the plain step's;
prefill logits and cache within 1e-5; the decode tokens equal; the plain
tensors that meet DTensors (the capacity slots, the decode position)
equal on every rank; each rank's part of every leaf as the reference's
rules split it, and of the padded experts as GSPMD pads them."""
import numpy as np
import pytest

import _torch_mesh_families as fam

QWEN, GRANITE = "qwen2-moe-a2.7b", "granite-moe-1b-a400m"
SPECS = {
    "ffn_2x1": dict(arch=QWEN, data=2, model=1),
    "ffn_1x2": dict(arch=QWEN, data=1, model=2),
    "ffn_2x2": dict(arch=QWEN, data=2, model=2),
    "expert_2x1": dict(arch=GRANITE, data=2, model=1, single=True),
    "expert_1x2": dict(arch=GRANITE, data=1, model=2),
    "expert_pad_1x4": dict(arch=GRANITE, data=1, model=4, experts=6),
}
MESHES = list(SPECS)
# Granite's grad norm on (1, 2) sits 6.2e-4 from the reference's there
# (23.560068 / 23.559448), past 1e-5 (2.5e-4 at this norm), and the
# reference's own meshes sit 7.1e-4 apart: held, as RWKV6's, within
# that spread; Qwen1.5-MoE's and the padded Granite's hold at 1e-5
SPREAD = ["expert_2x1", "expert_1x2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.Runs(SPECS, tmp_path_factory.mktemp("mesh_moe"))


@pytest.mark.parametrize("name", MESHES)
def test_train_cell_matches_reference(name, runs):
    ranks, ref, inp = runs.get(name)
    tol = (fam.grad_norm_tol([runs.get(n)[1] for n in SPREAD])
           if name in SPREAD else fam.strict_gn_tol(ref))
    fam.check_train(ranks, ref, inp, tol)


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


def test_padded_experts_are_gspmds_shares(runs):
    """6 experts over 4 ranks: 2 a rank at rank * 2, zero experts past
    the end on the last rank (its weights, dispatch slots and gates)."""
    ranks, _, _ = runs.get("expert_pad_1x4")
    assert fam.check_padded(ranks, 4)


def test_expert_sharding_splits_the_experts(runs):
    """Under `expert` sharding each rank of (1, 2) holds half the experts
    of each expert weight; under `ffn` half of each expert's hidden dim."""
    ranks, _, inp = runs.get("expert_1x2")
    E = inp["p/layers/we_gate"].shape[1]
    assert ranks[0]["local/train/params/layers/we_gate"][1] == E // 2
    ranks, _, inp = runs.get("ffn_1x2")
    F = inp["p/layers/we_gate"].shape[-1]
    assert ranks[0]["local/train/params/layers/we_gate"][-1] == F // 2
