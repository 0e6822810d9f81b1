"""RecurrentGemma's cells executed over mesh axes larger than one rank,
held to the JAX package's cells jitted on the same meshes.

Gloo worlds of two and four CPU processes (`tests/_torch_mesh_ranks.py`,
mode "family") run `build_cell`'s train (4 x 16 tokens), prefill (4
prompts of 30) and decode (4 greedy steps, past the 32-token window of
the reduced config) cells of reduced f32 RecurrentGemma-2B at 3 layers
(recurrent, recurrent, attention) on DTensors: the block-diagonal gates
per rank (`rglru._block_diag_local`), the scan on each rank's channels,
the local attention's single kv head split over head_dim at model >= 2
(`kv_even` false), its ring buffer rolled and written per shard
(`_to_ring`, `_ring_write`). The reference's cells run jitted on its
`make_test_mesh(data, model)` over as many XLA host devices
(`tests/_torch_mesh_families.py`). Meshes (2, 1), (1, 2) and, at
d_model 96 (6 heads of 16), (1, 4): GSPMD pads the heads to 8.

Held: the train state, loss and grad norm within 1e-5, every
gradient within 4x its rounding floor; prefill logits and state within
1e-5; decode tokens equal; the plain tensors that meet DTensors (the
ring slot, the segment positions) the same on every rank. On the card
(marked `cuda`): one per-shard decode step on (1, 2), two processes
sharing the card, the tokens the unsharded path's."""
import numpy as np
import pytest
import torch

import _torch_mesh_families as fam
import _torch_mesh_ranks

RG = "recurrentgemma-2b"
BASE = dict(arch=RG, layers=3, prompt=30)
SPECS = {
    "2x1": dict(BASE, data=2, model=1),
    "1x2": dict(BASE, data=1, model=2),
    "pad_1x4": dict(BASE, data=1, model=4, d_model=96, heads=6),
}
MESHES = list(SPECS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.Runs(SPECS, tmp_path_factory.mktemp("mesh_rglru"))


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


@pytest.mark.parametrize("name", MESHES)
def test_decode_past_the_window_equals_reference(name, runs):
    ranks, ref, inp = runs.get(name)
    assert ref["tokens"].shape[:2] == (4, 5)
    # prompt + steps cross the window: the ring wraps
    assert 30 + 4 > 32
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


def test_single_kv_head_splits_over_head_dim(runs):
    """At model = 2 the one kv head does not divide: the decode state's
    ring holds half of head_dim on each rank."""
    ranks, _, inp = runs.get("1x2")
    rings = [k for k in ranks[0] if k.startswith("local/decode/cache/")
             and k.endswith("/k")]
    assert rings
    hd = int(inp["d_model"]) // int(inp["heads"])
    for k in rings:
        assert ranks[0][k][-1] == hd // 2, (k, ranks[0][k])


def test_padded_heads_are_gspmds_shares(runs):
    ranks, _, _ = runs.get("pad_1x4")
    assert fam.check_padded(ranks, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_decode_step_per_shard_on_card(cuda_device, tmp_path):
    """Two processes on the card, mesh (1, 2): one greedy decode step of
    the reduced f32 model's decode cell, its RMSNorm on each rank's
    shard (launches counted), gives the unsharded path's tokens."""
    from repro_torch import configs
    from repro_torch.models import build_model
    inp = fam.inputs(RG, data=1, model=2, layers=3, prompt=30, steps=1,
                     cells="decode")
    inp["device"] = "cuda"
    np.savez(tmp_path / "in.npz", **inp)
    ranks = _torch_mesh_ranks.run("family", tmp_path, 2)
    cfg = fam.family_cfg(configs, inp)
    model = build_model(cfg)
    params = {k: torch.from_numpy(inp[f"p/{k}"]).to(cuda_device)
              for k in fam.state_names(inp)}
    toks = torch.from_numpy(inp["tokens"]).to(cuda_device)
    lg, state = model.prefill(params, {"tokens": toks}, max_len=31)
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    lg2, _ = model.decode_step(params, {"token": tok}, state)
    want = torch.stack([tok, lg2[:, -1:].argmax(-1).to(torch.int32)], 1)
    for got in ranks:
        np.testing.assert_array_equal(got["tokens"], want.cpu().numpy())
        assert got["launches"][0] > 0           # RMSNorm per shard
