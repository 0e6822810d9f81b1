"""`train(..., mesh=)` for an MoE: reduced f32 Granite-MoE-1B-A400M
(`expert` sharding) over a `data` axis of two ranks (two gloo CPU
processes, `tests/_torch_mesh_ranks.py` mode "train"), 4 x 16 tokens a
step in 2 microbatches.

Six steps at data = 2 against `train()` straight on one process: losses
and AdamW's gradient norms within 2e-4 (the reference's restart
tolerance, `tests/test_checkpoint.py`), equal on both ranks. Elastic
restart both ways: 3 steps at data = 2 with a checkpoint saved by rank 0
resume at data = 1 from a state bit-identical to the gathered one, and 3
steps at data = 1 with a checkpoint resume at data = 2, each to the
straight run's losses within 2e-4."""
import numpy as np
import pytest

import _torch_mesh_ranks
from repro_torch.configs import ShapeConfig
from repro_torch.launch.train import train

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH, SEQ, BATCH, MICRO, SEED = "granite-moe-1b-a400m", 16, 4, 2, 3


@pytest.fixture(scope="module")
def straight_run():
    """Six steps of `train()` on one process, no mesh."""
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    return train(_torch_mesh_ranks._cfg(ARCH), shape, steps=6, seed=SEED,
                 num_microbatches=MICRO, device="cpu")


def _ranks(tmp_path, scenario, steps, ckpt=0, data=2):
    np.savez(tmp_path / "in.npz", data=data, model=1, arch=ARCH,
             seq_len=SEQ, batch=BATCH, microbatches=MICRO, seed=SEED,
             steps=steps, ckpt=ckpt, scenario=scenario)
    return _torch_mesh_ranks.run("train", tmp_path, data)


def test_moe_train_on_a_mesh_matches_train_straight(tmp_path, straight_run):
    ranks = _ranks(tmp_path, "straight", 6)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], straight_run.losses,
                                   **TOL)
        np.testing.assert_allclose(got["grad_norms"],
                                   straight_run.grad_norms, **TOL)
    for k in ("losses", "grad_norms"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_moe_checkpoint_at_data_2_resumes_at_data_1(tmp_path, straight_run):
    straight = straight_run.losses
    r0 = _ranks(tmp_path, "save", 6, ckpt=3)[0]
    np.testing.assert_allclose(r0["losses"], straight[:3], **TOL)
    assert int(r0["restored_from"]) == 3
    assert bool(r0["same_state"])
    np.testing.assert_allclose(r0["resumed"], straight[3:], **TOL)


def test_moe_checkpoint_at_data_1_resumes_at_data_2(tmp_path, straight_run):
    straight = straight_run.losses
    ranks = _ranks(tmp_path, "resume", 6, ckpt=3)
    np.testing.assert_allclose(ranks[0]["losses"], straight[:3], **TOL)
    for got in ranks:
        assert int(got["restored_from"]) == 3
        np.testing.assert_allclose(got["resumed"], straight[3:], **TOL)
