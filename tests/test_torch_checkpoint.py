"""The port's store-backed checkpointer on the CPU: the JAX package's
tests/test_checkpoint.py ported (round trip, restore after slab
failures, train-restart determinism, `latest_step`), its device-payload
array path, a bfloat16 leaf bit for bit, and parity with the reference —
the same state saved by both packages into their own stores gives the
same manifest JSON and, key by key, the same leaf bytes; leaf names in
`jax.tree_util.tree_flatten_with_path` order.

The JAX package is imported inside the parity tests only."""
import dataclasses
import json

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer, CheckpointConfig
from repro_torch.checkpoint.checkpointer import _leaf_paths
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import Clock, InfiniStore, StoreConfig
from repro_torch.core.ec import ECConfig
from repro_torch.core.gc_window import GCConfig
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_numpy

MB = 1024 * 1024


def small_store(device="cpu"):
    cfg = StoreConfig(ec=ECConfig(k=4, p=2),
                      function_capacity=32 * MB,
                      fragment_bytes=4 * MB,
                      gc=GCConfig(gc_interval=1e9),
                      device=device)
    return InfiniStore(cfg, clock=Clock())


def tiny_cfg():
    return dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                               dtype="float32")


def _params(seed):
    return build_model(tiny_cfg()).init_params(
        torch.Generator().manual_seed(seed))


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_roundtrip():
    st = small_store()
    ck = Checkpointer(st)
    params = _params(0)
    ck.save(5, {"params": params})
    out = ck.restore(5, like={"params": params})
    assert set(out["params"]) == set(params)
    for k in params:
        _assert_same(out["params"][k], params[k])


def test_restore_after_slab_failures():
    """Kill several slabs after save: restore must succeed via EC/COS."""
    st = small_store()
    ck = Checkpointer(st)
    params = _params(1)
    ck.save(1, {"params": params})
    st.flush_writeback()       # drain the buffer: restore must hit slabs/COS
    for fid in list(st.sms.slabs)[::2]:
        st.inject_failure(fid)
    out = ck.restore(1, like={"params": params})
    for k in params:
        _assert_same(out["params"][k], params[k])
    assert (st.recovery.stats.local_recoveries
            + st.recovery.stats.parallel_recoveries) > 0


def test_train_restart_is_deterministic():
    """Train 6 steps straight vs 3 + checkpoint + restart + 3: identical
    losses (deterministic pipeline + exact state restore)."""
    cfg = tiny_cfg()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    full = train(cfg, shape, steps=6, seed=3, device="cpu")

    st = small_store()
    ck = Checkpointer(st)
    first = train(cfg, shape, steps=3, seed=3, checkpointer=ck,
                  checkpoint_every=3, device="cpu")
    resumed = train(cfg, shape, steps=6, seed=3, checkpointer=ck,
                    resume=True, device="cpu")
    assert resumed.restored_from == 3
    np.testing.assert_allclose(full.losses[3:], resumed.losses,
                               rtol=2e-4, atol=2e-4)
    # what was saved is what comes back, bit for bit
    back = ck.restore(3, like=first.state)
    for (name, a), (_, b) in zip(_leaf_paths(first.state),
                                 _leaf_paths(back)):
        assert torch.equal(a, b), name


def test_latest_step():
    st = small_store()
    ck = Checkpointer(st)
    assert ck.latest_step() is None
    params = _params(0)
    ck.save(2, {"params": params})
    ck.save(7, {"params": params})
    assert ck.latest_step() == 7
    # a FRESH checkpointer over the same store must discover the steps
    # from COS keys (incl. the pending writeback map), not process state
    ck2 = Checkpointer(st)
    assert ck2.latest_step() == 7


def test_tensor_leaves_use_the_array_path():
    """Tensor leaves go through the store's array payload path (no bytes
    serialisation), several shards per leaf included."""
    st = small_store()
    ck = Checkpointer(st, CheckpointConfig(leaf_shard_bytes=4096))
    gen = torch.Generator().manual_seed(7)
    state = {"w": torch.randn((128, 32), generator=gen),
             "b16": torch.arange(2048, dtype=torch.bfloat16)}
    a0 = st.stats.array_payload_puts
    ck.save(3, state)
    assert st.stats.array_payload_puts - a0 >= 4 + 1   # w: 4 shards
    out = ck.restore(3, like=state)
    for k in state:
        _assert_same(out[k], state[k])


def test_bfloat16_leaf_restores_bit_for_bit():
    st = small_store()
    ck = Checkpointer(st, CheckpointConfig(leaf_shard_bytes=1000))
    bits = np.random.default_rng(2).integers(-2 ** 15, 2 ** 15, 3001,
                                             dtype=np.int64)
    leaf = torch.from_numpy(bits.astype(np.int16)).view(
        torch.bfloat16).reshape(3001, 1)[1:].reshape(100, 30)  # offset view
    ck.save(1, {"x": leaf, "count": torch.tensor(5, dtype=torch.int32)})
    out = ck.restore(1)
    assert set(out) == {"x", "count"}
    assert out["x"].dtype == torch.bfloat16 and out["x"].shape == (100, 30)
    assert torch.equal(out["x"].view(torch.int16), leaf.view(torch.int16))
    assert out["count"].shape == () and int(out["count"]) == 5


def test_leaf_paths_follow_jax_flatten_order():
    import jax
    tree = {"params": {"layers/wq": 1, "embed": 2, "b": {"z": 3, "a": 4}},
            "opt": {"count": 5, "mu": [6, 7], "nu": (8, {"k": 9})},
            "A": 10}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in flat]
    assert [name for name, _ in _leaf_paths(tree)] == want
    assert [leaf for _, leaf in _leaf_paths(tree)] == [v for _, v in flat]


def test_checkpoint_bytes_match_reference():
    """The same train state (bf16 params, f32 moments and master, an
    int32 count), saved by both packages into their own CPU stores:
    identical manifest JSON and identical leaf bytes, key by key."""
    import jax
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.checkpoint import CheckpointConfig as JCheckpointConfig
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core import Clock as JClock
    from repro.core import InfiniStore as JInfiniStore
    from repro.core import StoreConfig as JStoreConfig
    from repro.core.ec import ECConfig as JECConfig
    from repro.core.gc_window import GCConfig as JGCConfig
    from repro.models import build_model as jbuild
    from repro.optim import adamw as jadamw
    jm = jbuild(jreduced(jget_config("qwen1.5-0.5b")))     # bf16 params
    jp = jm.init_params(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tstate = train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    assert tstate["params"]["embed"].dtype == torch.bfloat16
    jst = JInfiniStore(JStoreConfig(ec=JECConfig(k=4, p=2),
                                    function_capacity=32 * MB,
                                    fragment_bytes=4 * MB,
                                    gc=JGCConfig(gc_interval=1e9)),
                       clock=JClock())
    tst = small_store()
    jck = JCheckpointer(jst, JCheckpointConfig(leaf_shard_bytes=8192))
    tck = Checkpointer(tst, CheckpointConfig(leaf_shard_bytes=8192))
    jck.save(4, jstate)
    tck.save(4, tstate)
    mkey = tck._manifest_key(4)
    assert mkey == jck._manifest_key(4)
    jman, tman = jst.get(mkey), tst.get(mkey)
    assert tman == jman
    manifest = json.loads(tman.decode())
    dtypes = {e["dtype"] for e in manifest["leaves"]}
    assert dtypes == {"bfloat16", "float32", "int32"}
    assert any(e["nshards"] > 1 for e in manifest["leaves"])
    keys = [tck._leaf_key(4, e["name"], si) for e in manifest["leaves"]
            for si in range(e["nshards"])]
    for key in keys:
        assert tst.get(key) == jst.get(key), key
    # and the port restores its own save bit for bit
    back = tck.restore(4, like=tstate)
    for (name, a), (_, b) in zip(_leaf_paths(tstate), _leaf_paths(back)):
        assert torch.equal(a, b), name
