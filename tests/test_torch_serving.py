"""The port's serving engine and SMS-paged KV cache (device="cpu"):
tests/test_serving.py's three scenarios run against the port; the port's
engine gives the reference engine's greedy tokens from the same weights
(reduced qwen1.5-0.5b and qwen3-1.7b in f32, tokens identical); and the
store-backed eviction tier of tests/test_shard.py round-trips over the
port's single-node InfiniStore."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import Clock
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeConfig, ServeEngine, SMSPagedKV

MB = 1024 * 1024


def _cfg(name="qwen1.5-0.5b"):
    return dataclasses.replace(reduced(get_config(name)), dtype="float32")


def make_engine(clock=None, **kw):
    scfg = ServeConfig(batch_slots=2, max_len=64, page_size=8,
                       gc_interval=30.0)
    return ServeEngine(_cfg(), scfg, clock=clock or Clock(), device="cpu",
                       **kw)


def plain_generate(eng, prompts, n):
    m = eng.model
    logits, cache = m.prefill(eng.params,
                              {"tokens": torch.from_numpy(prompts)},
                              max_len=64)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = []
    for _ in range(n):
        lg, cache = m.decode_step(eng.params, {"token": tok}, cache)
        nt = lg[:, -1].argmax(-1).to(torch.int32)
        out.append(nt.numpy())
        tok = nt[:, None]
    return np.stack(out, 1)


def test_engine_matches_plain_decode():
    eng = make_engine()
    prompts = np.random.default_rng(0).integers(
        0, eng.cfg.vocab_size, (2, 12)).astype(np.int32)
    got = eng.generate(prompts, 6)
    want = plain_generate(eng, prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert eng.stats.decode_steps == 6 and len(eng.stats.step_seconds) == 6


def test_page_lifecycle_release_and_resume():
    clock = Clock()
    eng = make_engine(clock)
    prompts = np.random.default_rng(1).integers(
        0, eng.cfg.vocab_size, (2, 12)).astype(np.int32)
    eng.generate(prompts, 4)
    assert eng.kv.stats.pages_allocated > 0
    # sequences done -> pages cool -> released + persisted to COS
    for _ in range(8):
        clock.advance(30.0)
        eng.kv.gc_tick()
    assert eng.kv.stats.pages_evicted_to_cos > 0
    # freed slots are reusable
    assert any(len(f) > 0 for f in eng.kv._free)
    # on-demand migration restores the sequence
    n = eng.resume("seq0", 0)
    assert n > 0
    assert eng.kv.stats.pages_restored == n


def test_active_sequences_stay_hot():
    """Pages touched each decode step must not be released mid-generation."""
    clock = Clock()
    eng = make_engine(clock)
    prompts = np.random.default_rng(2).integers(
        0, eng.cfg.vocab_size, (2, 12)).astype(np.int32)
    orig_tick = eng.kv.gc_tick

    def tick_with_time():
        clock.advance(10.0)
        orig_tick()

    eng.kv.gc_tick = tick_with_time
    out = eng.generate(prompts, 8)
    want = plain_generate(make_engine(), prompts, 8)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "qwen3-1.7b"])
def test_engine_matches_reference_engine(name):
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.serving import ServeConfig as JServeConfig
    from repro.serving import ServeEngine as JServeEngine
    jcfg = dataclasses.replace(jreduced(jget(name)), dtype="float32")
    scfg = dict(batch_slots=2, max_len=64, page_size=8, gc_interval=30.0)
    ref = JServeEngine(jcfg, JServeConfig(**scfg), clock=Clock())
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in ref.params.items()},
                               device="cpu")
    port = ServeEngine(_cfg(name), ServeConfig(**scfg), params=params,
                       clock=Clock(), device="cpu")
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    want = ref.generate(prompts, 10)
    got = port.generate(prompts, 10)
    np.testing.assert_array_equal(got, want)
    assert vars(port.kv.stats) == vars(ref.kv.stats)
    assert port.kv.pages == ref.kv.pages
    np.testing.assert_array_equal(port.kv.table, ref.kv.table)
    np.testing.assert_allclose(port.kv.k_pool.numpy(),
                               np.asarray(ref.kv.k_pool), atol=1e-4,
                               rtol=1e-4)


def test_engine_default_seeded_weights_are_deterministic():
    a, b = make_engine(seed=3), make_engine(seed=3)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    cfg = a.cfg                              # k+v, always in bf16 units
    assert a.kv.page_bytes == cfg.num_layers * 8 * cfg.num_kv_heads \
        * cfg.head_dim * 2 * 2


def test_cos_tier_round_trips_page_bytes():
    eng = make_engine()
    prompts = np.random.default_rng(5).integers(
        0, eng.cfg.vocab_size, (2, 12)).astype(np.int32)
    eng.generate(prompts, 3)
    kv = eng.kv
    keys = [k for k, v in kv.pages.items() if v[0] == 0]
    before = {k: kv.page_payload(0, kv.pages[k][2]).clone() for k in keys}
    for key in keys:
        kv.evict_page_to_cos(key)
    assert kv.stats.pages_evicted_to_cos == len(keys)
    assert eng.resume("seq0", 0) == len(keys)
    for key in keys:
        assert torch.equal(kv.page_payload(0, kv.pages[key][2]), before[key])


def test_kv_cache_store_backend_roundtrip():
    """tests/test_shard.py::test_kv_cache_store_backend_roundtrip over the
    port's single-node InfiniStore on the CPU."""
    from repro_torch.core import InfiniStore, StoreConfig
    from repro_torch.core.ec import ECConfig
    st = InfiniStore(StoreConfig(ec=ECConfig(k=4, p=2),
                                 function_capacity=4 * MB,
                                 fragment_bytes=1 * MB, device="cpu"),
                     clock=Clock())
    try:
        kv = SMSPagedKV(_cfg(), batch_slots=2, max_len=128, page_size=32,
                        store=st, device="cpu")
        assert kv.cos is None
        phys = kv.alloc_page(0, "seq-a", 0)
        kv.k_pool[:, 0, phys] = 1.0
        kv.v_pool[:, 0, phys] = torch.arange(
            kv.v_pool[:, 0, phys].numel(), dtype=torch.float32).reshape(
            kv.v_pool[:, 0, phys].shape)
        want = kv.page_payload(0, phys).clone()
        key = kv._key("seq-a", 0)
        kv.evict_page_to_cos(key)
        assert kv.stats.pages_evicted_to_cos == 1
        assert st.stats.puts == 1                  # rode the store path
        kv.k_pool.zero_()
        kv.v_pool.zero_()
        kv.restore_pages(0, "seq-a", [0])
        assert kv.stats.pages_restored == 1
        new = kv.pages[key][2]
        assert bool((kv.k_pool[:, 0, new] == 1.0).all())
        assert torch.equal(kv.page_payload(0, new), want)
        # and one page at a time through get_array
        kv.evict_page_to_cos(key)
        kv.restore_page(0, "seq-a", 0)
        assert torch.equal(kv.page_payload(0, kv.pages[key][2]), want)
    finally:
        st.close()


def test_restore_of_unknown_page_raises():
    kv = SMSPagedKV(_cfg(), batch_slots=1, max_len=16, page_size=8,
                    device="cpu")
    with pytest.raises(KeyError):
        kv.restore_pages(0, "nobody", [0])


def test_reference_weights_bf16_convert_bit_for_bit():
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild
    jp = jbuild(jreduced(jget("qwen3-1.7b"))).init_params(
        jax.random.PRNGKey(1))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    for k, v in jp.items():
        bits = np.asarray(v).view(np.uint16)
        assert tp[k].dtype == torch.bfloat16
        assert np.array_equal(tp[k].view(torch.int16).numpy().view(
            np.uint16), bits), k
