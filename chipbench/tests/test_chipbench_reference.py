"""The benchmark's plain references on the CPU: the NumPy RS(10+2) codec
and the float32 Qwen1.5-MoE forward, against hand-worked cases and the
program at small sizes."""
import itertools
import math

import numpy as np
import pytest
import torch

from chipbench.reference import gf256_rs
from chipbench.reference import qwen_moe as q


def test_field_tables_follow_the_polynomial():
    # 2^8 = x^4 + x^3 + x^2 + 1 (0x11D) and every nonzero element has an
    # inverse
    assert gf256_rs.EXP[8] == 0x1D
    a = np.arange(1, 256)
    assert (gf256_rs.gf_mul(a, gf256_rs.gf_inv(a)) == 1).all()
    assert gf256_rs.gf_mul(0x53, 0xCA) == gf256_rs.MUL[0x53, 0xCA]
    # distributes over XOR
    x, y, z = 0x57, 0x83, 0x1F
    assert gf256_rs.gf_mul(x, y ^ z) == gf256_rs.gf_mul(x, y) ^ gf256_rs.gf_mul(x, z)


def test_parity_rows_are_the_cauchy_rows():
    C = gf256_rs.parity_matrix(10, 2)
    for i, j in itertools.product(range(2), range(10)):
        assert gf256_rs.gf_mul(C[i, j], (10 + i) ^ j) == 1


@pytest.mark.parametrize("nbytes", [0, 1, 5, 37, 1000, 4099])
def test_any_two_lost_chunks_read_back(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    chunks = gf256_rs.encode(data, 10, 2)
    assert chunks.shape == (12, gf256_rs.chunk_len(nbytes, 10))
    for lost in itertools.chain(([],), ([i] for i in range(12)),
                                itertools.combinations(range(12), 2)):
        have = {i: chunks[i] for i in range(12) if i not in lost}
        assert np.array_equal(gf256_rs.decode(have, 10, 2), data), lost
    with pytest.raises(ValueError):
        gf256_rs.decode({i: chunks[i] for i in range(9)}, 10, 2)


def test_encode_equals_the_programs_codec():
    from repro_torch.core.ec import ECConfig, RSCodec
    codec = RSCodec(ECConfig(10, 2), device="cpu")
    for n in (1, 999, 65_537):
        data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
        got = codec.encode(data.tobytes())
        want = gf256_rs.encode(data, 10, 2)
        assert [bytes(r) for r in want] == got


def _tiny(**kw):
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 2,
         "num_hidden_layers": 1, "vocab_size": 16, "num_experts": 2,
         "num_experts_per_tok": 1, "moe_intermediate_size": 4,
         "shared_expert_intermediate_size": 4, "rope_theta": 10000.0,
         "rms_norm_eps": 1e-6, "norm_topk_prob": False,
         "capacity_factor": 0.5}
    c.update(kw)
    return c


def test_capacity_rule():
    # Qwen1.5-MoE's prompt of 2048: ceil(2048*4*1.25/60) = 171 -> 172
    assert q.capacity(2048, 4, 60, 1.25) == 172
    assert q.capacity(1, 4, 60, 1.25) == 4
    assert q.capacity(6, 1, 2, 0.5) == 4
    ids = torch.tensor([[0], [0], [1], [0], [0], [0], [0]])
    keep = q.kept_pairs(ids, [(0, 7)], E=2, factor=0.5)
    # expert 0's first four pairs in token order survive
    assert keep[:, 0].tolist() == [True, True, True, True, True, False,
                                   False]
    assert q.kept_pairs(ids, [(0, 1), (1, 2)], 2, 0.5)[:2].all()


def test_moe_block_matches_a_hand_worked_case_with_drops():
    c = _tiny()
    d, f = 8, 4
    g = torch.Generator().manual_seed(0)
    w = {"router": torch.zeros(d, 2), "shared_gate": torch.randn(d, generator=g),
         "we_gate": torch.randn(2, d, f, generator=g),
         "we_up": torch.randn(2, d, f, generator=g),
         "we_down": torch.randn(2, f, d, generator=g),
         "ws_gate": torch.randn(d, f, generator=g),
         "ws_up": torch.randn(d, f, generator=g),
         "ws_down": torch.randn(f, d, generator=g)}
    w["router"][0, 0] = 10.0          # every token with h[0] > 0 -> expert 0
    h = torch.randn(1, 6, d, generator=g)
    h[0, :, 0] = torch.tensor([1.0, 2.0, 1.5, 1.0, 3.0, 2.0])
    out = q.moe_block(c, w, h, [(0, 6)])

    def silu(x):
        return x / (1 + torch.exp(-x))

    for t in range(6):
        x = h[0, t]
        logits = x @ w["router"]
        p0 = torch.exp(logits[0]) / torch.exp(logits).sum()
        shared = (silu(x @ w["ws_gate"]) * (x @ w["ws_up"])) @ w["ws_down"]
        shared = shared * torch.sigmoid(x @ w["shared_gate"])
        routed = p0 * ((silu(x @ w["we_gate"][0]) * (x @ w["we_up"][0]))
                       @ w["we_down"][0])
        # capacity 4: tokens 4 and 5 are dropped, only the shared expert
        want = shared + (routed if t < 4 else 0)
        torch.testing.assert_close(out[0, t], want, rtol=1e-5, atol=1e-5)


def test_weights_follow_the_seed_and_the_layout():
    c = _tiny(num_hidden_layers=2)
    a = q.make_weights(c, 7, "cpu", torch.float32, chunk=100)
    b = q.make_weights(c, 7, "cpu", torch.float32, chunk=100)
    assert set(a) == set(q.param_shapes(c))
    for k in a:
        assert tuple(a[k].shape) == q.param_shapes(c)[k]
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    std = float(a["layers/we_down"].std())
    assert abs(std - 1 / math.sqrt(4)) < 0.2


def test_fp8_control_departs_from_float32():
    c = _tiny(hidden_size=32, num_hidden_layers=2, vocab_size=64,
              num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=16, shared_expert_intermediate_size=16,
              capacity_factor=1.25)
    w = q.make_weights(c, 3, "cpu", torch.float32)
    tok = torch.randint(0, 64, (2, 12), generator=torch.Generator().manual_seed(1))
    hi = q.logits(c, w, tok, 8)
    lo = q.logits(c, w, tok, 8, "fp8")
    assert hi.shape == (2, 5, 64)
    assert 1e-3 < float((hi - lo).abs().max()) < 10.0


def test_reference_equals_the_programs_forward_in_float32():
    from repro_torch.models import transformer

    from chipbench.drivers.serve_batches import model_config
    c = dict(_tiny(hidden_size=32, num_attention_heads=4,
                   num_key_value_heads=4, num_hidden_layers=2,
                   vocab_size=64, num_experts=4, num_experts_per_tok=2,
                   moe_intermediate_size=16,
                   shared_expert_intermediate_size=16, capacity_factor=1.25),
             name="tiny", source="", tie_word_embeddings=False,
             torch_dtype="float32")
    w = q.make_weights(c, 5, "cpu", torch.float32)
    tok = torch.randint(0, 64, (2, 10), generator=torch.Generator().manual_seed(2))
    got, _ = transformer.forward(model_config(c), w, {"tokens": tok},
                                 remat=False)
    # the whole sequence as one dispatch group, as the program's forward
    want = q.logits(c, w, tok, 10)
    torch.testing.assert_close(got[:, -1], want[:, 0], rtol=1e-4, atol=1e-4)
