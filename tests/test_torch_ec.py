"""The port's RSCodec (on the CPU) held to the JAX package's RSCodec:
chunks byte for byte, decode over every survivor set, decode-matrix LRU
accounting — mirroring tests/test_ec.py and tests/test_ec_batch.py."""
from itertools import combinations

import numpy as np
import pytest
import torch

from repro.core.ec import ECConfig as JECConfig
from repro.core.ec import RSCodec as JRSCodec
from repro_torch.core.ec import ECConfig, RSCodec


def pair(k, p, **kw):
    return (RSCodec(ECConfig(k=k, p=p), device="cpu", **kw),
            JRSCodec(JECConfig(k=k, p=p), **kw))


def as_bytes(chunk):
    return chunk.numpy().tobytes() if isinstance(chunk, torch.Tensor) \
        else bytes(chunk)


@pytest.mark.parametrize("k,p", [(10, 2), (4, 2), (3, 2)])
def test_chunks_byte_identical_to_reference(k, p):
    rng = np.random.default_rng(k * 10 + p)
    ours, ref = pair(k, p)
    # 0, 1, 3 and unaligned sizes (not multiples of 4, 16 or k)
    for size in (0, 1, 3, 37, 1001, 4097, 65_539):
        payload = rng.bytes(size)
        assert ours.encode(payload) == ref.encode(payload), size


def test_encode_many_multi_fragment_matches_reference():
    rng = np.random.default_rng(7)
    ours, ref = pair(4, 2)
    payloads = [rng.bytes(s) for s in (10, 999, 0, 4096, 1, 123_457)]
    want = ref.encode_many(payloads)
    assert ours.encode_many(payloads) == want
    # zero-copy array chunks carry the same bytes; tensor and numpy
    # payloads encode like bytes
    arrays = ours.encode_many(payloads, as_arrays=True)
    assert [[as_bytes(c) for c in cs] for cs in arrays] == want
    mixed = [torch.frombuffer(bytearray(payloads[0]), dtype=torch.uint8),
             np.frombuffer(payloads[1], np.uint8)] + payloads[2:]
    assert ours.encode_many(mixed) == want
    for payload, chunks in zip(payloads, want):
        assert ours.encode(payload) == chunks


def test_decode_every_survivor_set_matches_reference():
    rng = np.random.default_rng(8)
    ours, ref = pair(4, 2)
    payloads = [rng.bytes(s) for s in (0, 1, 50, 2048, 4099)]
    batched = ref.encode_many(payloads)
    cmaps, want = [], []
    for payload, chunks in zip(payloads, batched):
        for n in (4, 5, 6):
            for surv in combinations(range(6), n):
                cmaps.append({i: chunks[i] for i in surv})
                want.append(payload)
    assert ref.decode_many(cmaps) == want
    assert ours.decode_many(cmaps) == want
    # slab-resident tensor chunks and COS numpy chunks decode the same;
    # as_arrays gives flat uint8 tensors on the codec's device
    tmaps = [{i: torch.frombuffer(bytearray(c), dtype=torch.uint8)
              for i, c in cm.items()} for cm in cmaps]
    nmaps = [{i: np.frombuffer(c, np.uint8) for i, c in cm.items()}
             for cm in cmaps]
    assert ours.decode_many(tmaps) == want
    assert ours.decode_many(nmaps) == want
    arrays = ours.decode_many(tmaps, as_arrays=True)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in arrays)
    assert [as_bytes(a) for a in arrays] == want
    # every distinct survivor set is inverted once, however often decoded
    assert ours.cache_info()["inversions"] == ref.cache_info()["inversions"]
    assert ours.cache_info()["size"] == ref.cache_info()["size"]


def test_cache_info_agrees_with_reference():
    for ours_ref in (pair(4, 2), pair(3, 2, inv_cache_size=2)):
        ours, ref = ours_ref
        k = ours.cfg.k
        chunks = ref.encode(bytes(range(200)) * 3)
        sets = [s for s in combinations(range(ours.cfg.n), k)][:5]
        script = sets + sets[:2] + [tuple(range(k))] + sets[-1:]
        for surv in script:
            cm = {i: chunks[i] for i in surv}
            assert ours.decode(cm) == ref.decode(cm)
            assert ours.cache_info() == ref.cache_info(), surv


def test_repeated_degraded_reads_invert_once():
    ours, _ = pair(4, 2)
    chunks = ours.encode(b"x" * 5000)
    surv = {i: c for i, c in enumerate(chunks) if i not in (0, 5)}
    for _ in range(6):
        assert ours.decode(surv) == b"x" * 5000
    assert ours.cache_info() == {"hits": 5, "misses": 1, "inversions": 1,
                                 "size": 1}


def test_identity_decode_skips_matmul_and_cache():
    ours, _ = pair(4, 2)
    chunks = ours.encode(b"abcdef" * 100)
    assert ours.decode({i: chunks[i] for i in range(4)}) == b"abcdef" * 100
    info = ours.cache_info()
    assert info["inversions"] == 0 and info["hits"] == 0


def test_too_few_chunks_and_empty_batch():
    ours, _ = pair(4, 2)
    assert ours.decode_many([]) == []
    assert ours.encode_many([]) == []
    chunks = ours.encode(b"hello world")
    with pytest.raises(ValueError):
        ours.decode({0: chunks[0], 1: chunks[1], 2: chunks[2]})


@pytest.mark.parametrize("seed", range(4))
def test_roundtrip_with_erasures_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, p = int(rng.integers(2, 11)), int(rng.integers(1, 5))
    ours, ref = pair(k, p)
    payload = rng.bytes(int(rng.integers(0, 5000)))
    chunks = ours.encode(payload)
    assert chunks == ref.encode(payload)
    assert len({len(c) for c in chunks}) == 1
    lost = rng.choice(k + p, size=rng.integers(0, p + 1), replace=False)
    surviving = {i: c for i, c in enumerate(chunks) if i not in lost}
    assert ours.decode(surviving) == payload


def test_paper_config_10_2_parity_decode():
    ours, ref = pair(10, 2)
    payload = np.random.default_rng(1).integers(
        0, 256, 1_000_000).astype(np.uint8).tobytes()
    chunks = ours.encode(payload)
    assert chunks == ref.encode(payload)
    surviving = {i: c for i, c in enumerate(chunks) if i not in (2, 11)}
    assert ours.decode(surviving) == payload
    assert ref.decode(surviving) == payload
    assert ours.cache_info() == ref.cache_info()


def test_cuda_codec_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        RSCodec(ECConfig(4, 2))


GATHER_CLENS = [1, 3, 15, 16, 17, 4097, 1_048_577]


def _offset_chunks(chunks, rng):
    """Each chunk as a tensor view at byte offset 0-15 of its own
    storage."""
    out = {}
    for i, c in chunks.items():
        off = int(rng.integers(0, 16))
        buf = torch.empty(off + len(c), dtype=torch.uint8)
        buf[off:] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
        out[i] = buf[off:]
    return out


@pytest.mark.parametrize("k,p", [(10, 2), (4, 2)])
@pytest.mark.parametrize("clen", GATHER_CLENS)
def test_gathered_decode_matches_staged_and_reference(k, p, clen,
                                                      monkeypatch):
    """The codec's gathered decode (the plain version on the CPU) against
    the staged path it replaces and the JAX package's RSCodec: every
    survivor set with 1 and 2 chunks lost, chunk lengths around a 16-byte
    chunk, survivors at byte offsets 0-15 of their storage, and batches
    of 4 and of more fragments than one launch's table."""
    from repro_torch.core import ec
    from repro_torch.kernels.rs_gf256.kernel import GATHER_FRAGS
    rng = np.random.default_rng(clen + k)
    ours, ref = pair(k, p)
    n = k + p
    payload = rng.bytes(max(0, k * clen - 4))
    chunks = ref.encode(payload)
    assert len(chunks[0]) == clen
    sets = [s for lost in (1, 2) for s in combinations(range(n), n - lost)]
    if clen > 100_000:                   # chunk 0, and chunks 0-1, lost
        sets = [tuple(range(1, n)), tuple(range(2, n))]
    cmaps = [_offset_chunks({i: chunks[i] for i in s}, rng) for s in sets]
    got = ours.decode_many(cmaps)
    assert got == [payload] * len(sets)
    assert ref.decode_many([{i: chunks[i] for i in s} for s in sets]) == got
    assert ours.decode_many(cmaps, as_arrays=True)[0].numpy().tobytes() \
        == payload
    monkeypatch.setattr(ec, "gathers", lambda G: False)   # the staged path
    assert ours.decode_many(cmaps) == got
    monkeypatch.undo()
    if clen < 5000:                      # one survivor group, 4 and 40
        for m in (4, GATHER_FRAGS + 8):
            batch = [cmaps[-1]] * m
            assert ours.decode_many(batch) == [payload] * m
    assert ours.staged_decodes == 0      # a CPU codec counts none
