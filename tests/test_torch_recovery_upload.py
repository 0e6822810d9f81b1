"""How a recovery puts a downloaded chunk on the slabs' device: every host
payload kind the pending map and COS hand back arrives as the same flat
uint8 bytes; on the CPU nothing is staged, and on the card the chunk is
staged through pinned memory and uploaded without holding the worker,
and the stream's later readers see its bytes."""
import numpy as np
import pytest
import torch

from repro_torch.core import Clock
from repro_torch.core.cos import COS
from repro_torch.core.recovery import RecoveryManager
from repro_torch.core.sms import SMS


def _manager(device):
    clock = Clock()
    return RecoveryManager(SMS(clock), COS(clock), {}, workers=2,
                           device=device)


def _payloads(n, seed):
    raw = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    return raw, {"bytes": raw.tobytes(), "bytearray": bytearray(raw),
                 "ndarray": raw.copy(),
                 "tensor": torch.from_numpy(raw.copy())}


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "ndarray", "tensor"])
def test_upload_on_the_cpu_is_the_payloads_bytes(kind):
    raw, payloads = _payloads(70_001, 1)
    rm = _manager(torch.device("cpu"))
    try:
        got = rm._upload(payloads[kind])
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), raw)
    finally:
        rm.shutdown()


@pytest.mark.cuda
def test_pinned_uploads_on_the_card_read_back_exactly():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rm = _manager(torch.device("cuda", 0))
    try:
        want, got = [], []
        for i in range(64):                 # the pinned blocks are reused
            raw, payloads = _payloads(1 + (i * 524_287) % (6 << 20), i)
            for kind in ("bytes", "ndarray"):
                want.append(raw)
                got.append(rm._upload(payloads[kind]))
        assert all(t.device.type == "cuda" for t in got)
        # read on the stream the uploads were queued on, as GETs do
        sums = torch.stack([t.sum(dtype=torch.int64) for t in got]).cpu()
        assert sums.tolist() == [int(w.sum(dtype=np.int64)) for w in want]
        assert all(np.array_equal(t.cpu().numpy(), w)
                   for t, w in zip(got, want))
    finally:
        rm.shutdown()
