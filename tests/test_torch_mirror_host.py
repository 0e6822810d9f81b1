"""tests/test_host.py's own test bodies run against the port (device="cpu").
The port's shared-memory segments are named `istore-torch-<pid>-*` (the
JAX package's `infinistore-*`), so the segment count looks for this
process's prefix."""
import os

from _torch_mirror import mirror

from repro_torch.core.ipc import SEGMENT_PREFIX


def _shm_segments():
    try:
        return {n for n in os.listdir("/dev/shm")
                if n.startswith(f"{SEGMENT_PREFIX}{os.getpid()}-")}
    except FileNotFoundError:                # non-Linux: can't observe
        return set()


globals().update(mirror("test_host.py",
                        overrides={"_shm_segments": _shm_segments}))
