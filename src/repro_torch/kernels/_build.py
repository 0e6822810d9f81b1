"""Build the port's CUDA kernels: `nvcc` for `sm_90a` into shared
libraries with a plain C interface, loaded with `ctypes`.

Each source compiles at first use into `build/repro_torch/` at the
repository root, as `<stem>-<hash of the source>.so`, so an edited
source builds anew and an unchanged one is reused. The compiler's
resource report (`-Xptxas -v`: registers, shared memory, spills) is
kept beside the library as `<name>.log`. Importing this module builds
nothing; a failed build raises, and no caller falls back to a plain
version for a CUDA tensor.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_sm_counts: dict = {}
_sm_lock = threading.Lock()


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per
    device): the kernels' launch planners size their grids by it."""
    with _sm_lock:
        n = _sm_counts.get(device.index)
        if n is None:
            n = torch.cuda.get_device_properties(device).multi_processor_count
            _sm_counts[device.index] = n
        return n


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need "
                           "the CUDA toolkit (sm_90a) to build")
    return path


def library_path(source: Path) -> Path:
    """Where `source`'s build lives, keyed by a hash of its bytes."""
    tag = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


def build_many(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose build is missing, one `nvcc` per
    source, all started together; returns the libraries' paths in the
    order given. Raises on the first failed compile, after every
    compiler has exited."""
    sources = [Path(s) for s in sources]
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for src, lib, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                            f"{err}{out}")
            continue
        lib.with_suffix(".log").write_text(err + out)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def build(source: Path) -> Path:
    """Compile one source if its build is missing; returns its path."""
    return build_many([source])[0]
