"""Which collectives a gloo world takes on CUDA tensors, two processes on
one card (as phases 13b and 13c of chip_smoke.py run them).

    python3 scripts/gloo_cuda_collectives.py

Each case runs in a fresh pair of spawned processes (a case that kills
its processes leaves the others standing) and prints its result or the
processes' exit codes: gloo's plain collectives (`dist.all_reduce`,
`dist.broadcast`, `dist.all_gather_into_tensor`,
`dist.reduce_scatter_tensor`), torch's functional ones (what DTensor's
redistributions call), and the functional ones again with
`repro_torch.distributed.shared_card` installed (buffers both processes
map through CUDA IPC). Then the all-gather's rate for 256 MB per rank:
gloo on the CUDA tensor, staged by hand through pinned and pageable
host memory, on a CPU tensor, and through `shared_card`. Needs a card;
prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ["dist.all_reduce", "dist.broadcast", "dist.all_gather_into_tensor",
         "dist.reduce_scatter_tensor", "funcol.all_reduce",
         "funcol.all_gather_tensor", "funcol.reduce_scatter_tensor",
         "shared_card funcol.all_gather_tensor",
         "shared_card funcol.reduce_scatter_tensor", "rates"]
MB = 1024 * 1024


def _case(name, rank, world, x):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    g = dist.group.WORLD
    if name.startswith("shared_card "):
        from repro_torch.distributed import shared_card
        shared_card.install("CUDA")
        name = name.split(" ", 1)[1]
    if name == "dist.all_reduce":
        y = x.clone()
        dist.all_reduce(y)
    elif name == "dist.broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
    elif name == "dist.all_gather_into_tensor":
        y = x.new_empty(world * x.numel())
        dist.all_gather_into_tensor(y, x)
    elif name == "dist.reduce_scatter_tensor":
        y = x.new_empty(x.numel() // world)
        dist.reduce_scatter_tensor(y, x)
    elif name == "funcol.all_reduce":
        y = funcol.all_reduce(x, "sum", g)
    elif name == "funcol.all_gather_tensor":
        y = funcol.all_gather_tensor(x, 0, g)
    else:
        y = funcol.reduce_scatter_tensor(x, "sum", 0, g)
    y = y.wait() if hasattr(y, "wait") else y
    torch.cuda.synchronize()
    return y.float().tolist()


def _rates(rank, world):
    import torch
    import torch.distributed as dist
    n = 128 * MB
    x = torch.ones(n, dtype=torch.bfloat16, device="cuda")
    out = torch.empty(world * n, dtype=torch.bfloat16, device="cuda")
    hx = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    hout = torch.empty(world * n, dtype=torch.bfloat16, pin_memory=True)
    px = torch.empty(n, dtype=torch.bfloat16)
    pout = torch.empty(world * n, dtype=torch.bfloat16)

    def pinned():
        hx.copy_(x)
        dist.all_gather_into_tensor(hout, hx)
        out.copy_(hout)

    def pageable():
        px.copy_(x)
        dist.all_gather_into_tensor(pout, px)
        out.copy_(pout)

    from repro_torch.distributed import shared_card
    group = dist.group.WORLD.group_name
    ways = {"cuda tensor": lambda: dist.all_gather_into_tensor(out, x),
            "pinned staging": pinned, "pageable staging": pageable,
            "cpu tensor": lambda: dist.all_gather_into_tensor(pout, px),
            "shared_card": lambda: shared_card.all_gather_into_tensor(
                x, world, group)}
    got = {}
    for name, fn in ways.items():
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) / 3
        got[name] = f"{dt * 1e3:.1f} ms, {n * 2 / dt / 1e9:.3f} GB/s " \
                    f"from the other rank"
    return got


def _worker(name, rank, world, init, q):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    if name == "rates":
        got = _rates(rank, world)
    else:
        x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
        got = _case(name, rank, world, x)
    q.put((rank, got))
    from repro_torch.distributed import shared_card
    shared_card.release()
    dist.destroy_process_group()


def main() -> int:
    import queue

    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(CASES):
            q = ctx.Queue()
            init = os.path.join(tmp, f"init{i}")
            procs = [ctx.Process(target=_worker, args=(name, r, 2, init, q))
                     for r in range(2)]
            for p in procs:
                p.start()
            got = []
            t = time.perf_counter()
            while len(got) < 2 and time.perf_counter() - t < 120:
                try:
                    got.append(q.get(timeout=2))
                except queue.Empty:
                    if all(p.exitcode is not None for p in procs):
                        break
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
            codes = [p.exitcode for p in procs]
            if len(got) == 2:
                print(f"{name}: {dict(sorted(got))}")
            else:
                print(f"{name}: FAILED, exit codes {codes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
