"""End-to-end training driver on the PyTorch port: train a reduced LM
for a few hundred steps with InfiniStore-backed checkpointing, then
SIMULATE a node failure (mass slab reclamation) and restart — the loss
curve must continue exactly where it left off.

    PYTHONPATH=src python examples/torch_train_lm.py [--arch qwen1.5-0.5b]
    [--steps 200] [--device cpu]

`examples/train_lm.py` over `repro_torch`: the same config, steps,
seeds, printed lines and assertions. On the card the checkpoints' RS
chunks are encoded and decoded by the GF(256) kernel and the norms run
the RMSNorm kernel, forward and backward. Fewer than the default 200
steps may not improve the loss enough for the last assertion (the JAX
package's example shares that).
"""
import argparse
import dataclasses

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch.train import make_store_for_checkpoints, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        reduced(get_config(args.arch), layers=4, d_model=128, d_ff=256),
        dtype="float32")
    shape = ShapeConfig("example", seq_len=args.seq_len,
                        global_batch=args.batch, kind="train")
    store = make_store_for_checkpoints(device=args.device)
    ckpt = Checkpointer(store)

    half = args.steps // 2
    print(f"phase 1: training {half} steps "
          f"({cfg.name}, {args.batch}x{args.seq_len})")
    r1 = train(cfg, shape, steps=half, seed=0, checkpointer=ckpt,
               checkpoint_every=max(half // 4, 1), device=args.device)
    print(f"  loss {r1.losses[0]:.3f} -> {r1.final_loss:.3f} "
          f"in {r1.wall_s:.1f}s")

    # simulate a host failure: reclaim every slab holding checkpoint chunks
    for fid in list(store.sms.slabs):
        store.inject_failure(fid)
    print(f"simulated node failure: reclaimed all "
          f"{len(store.sms.slabs)} slabs")

    print(f"phase 2: restart + resume to {args.steps} steps")
    r2 = train(cfg, shape, steps=args.steps, seed=0, checkpointer=ckpt,
               checkpoint_every=max(half // 4, 1), resume=True,
               device=args.device)
    print(f"  restored from step {r2.restored_from}; "
          f"loss -> {r2.final_loss:.3f} in {r2.wall_s:.1f}s")
    print(f"  recoveries: {store.recovery.stats.local_recoveries} local, "
          f"{store.recovery.stats.parallel_recoveries} parallel")
    assert r2.restored_from == half
    assert r2.final_loss < r1.losses[0], "loss should keep improving"
    print("restart-after-failure ok")
    # the writeback thread stops here, not in the interpreter's teardown
    store.close()


if __name__ == "__main__":
    main()
