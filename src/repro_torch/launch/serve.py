"""Serving launcher: batched generation over the SMS-paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cpu]

Runs a reduced config of `--arch` on the card by default (`--device
cpu` runs the plain PyTorch versions of the kernels on the CPU).
`--evict-resume` additionally exercises the paper's on-demand migration
on device payloads: seq0's KV pages are evicted and restored after the
generation round.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.serving import ServeConfig, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--evict-resume", action="store_true",
                    help="evict seq0's pages to COS and resume it "
                         "(device-payload on-demand migration)")
    args = ap.parse_args()
    cfg = reduced(get_config(args.arch))
    eng = ServeEngine(cfg, ServeConfig(batch_slots=args.batch,
                                       max_len=args.prompt_len
                                       + args.max_new_tokens + 8,
                                       page_size=args.page_size),
                      device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, args.max_new_tokens)
    print("generated tokens:\n", out)
    if args.evict_resume:
        # push seq0's live pages out to COS, then bring them back
        keys = [k for k, v in list(eng.kv.pages.items()) if v[0] == 0]
        for key in keys:
            eng.kv.evict_page_to_cos(key)
        restored = eng.resume("seq0", 0)
        print(f"evicted {len(keys)} pages to COS, restored {restored}")
    print("kv stats:", eng.kv.stats)
    print("serve stats:", eng.stats)


if __name__ == "__main__":
    main()
