"""Serving example on the PyTorch port: batched generation over the
SMS-paged KV cache, with the full page lifecycle — hot pages tracked,
finished sequences aged out by the GC window, and an evicted sequence
resumed from COS.

    PYTHONPATH=src python examples/torch_serve_kv.py [--device cpu]

`examples/serve_kv.py` over `repro_torch`: the same reduced f32
Qwen3-1.7B, slots, lengths, pages, printed lines and assertions. On the
card its decode steps run the paged decode-attention kernel and its
norms the RMSNorm kernel. The engine draws its weights from a generator
on its own device, so the token ids differ between devices (and from
the JAX package's); the page counts do not.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import Clock
from repro_torch.serving import ServeConfig, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              dtype="float32")
    clock = Clock()
    eng = ServeEngine(cfg, ServeConfig(batch_slots=4, max_len=96,
                                       page_size=8, gc_interval=30.0),
                      clock=clock, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)

    out = eng.generate(prompts, max_new_tokens=12)
    print("generated token ids:\n", out)
    print("kv pages:", eng.kv.stats)
    print(f"serve: {eng.stats.tokens_generated} tokens, "
          f"prefill {eng.stats.prefill_seconds:.2f}s, "
          f"decode {eng.stats.decode_seconds:.2f}s")

    # sequences finished -> pages cool -> the GC window releases them
    for _ in range(8):
        clock.advance(30.0)
        eng.kv.gc_tick()
    print("after idle aging:", eng.kv.stats)
    assert eng.kv.stats.pages_evicted_to_cos > 0

    # a follow-up turn on seq0: on-demand migration restores its pages
    restored = eng.resume("seq0", slot=0)
    print(f"resumed seq0: {restored} pages restored from COS")
    assert restored > 0


if __name__ == "__main__":
    main()
