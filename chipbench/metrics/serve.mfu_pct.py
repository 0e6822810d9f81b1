"""Model flops of the batches that completed inside the window (weight
products of the routed experts only, attention, the head; counted from
shapes) over the time from the window's start to the last one's end, at
the bf16 peak, in %."""
from chipbench.metrics import _counts
from chipbench.reference.qwen_moe import dims


def read(run):
    z = dims(run.config)
    S = run.mix["prompt_tokens"]
    done = [b for b in run.log.get("batches", [])
            if b["step_end"] and b["step_end"][-1] <= run.t1]
    if not done:
        return None
    flops = 0
    for b in done:
        B = len(b["served"])
        flops += _counts.moe_prefill_flops(z, B, S) + sum(
            _counts.moe_decode_flops(z, B, S + j + 1)
            for j in range(len(b["step_end"])))
    seconds = done[-1]["step_end"][-1] - run.t0
    return 100.0 * flops / (seconds * _counts.BF16_FLOPS_PER_S)
