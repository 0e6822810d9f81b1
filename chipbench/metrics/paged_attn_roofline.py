"""Paged decode attention against its bound over the traced window: the
least time of every call the traced batches made (q, the valid keys
and values, table and lengths at the HBM rate; its f32 flops at the f32
peak; the larger) over the time of the kernel's partial and combine
launches in the profiler, in %. Nothing to read where the kernel ran
another number of times than one per layer and decode step."""
from chipbench.metrics import _counts
from chipbench.reference.qwen_moe import dims


def read(run):
    if run.profile is None:
        return None
    z = dims(run.config)
    m = run.mix
    S, ps = m["prompt_tokens"], m["page_size"]
    pages = -(-(S + m["new_tokens"]) // ps)
    calls, least = 0, 0.0
    for b in run.log.get("batches", []):
        if not b["traced"]:
            continue
        B = len(b["served"])
        for j in range(len(b["step_s"])):
            n = S + j + 1
            least += z["L"] * _counts.bound_s(
                _counts.paged_attn_bytes(B, z["H"], z["K"], z["hd"], n, pages),
                _counts.paged_attn_flops(B, z["H"], z["hd"], n))
            calls += z["L"]
    partial = run.profile.kernels("paged_attn_partial")
    if not partial or len(partial) != calls:
        return None
    t = sum(s for _, s in run.profile.kernels("paged_attn_partial",
                                              "paged_attn_combine"))
    return 100.0 * least / t
