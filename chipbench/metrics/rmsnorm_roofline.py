"""The RMSNorm kernel against its bound over the traced window: the
least time of every call the traced batches made (2L + 1 per forward:
B S rows in a prefill, B in a decode step; x read, out written, the
scale read) over the kernel's time in the profiler, in %. Nothing to
read where the kernel ran another number of times."""
from chipbench.metrics import _counts
from chipbench.reference.qwen_moe import dims


def read(run):
    if run.profile is None:
        return None
    z = dims(run.config)
    S = run.mix["prompt_tokens"]
    per = 2 * z["L"] + 1
    calls, least = 0, 0.0
    for b in run.log.get("batches", []):
        if not b["traced"]:
            continue
        B = len(b["served"])
        for rows, n in ((B * S, 1), (B, len(b["step_s"]))):
            least += n * per * _counts.bound_s(
                _counts.rmsnorm_bytes(rows, z["d"]),
                _counts.rmsnorm_flops(rows, z["d"]))
            calls += n * per
    ev = run.profile.kernels("rmsnorm_tile", "rmsnorm_loop")
    if not ev or len(ev) != calls:
        return None
    return 100.0 * least / sum(s for _, s in ev)
