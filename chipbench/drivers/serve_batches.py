"""Lockstep batches through the port's `ServeEngine` over the SMS-paged
KV cache: each batch is `batch` prompts of `prompt_tokens` token ids
drawn from the seed, prefilled together and decoded greedily for
`new_tokens` steps (the prefill's token and one per step are served),
batch after batch until the window closes (the
batch running then is finished and checked, but only its steps that
ended inside the window count).

The weights are the benchmark's own (`reference.qwen_moe.make_weights`),
made on the card from the seed in the type they are served in and handed
to the engine. Warm-up runs one batch of the window's shapes with
`warm_new_tokens` steps. A traced run records the first
`trace_batches` batches of the window (a batch is about a million
device operations).

The check, after the window, once the peak memory is read and the
engine is freed: for `check_requests` finished requests drawn from the
seed, the float32 reference, fed the same weights (made again from the
seed) and the prompt followed by the served tokens, gives the logits at
every served position; the number compared is the mean, over those
positions, of the gap by which the served token's logit lies below the
reference's best there (the widest gap is noted beside it).
"""
from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np

from chipbench.reference import qwen_moe


class _Stamped(list):
    """A list of step durations that also notes when each step ended
    (the engine appends a step's duration as its tokens reach the
    host)."""

    def __init__(self):
        super().__init__()
        self.ends = []

    def append(self, x) -> None:
        self.ends.append(time.monotonic())
        super().append(x)


def model_config(c: dict):
    """The program's `ModelConfig` for a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    z = qwen_moe.dims(c)
    return ModelConfig(
        name=c["name"], family="moe", num_layers=z["L"], d_model=z["d"],
        num_heads=z["H"], num_kv_heads=z["K"], head_dim=z["hd"],
        d_ff=z["f"], vocab_size=z["V"], qkv_bias=True,
        rope_theta=float(c["rope_theta"]), rms_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"],
        moe=MoEConfig(num_experts=z["E"], top_k=z["top_k"], d_expert=z["f"],
                      num_shared_experts=1,
                      d_shared=z["fs"],
                      capacity_factor=c["capacity_factor"],
                      renorm_topk=c["norm_topk_prob"]),
        source=c["source"])


def prompts(run, b: int) -> np.ndarray:
    """Batch b's prompt ids, (batch, prompt_tokens) int32, from the seed
    (b = -1: the warm-up's)."""
    m = run.mix
    rng = np.random.default_rng([run.seed, b + 1])
    return rng.integers(0, run.config["vocab_size"],
                        (m["batch"], m["prompt_tokens"])).astype(np.int32)


def setup(run) -> None:
    import torch
    from repro_torch.models.transformer import abstract_params
    from repro_torch.serving import ServeConfig, ServeEngine
    c, m = run.config, run.mix
    cfg = model_config(c)
    shapes = qwen_moe.param_shapes(c)
    want = {k: tuple(v.shape) for k, v in abstract_params(cfg).items()}
    if want != shapes:
        raise RuntimeError(f"the program's parameters {want} are not the "
                           f"reference's {shapes}")
    dtype = getattr(torch, c["torch_dtype"])
    params = qwen_moe.make_weights(c, run.seed, run.device, dtype)
    eng = ServeEngine(cfg, ServeConfig(
        batch_slots=m["batch"], max_len=m["prompt_tokens"] + m["new_tokens"],
        page_size=m["page_size"]), params=params, device=run.device)
    del params
    # the engine returns the decode steps' tokens; the first served token
    # (the prefill's) is the first step's input: note it as it passes
    first = []
    decode = eng._decode_fn

    def noted(params, batch, cache):
        if not first:
            first.append(batch["token"])
        return decode(params, batch, cache)

    eng._decode_fn = noted
    run.log.update(engine=eng, cfg=cfg, batches=[], first=first)


def warm(run) -> None:
    import torch
    eng = run.log["engine"]
    eng.generate(prompts(run, -1), run.mix["warm_new_tokens"])
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def window(run) -> None:
    eng, m = run.log["engine"], run.mix
    batches = run.log["batches"]
    b = 0
    while time.perf_counter() < run.t1:
        eng.stats.step_seconds = _Stamped()
        p0 = eng.stats.prefill_seconds
        p = prompts(run, b)
        run.log["first"].clear()
        t = time.perf_counter()
        out = eng.generate(p, m["new_tokens"])
        out = np.concatenate([run.log["first"][0].cpu().numpy().reshape(
            -1, 1).astype(out.dtype), out], axis=1)
        steps = eng.stats.step_seconds
        # monotonic -> perf_counter: both tick with the host's clock
        shift = time.perf_counter() - time.monotonic()
        batches.append(dict(start=t, prompts=p, served=out,
                            traced=run.tracing(),
                            prefill_end=t + eng.stats.prefill_seconds - p0,
                            prefill_s=eng.stats.prefill_seconds - p0,
                            step_s=list(steps),
                            step_end=[e + shift for e in steps.ends]))
        b += 1
        if b >= m["trace_batches"]:
            run.end_trace()
    run.attempted = sum(len(x["served"]) for x in batches)
    run.failed = 0


def steps_in_window(run):
    """(duration, batch size) of every decode step that ended inside the
    window."""
    out = []
    for bt in run.log["batches"]:
        out += [(s, len(bt["served"])) for s, e in
                zip(bt["step_s"], bt["step_end"]) if e <= run.t1]
    return out


def sampled_requests(run):
    """The check's sample of finished requests, drawn from the seed: the
    reference's input (each prompt and its served tokens but the last)
    and the served tokens, on the run's device."""
    import torch
    m, batches = run.mix, run.log["batches"]
    rng = np.random.default_rng([run.seed, 3])
    picks = rng.choice(len(batches) * m["batch"], size=m["check_requests"],
                       replace=False)
    toks = np.stack([np.concatenate(
        [batches[i // m["batch"]]["prompts"][i % m["batch"]],
         batches[i // m["batch"]]["served"][i % m["batch"]]]) for i in picks])
    return (torch.from_numpy(toks[:, :-1]).to(run.device),
            torch.from_numpy(toks[:, m["prompt_tokens"]:]).to(run.device))


def check(run, control: Optional[str] = None) -> list:
    """The number compared and its limit. With `control` (a precision of
    `qwen_moe.logits`, such as "fp8"), the tokens judged are the ones
    the reference computed in that precision puts first at the same
    positions of the same requests, in the program's place."""
    import torch
    lg, c, m = run.log, run.config, run.mix
    lg["engine"] = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    tokens, served = sampled_requests(run)
    weights = qwen_moe.make_weights(c, run.seed, run.device,
                                    getattr(torch, c["torch_dtype"]))
    drops = [0, 0]
    ref = qwen_moe.logits(c, weights, tokens, m["prompt_tokens"],
                          drops=drops)
    if control is not None:
        served = qwen_moe.logits(c, weights, tokens, m["prompt_tokens"],
                                 control).argmax(-1)
    gaps = qwen_moe.served_gaps(ref, served)
    lg["gaps"] = gaps.cpu()
    del weights, ref
    lim = c["check"]["logit_gap_mean_max"]
    lg["gap_max"] = float(gaps.max())
    z = qwen_moe.dims(c)
    prompt_pairs = len(tokens) * m["prompt_tokens"] * z["top_k"] * z["L"]
    lg["notes"] = {"served_logit_gap_max": lg["gap_max"],
                   "served_positions_compared": gaps.numel(),
                   "prefill_pairs_dropped": drops[1],
                   "prefill_pairs_dropped_pct": 100.0 * drops[1]
                   / prompt_pairs}
    run.failed = int((gaps.mean(dim=1) > lim).sum())
    return [("served_logit_gap_mean", float(gaps.mean()), lim)]
