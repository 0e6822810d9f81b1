"""Prompt tokens of the prefills that ended inside the window over their
time (`ServeStats.prefill_seconds`), in tokens/s."""


def read(run):
    done = [b for b in run.log.get("batches", []) if b["prefill_end"] <= run.t1]
    secs = sum(b["prefill_s"] for b in done)
    if not done or secs <= 0:
        return None
    return sum(b["prompts"].size for b in done) / secs
