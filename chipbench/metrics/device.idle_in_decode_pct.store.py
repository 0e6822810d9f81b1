"""Share of the traced window in which the card was idle while the
store's daemon thread ran the codec's decode stage (inside its
`get.decode` spans: staging the survivors, launching the product,
unframing), in %."""
from chipbench.metrics._timeline import idle_in_pct


def read(run):
    return idle_in_pct(run, "get.decode")
