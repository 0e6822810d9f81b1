"""Share of the traced window with no kernel, copy or set on the card,
in the store cells, in %."""
from chipbench.metrics._idle import idle_pct


def read(run):
    return idle_pct(run)
