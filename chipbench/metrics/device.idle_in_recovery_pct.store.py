"""Share of the traced window in which the card was idle while the
store restored a reclaimed function (inside its `recovery.session`
spans), in %: the part of the idle time that recovery's host work
holds, on `device.idle_pct.store`'s scale."""
from chipbench.metrics._timeline import idle_in_pct


def read(run):
    return idle_in_pct(run, "recovery.session")
