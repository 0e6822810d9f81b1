"""Share of the traced window in which the card was idle while the
store's daemon thread ran a GET batch (inside its `daemon.get_many`
spans), in %: the part of `device.idle_pct.store` that the daemon's
host work per GET holds."""
from chipbench.metrics._timeline import idle_in_pct


def read(run):
    return idle_in_pct(run, "daemon.get_many")
