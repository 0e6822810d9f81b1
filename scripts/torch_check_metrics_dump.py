#!/usr/bin/env python
"""CI gate over the PyTorch port: the Prometheus export round-trips and
covers the registry (`scripts/check_metrics_dump.py` over `repro_torch`).

Drives a port store end to end on `--device` (the card by default) with
an enabled ObsPlane, dumps both export formats, then asserts:

1. the Prometheus text parses with `repro_torch.obs.parse_prometheus`
   (summary-style quantile lines, counter samples, the enabled marker);
2. every histogram site in `obs.HISTOGRAM_SITES` appears in the text —
   a site dropped from the export is invisible to a scraper even if the
   store still records it;
3. the JSON dump loads and carries the same histogram sites plus the
   counters block; the drive's reclaimed functions were restored, so
   `recovery.session_us` holds a sample per recovery and the counters
   count the chunks restored;
4. `ISTORE_METRICS_DUMP` names the same registry (the atexit hook path
   is exercised by running a child interpreter with the env var set,
   its store on the same device).

Exits non-zero on any miss.

Usage: PYTHONPATH=src python scripts/torch_check_metrics_dump.py
       [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(_HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np                                        # noqa: E402

from repro_torch.core import Clock, InfiniStore, StoreConfig  # noqa: E402
from repro_torch.obs import (HISTOGRAM_SITES, METRIC_SITES,  # noqa: E402
                             ObsPlane, parse_prometheus)

_CHILD = """
import os, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.core import Clock, InfiniStore, StoreConfig
st = InfiniStore(StoreConfig(device={device!r}),
                 clock=Clock())                  # auto-plane via env
st.put("k", np.arange(2048, dtype=np.uint8))
assert st.get("k") is not None
st.close()
"""


def _drive(plane: ObsPlane, device: str) -> InfiniStore:
    st = InfiniStore(StoreConfig(obs=plane, device=device), clock=Clock())
    rng = np.random.default_rng(3)
    for i in range(6):
        st.put(f"k{i}", rng.bytes(32_000))
    assert st.flush_writeback(timeout=600.0)
    for fid in list(st.sms.slabs):   # force the COS path and recovery
        st.inject_failure(fid)
    for i in range(6):
        assert st.get(f"k{i}") is not None
    return st


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's metrics-export "
                                 "gate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plane = ObsPlane(name="ci")
    st = _drive(plane, args.device)
    with tempfile.TemporaryDirectory(prefix="metrics-dump-") as td:
        prom_path = os.path.join(td, "metrics.prom")
        json_path = os.path.join(td, "metrics.json")
        st.dump_metrics(prom_path)
        st.dump_metrics(json_path)
        text = open(prom_path).read()
        parsed = parse_prometheus(text)
        for site in sorted(HISTOGRAM_SITES):
            name = "istore_" + site.replace(".", "_").replace("-", "_")
            assert name in text, f"site {site!r} missing from export"
            assert name in parsed and f"{name}_count" in parsed, \
                f"site {site!r} not parseable back out"
        assert parsed["istore_obs_enabled"] == {"": 1.0}
        jdump = json.load(open(json_path))
        assert set(jdump["histograms"]) == set(HISTOGRAM_SITES)
        assert jdump["counters"], "stats counters missing from JSON dump"
        sessions = (jdump["counters"]["recovery_local"]
                    + jdump["counters"]["recovery_parallel"])
        assert sessions >= 1 and jdump["counters"]["recovery_chunks"] > 0, \
            "the reclaimed functions were not restored"
        assert jdump["histograms"]["recovery.session_us"]["count"] == \
            sessions, "recovery.session_us missed a recovery"
        assert set(jdump["sites"]) == set(METRIC_SITES)
        st.close()

        # the env-var atexit hook: a child interpreter with the dump
        # path set must leave a parseable file behind on clean exit
        env_path = os.path.join(td, "atexit.prom")
        env = dict(os.environ, ISTORE_METRICS_DUMP=env_path,
                   PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, "-c",
                        _CHILD.format(src=os.path.join(ROOT, "src"),
                                      device=args.device)],
                       check=True, env=env, cwd=ROOT)
        assert os.path.exists(env_path), "atexit dump never written"
        parsed_env = parse_prometheus(open(env_path).read())
        assert parsed_env["istore_obs_enabled"] == {"": 1.0}
    print(f"metrics dump gate: {len(HISTOGRAM_SITES)} histogram sites "
          f"exported, {len(parsed)} parsed samples, atexit hook OK "
          f"(device {args.device})")


if __name__ == "__main__":
    main()
