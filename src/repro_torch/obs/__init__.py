"""repro_torch.obs — unified observability plane for the InfiniStore repro.

Three legs behind one off-by-default handle (`ObsPlane`):

- **Tracing** (`obs.trace`): per-op spans with ambient thread-local
  context, propagated across executor hops and across the process
  transports so worker-side spans stitch into the frontend's trace.
- **Metrics** (`obs.metrics`): lock-free log-spaced latency histograms
  with p50/p99/p999 extraction, bucket-mergeable across shards and
  worker processes, exported as Prometheus text / JSON.
- **Flight recorder** (`obs.recorder`): bounded structured-event ring
  mirrored to a small mmap'd file per crash domain, so a SIGKILL'd
  worker's last events (and spans) are recoverable forensics.

Site names are governed by `obs.sites.METRIC_SITES`; the
`metric_site` lint rule (`repro_torch.devtools`) enforces that every
instrumentation call uses a registered literal. See
`docs/observability.md` for the registry, span taxonomy, and event
schema.
"""
from repro_torch.obs.metrics import (LatencyHistogram, NBUCKETS,  # noqa: F401
                               bucket_of, merge_counts, parse_prometheus,
                               quantile_us, summarize, to_prometheus)
from repro_torch.obs.plane import (ObsPlane,  # noqa: F401
                             merge_metric_snapshots)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.sites import (EVENT_SITES, HISTOGRAM_SITES,  # noqa: F401
                             METRIC_SITES, SPAN_SITES)
from repro_torch.obs.trace import NOOP_CM, Span, Tracer, current, use  # noqa: F401
