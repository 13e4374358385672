"""Tracing and metrics for the serving runtime (port of ``repro.obs``):
``trace`` (``Tracer``, the bounded ring buffer of span / instant events),
``export`` (Chrome trace-event JSON, Perfetto-loadable) and ``metrics``
(``Histogram`` / ``MetricsRegistry``). Configured by the ``ObsPlan``
section of ``ServePlan``; tracing is off by default."""
from repro_torch.obs.export import (  # noqa: F401
    chrome_events,
    merge_trace_files,
    trace_payload,
    write_trace,
)
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    BATCHER_SPANS,
    DEFAULT_CAPACITY,
    PORT_SPANS,
    Tracer,
)
