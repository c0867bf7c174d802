"""Run telemetry of the port: the subset the ported layers touch.

``registry()`` (counters, gauges, P² quantile sketches), ``emit()`` on the
structured event bus, trace contexts + spans, and the oracle agreement
scores of ``lineage``. Copies of the matching parts of ``feddrift_tpu/obs``;
the run-health alerts (``obs.alerts``), the flight recorder
(``obs.blackbox``) and incident bundles (``obs.incident``) are modules of
their own. The fleet, live and host-profiler planes are not ported yet.
"""

from __future__ import annotations

from feddrift_torch.obs.events import configure, emit, get_bus  # noqa: F401
from feddrift_torch.obs.instruments import Registry, registry  # noqa: F401
from feddrift_torch.obs import lineage, quantiles, spans  # noqa: F401
