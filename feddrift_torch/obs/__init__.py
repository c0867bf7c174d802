"""Run telemetry of the port: copies of ``feddrift_tpu/obs``'s modules.

``registry()`` (counters, gauges, histograms, P² quantile sketches),
``emit()`` on the structured event bus, spans and the Chrome-trace export
(``spans``), the host-plane ledger and sampling profiler (``hostprof``),
live device-memory watermarks (``costmodel``), the cluster genealogy and
oracle scores (``lineage``); the run-health alerts (``obs.alerts``), the
flight recorder (``obs.blackbox``), incident bundles (``obs.incident``),
the run report (``obs.report``) and the round critical path
(``obs.critical_path``) are modules of their own. Their file formats are
the reference's, so either package's tools read either package's run
directory. The live/SLO/fleet plane and ``regress`` are not ported yet.
"""

from __future__ import annotations

from feddrift_torch.obs.events import configure, emit, get_bus  # noqa: F401
from feddrift_torch.obs.instruments import Registry, registry  # noqa: F401
from feddrift_torch.obs import (costmodel, hostprof, lineage,  # noqa: F401
                                quantiles, spans)
