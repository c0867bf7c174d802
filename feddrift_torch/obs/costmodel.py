"""Live device-memory watermarks (the part of the reference's cost model
the port has so far).

Copy of ``feddrift_tpu/obs/costmodel.py::record_hbm_watermark`` and
``device_memory_stats`` on the CUDA caching allocator:
``torch.cuda.memory_stats`` gives ``allocated_bytes.all.current`` and
``.peak``, reported under the reference's names ``bytes_in_use`` and
``peak_bytes_in_use``. A CPU device exposes no allocator stats: the call
returns None and emits nothing, as the reference's does on its CPU
backend. The program-cost capture, peaks and roofline of the reference's
module wait for the rest of the cost model (ROADMAP §1 "The rest").
"""

from __future__ import annotations

from typing import Any

from feddrift_torch.obs import events, instruments


def device_memory_stats(device=None) -> dict | None:
    """``{"bytes_in_use", "peak_bytes_in_use"}`` of a CUDA device (None:
    the current one), or None for a CPU device or without a card."""
    try:
        import torch
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(device)
    except Exception:    # noqa: BLE001 — observability stays passive
        return None
    if not stats:
        return None
    return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak")}


def record_hbm_watermark(device=None, **context: Any) -> dict | None:
    """Emit one ``hbm_watermark`` event and refresh the HBM gauges from the
    live allocator stats. Returns the stats, or None (silently) where the
    device has none: per-iteration callers need no guard."""
    stats = device_memory_stats(device)
    if stats is None:
        return None
    in_use = stats.get("bytes_in_use")
    peak = stats.get("peak_bytes_in_use")
    reg = instruments.registry()
    if in_use is not None:
        reg.gauge("hbm_bytes_in_use").set(in_use)
    if peak is not None:
        reg.gauge("hbm_live_peak_bytes").set(peak)
        reg.gauge("hbm_peak_bytes").set(peak)
    events.emit("hbm_watermark", bytes_in_use=in_use, peak_bytes=peak,
                **context)
    return stats
