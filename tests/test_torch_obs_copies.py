"""The port's copies of the trace plane's modules against the JAX
package's, as parametrised cases with equal outputs on equal inputs:
``utils/tracing.py`` (``PhaseTracer``; ``tests/test_tracing.py`` and
``tests/test_obs.py::TestPhaseTracerConcurrency``), ``obs/hostprof.py``
(``tests/test_hostprof.py``), ``obs/spans.py``'s recorder and
``obs/instruments.py``'s histogram. ``device_trace``, the port's
``xla_trace``, is held on its own contract (the reference's needs a JAX
profiler session)."""

import importlib
import json
import os
import threading
import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

PACKAGES = ["feddrift_tpu", "feddrift_torch"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ----------------------------------------------------------------------
# PhaseTracer
@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_tracer_accumulates(pkg):
    tr = _mod(pkg, "utils.tracing").PhaseTracer()
    for _ in range(3):
        with tr.phase("a"):
            time.sleep(0.01)
    with tr.phase("b"):
        pass
    s = tr.summary()
    assert s["a"]["count"] == 3 and s["a"]["total_s"] >= 0.03
    assert s["b"]["count"] == 1
    assert abs(s["a"]["mean_s"] - s["a"]["total_s"] / 3) < 1e-9
    tr.reset()
    assert tr.summary() == {}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_tracer_exception_still_recorded(pkg):
    tr = _mod(pkg, "utils.tracing").PhaseTracer()
    with pytest.raises(RuntimeError):
        with tr.phase("boom"):
            raise RuntimeError
    assert tr.summary()["boom"]["count"] == 1


def _nested_counts(pkg):
    tr = _mod(pkg, "utils.tracing").PhaseTracer()
    with tr.phase("outer"):
        with tr.phase("inner"):
            pass
        with tr.phase("outer"):         # re-entrant same name
            pass
    s = tr.summary()
    assert s["outer"]["total_s"] >= s["inner"]["total_s"]
    return {k: v["count"] for k, v in s.items()}


def test_phase_tracer_nested_and_reentrant_alike():
    got = {pkg: _nested_counts(pkg) for pkg in PACKAGES}
    assert got["feddrift_torch"] == got["feddrift_tpu"] \
        == {"outer": 2, "inner": 1}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_tracer_thread_safety(pkg):
    tr = _mod(pkg, "utils.tracing").PhaseTracer()

    def worker():
        for _ in range(500):
            with tr.phase("shared"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.summary()["shared"]["count"] == 2000


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_tracer_registry_hook_and_spans(pkg):
    reg = _mod(pkg, "obs.instruments").Registry()
    rec = _mod(pkg, "obs.spans").SpanRecorder(None)
    tr = _mod(pkg, "utils.tracing").PhaseTracer(registry=reg, spans=rec)
    with tr.phase("train_round"):
        pass
    snap = reg.snapshot()['phase_seconds{phase="train_round"}']
    assert snap["count"] == 1 and sum(snap["buckets"].values()) == 1
    assert [(s["name"], s["cat"]) for s in rec.spans()] \
        == [("train_round", "phase")]


def _runner_phases(pkg, chunk):
    cfg_mod = _mod(pkg, "config")
    run_mod = _mod(pkg, "simulation.runner")
    cfg = cfg_mod.ExperimentConfig(
        dataset="sea", model="fnn", concept_drift_algo="win-1",
        train_iterations=1, comm_round=2, epochs=1, sample_num=16,
        batch_size=8, client_num_in_total=4, client_num_per_round=4,
        concept_num=2, frequency_of_the_test=1, chunk_rounds=chunk)
    kw = {"device": "cpu"} if pkg == "feddrift_torch" else {}
    exp = run_mod.Experiment(cfg, **kw)
    exp.run_iteration(0)
    assert exp.tracer.summary() == {}      # per-iteration deltas
    return {k: v["count"] for k, v in exp.last_phase_summary.items()}


@pytest.mark.parametrize("chunk", [True, False], ids=["fused", "per_round"])
def test_runner_phases_alike(chunk):
    """``tests/test_tracing.py::test_runner_integration``: the fused step is
    one train_round and one eval phase, the per-round path one of each a
    round, the cluster phase twice a step; both packages alike."""
    got = {pkg: _runner_phases(pkg, chunk) for pkg in PACKAGES}
    want = {"train_round": 1 if chunk else 2, "eval": 1 if chunk else 2,
            "cluster": 2}
    assert got["feddrift_torch"] == got["feddrift_tpu"] == want


def test_annotate_alike():
    import jax.numpy as jnp
    import torch
    with _mod("feddrift_tpu", "utils.tracing").annotate("region"):
        ref = float((jnp.ones((4,)) * 2).sum())
    with _mod("feddrift_torch", "utils.tracing").annotate("region"):
        ours = float((torch.ones(4) * 2).sum())
    assert ours == ref == 8.0


def test_device_trace_writes_a_trace_and_nests_as_a_no_op(tmp_path):
    import torch

    from feddrift_torch import obs
    from feddrift_torch.utils.tracing import annotate, device_trace
    bus = obs.configure(None)
    outer, inner = str(tmp_path / "outer"), str(tmp_path / "inner")
    with device_trace(outer):
        with device_trace(inner):       # nested: the outer capture owns it
            with annotate("nested_region"):
                y = (torch.ones(8) * 3).sum()
    assert float(y) == 24.0
    assert not os.path.exists(inner)
    files = os.listdir(outer)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(outer, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "nested_region" in names
    assert [e["trace_dir"] for e in bus.events("profile_captured")] == [outer]


# ----------------------------------------------------------------------
# obs/hostprof.py
@pytest.mark.parametrize("pkg", PACKAGES)
def test_sampling_profiler_start_stop_restart(pkg, tmp_path):
    path = str(tmp_path / "hostprof.jsonl")
    prof = _mod(pkg, "obs.hostprof").SamplingProfiler(hz=200.0, path=path)
    assert not prof.running
    prof.start()
    prof.start()                              # second start is a no-op
    assert prof.running
    time.sleep(0.05)
    prof.stop()
    prof.stop()                               # second stop is a no-op
    prof.close()                              # close is an alias
    assert not prof.running
    n1 = prof.samples
    assert n1 > 0
    prof.start()
    time.sleep(0.05)
    prof.stop()
    assert prof.samples > n1
    assert os.path.exists(path)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sampling_profiler_folds_other_threads(pkg, tmp_path):
    stop = threading.Event()

    def parked_worker():
        while not stop.wait(0.002):
            pass

    t = threading.Thread(target=parked_worker, daemon=True)
    t.start()
    path = str(tmp_path / "hostprof.jsonl")
    prof = _mod(pkg, "obs.hostprof").SamplingProfiler(hz=500.0, path=path,
                                                      pid=3)
    with prof:
        time.sleep(0.15)
    stop.set()
    t.join(timeout=2.0)
    folded = prof.folded()
    assert any("parked_worker" in stack for stack in folded)
    text = prof.folded_text()
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()]
    assert counts == sorted(counts, reverse=True)
    assert sum(counts) >= prof.samples
    assert open(prof.write_folded(str(tmp_path / "x.folded"))).read() == text
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert rows
    for r in rows:
        assert r["cat"] == "hostprof" and r["pid"] == 3 and r["dur"] > 0
        assert r["tid"].startswith("hostprof:") and r["args"]["stack"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sampling_profiler_concurrent_start_stop(pkg):
    prof = _mod(pkg, "obs.hostprof").SamplingProfiler(hz=1000.0)
    errs = []

    def churn():
        try:
            for _ in range(20):
                prof.start()
                prof.stop()
        except Exception as e:  # noqa: BLE001 — the assertion target
            errs.append(e)

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    prof.stop()
    assert not errs and not prof.running


@pytest.mark.parametrize("pkg", PACKAGES)
def test_configure_profiler_replaces_and_clears(pkg, tmp_path):
    hp = _mod(pkg, "obs.hostprof")
    try:
        p1 = hp.configure_profiler(100.0, path=str(tmp_path / "a.jsonl"))
        assert p1 is hp.get_profiler() and p1.running
        p2 = hp.configure_profiler(100.0, path=str(tmp_path / "b.jsonl"))
        assert not p1.running
        assert p2 is hp.get_profiler() and p2.running
        assert hp.configure_profiler(0.0) is None
        assert hp.get_profiler() is None and not p2.running
    finally:
        hp.configure_profiler(0.0)


def _ledger_run(pkg):
    hp = _mod(pkg, "obs.hostprof")
    reg = _mod(pkg, "obs.instruments").registry()
    reg.reset()
    try:
        led = hp.HostLedger()
        led.add_seconds("cohort_plan", 0.25)
        led.add_seconds("cohort_plan", 0.25)
        led.add_seconds("noise", -1.0)        # non-positive ignored
        led.set_bytes("registry_columns", 276)
        led.set_bytes("assign_hist", 48)
        led.set_bytes("routing_table", 1000)
        recs = [led.finalize(iteration=7, rounds=4, emit_event=False),
                led.finalize(iteration=8, rounds=4, emit_event=False)]
        led.add_seconds("drift_decision", 0.5)
        recs.append(led.finalize(iteration=9, rounds=4, emit_event=False))
        for r in recs:
            assert r.pop("rss_bytes") > 0 and r.pop("rss_peak_bytes") > 0
        snap = {k: v for k, v in reg.snapshot().items()
                if not k.startswith("host_rss")}
        return recs, snap, led.top_bytes(2)
    finally:
        reg.reset()


def test_host_ledger_finalize_alike():
    got = {pkg: _ledger_run(pkg) for pkg in PACKAGES}
    assert got["feddrift_torch"] == got["feddrift_tpu"]
    recs, snap, top = got["feddrift_torch"]
    assert recs[0]["seconds"] == {"cohort_plan": 0.5}
    assert recs[1]["seconds"] == {}
    assert snap['host_ledger_seconds_total{subsystem="cohort_plan"}'] == 0.5
    assert top == [("routing_table", 1000), ("registry_columns", 276)]


def test_nbytes_of_counts_tensors_as_arrays():
    import numpy as np
    import torch

    from feddrift_torch.obs.hostprof import nbytes_of
    tree = {"a": [np.zeros((4, 3), np.float32)], "b": (np.zeros(5, np.int64),
                                                       "text")}
    ref = _mod("feddrift_tpu", "obs.hostprof").nbytes_of(tree)
    assert nbytes_of(tree) == ref == 88
    assert nbytes_of({"a": [torch.zeros((4, 3))],
                      "b": (torch.zeros(5, dtype=torch.int64), "text")}) == 88


# ----------------------------------------------------------------------
# obs/spans.py and obs/instruments.py
def _spans_run(pkg, tmp_path):
    sp = _mod(pkg, "obs.spans")
    path = str(tmp_path / pkg / "spans.jsonl")
    rec = sp.SpanRecorder(path, max_bytes=600)
    seen = []
    for i in range(8):
        with rec.span("seg", cat="round", on_close=lambda w, dt: seen.append(
                dt >= 0), iteration=i):
            pass
    rec.close()
    # a disabled recorder still measures for its on_close accounting
    off = sp.SpanRecorder(None, enabled=False)
    with off.span("x", on_close=lambda w, dt: seen.append(dt >= 0)):
        pass
    rows = [json.loads(line) for p in (path + ".1", path)
            for line in open(p)]
    return (rec.rotations > 0, [r["args"]["iteration"] for r in rows],
            all(seen), len(seen), off.spans())


def test_span_recorder_rotates_and_times_alike(tmp_path):
    got = {pkg: _spans_run(pkg, tmp_path) for pkg in PACKAGES}
    assert got["feddrift_torch"] == got["feddrift_tpu"]
    rotated, iters, ok, n, off = got["feddrift_torch"]
    assert rotated and ok and n == 9 and off == []
    assert iters == sorted(iters) and iters[-1] == 7


def test_histogram_snapshot_alike():
    snaps = {}
    for pkg in PACKAGES:
        reg = _mod(pkg, "obs.instruments").Registry()
        h = reg.histogram("round_wall_seconds")
        for v in (5e-5, 0.003, 0.003, 0.7, 200.0):
            h.observe(v)
        snaps[pkg] = reg.snapshot()
    assert snaps["feddrift_torch"] == snaps["feddrift_tpu"]
    assert snaps["feddrift_torch"]["round_wall_seconds"]["count"] == 5


def test_hbm_watermark_is_silent_on_the_cpu():
    from feddrift_torch import obs
    from feddrift_torch.obs import costmodel
    bus = obs.configure(None)
    assert costmodel.record_hbm_watermark("cpu", iteration=0) is None
    assert bus.events("hbm_watermark") == []
