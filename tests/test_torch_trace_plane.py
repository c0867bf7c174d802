"""The training run's trace plane against the JAX package's.

One tiny run per package and configuration, module-scoped: SEA at T 3, R 10
on the fused path, and CFL (``cfl_0.1_win-1``, always per round) at
``profile_rounds`` 1 and 10, each with ``out_dir`` under a temporary
directory. The reference's runs are the JAX package's own on the CPU.

- Run directories: both packages' ``report.summarize`` / ``render``,
  ``spans.build_trace``, ``critical_path.analyze`` and
  ``lineage.summarize`` give equal results on a reference run directory
  and on a port run directory.
- Schema: the port run's event kinds and their fields, span names and
  cats, ``round_breakdown`` segment keys and ``profiled_rounds`` per
  iteration equal the reference run's. Left out of the comparison: what
  only the JAX package's compiler emits (``jit_compile`` events and
  spans, ``program_cost``) and ``run_start``'s precision and population
  fields, whose modules wait for their ROADMAP §1 items.
- The planes change no number: a run with every plane on is bitwise the
  run with them all off, fused and per round.
- The verbs: ``python -m feddrift_torch report|critical_path|lineage``
  exit 0 on a port run directory.
"""

import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(train_iterations=3, comm_round=10)
CFL = dict(SMALL, concept_drift_algo_arg="cfl_0.1_win-1")
# (name, config) of the runs each package makes
RUNS = (("sea", dict(SMALL, hostprof_hz=100.0)),
        ("cfl_p1", dict(CFL, profile_rounds=1)),
        ("cfl_p10", dict(CFL, profile_rounds=10)))
# what only the JAX package's compiler emits, and run_start's fields of
# modules the port has not yet (precision, population)
REFERENCE_ONLY_KINDS = {"jit_compile", "jit_recompile", "program_cost"}
REFERENCE_ONLY_SPANS = {("jit_compile", "round")}
REFERENCE_ONLY_FIELDS = {"run_start": {"compute_dtype", "param_dtype",
                                       "population"}}


def _load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """{(package, run): run directory} of both packages' runs."""
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.obs import hostprof as jhostprof
    from feddrift_tpu.simulation.runner import Experiment as JExp

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.obs import hostprof
    from feddrift_torch.simulation.runner import Experiment
    root = tmp_path_factory.mktemp("trace_plane")
    out = {}
    try:
        for name, kw in RUNS:
            out["ref", name] = str(root / "ref" / name)
            JExp(JCfg(**kw), out_dir=out["ref", name]).run()
            out["port", name] = str(root / "port" / name)
            Experiment(ExperimentConfig(**kw), out_dir=out["port", name],
                       device="cpu").run()
    finally:
        jhostprof.configure_profiler(0.0)
        hostprof.configure_profiler(0.0)
    return out


def _tools(pkg):
    import importlib
    return {name: importlib.import_module(f"{pkg}.obs.{name}")
            for name in ("report", "spans", "critical_path", "lineage")}


@pytest.mark.parametrize("tool", ["report.summarize", "report.render",
                                  "spans.build_trace", "critical_path.analyze",
                                  "lineage.summarize"])
@pytest.mark.parametrize("side", ["ref", "port"])
def test_both_packages_read_either_run_dir_alike(run_dirs, side, tool):
    mod, fn = tool.split(".")
    for name, _ in RUNS:
        d = run_dirs[side, name]
        got = {}
        for pkg in ("feddrift_tpu", "feddrift_torch"):
            f = getattr(_tools(pkg)[mod], fn)
            got[pkg] = f(_tools(pkg)["report"].summarize(d)) \
                if fn == "render" else f(d)
        assert got["feddrift_torch"] == got["feddrift_tpu"], (name, tool)
        assert got["feddrift_torch"]


def _schema(d):
    kinds = {}
    for e in _load(os.path.join(d, "events.jsonl")):
        if e["kind"] in REFERENCE_ONLY_KINDS:
            continue
        kinds.setdefault(e["kind"], set()).update(
            set(e) - REFERENCE_ONLY_FIELDS.get(e["kind"], set()))
    spans = {(s["name"], s["cat"])
             for s in _load(os.path.join(d, "spans.jsonl"))} \
        - REFERENCE_ONLY_SPANS
    bds = [e for e in _load(os.path.join(d, "events.jsonl"))
           if e["kind"] == "round_breakdown"]
    ends = [e for e in _load(os.path.join(d, "events.jsonl"))
            if e["kind"] == "iteration_end"]
    return {"kinds": kinds, "spans": spans,
            "segments": [sorted(e["segments"]) for e in bds],
            "profiled_rounds": [e["profiled_rounds"] for e in bds],
            "phase_counts": [{k: v["count"] for k, v in e["phases"].items()}
                             for e in ends]}


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_port_run_schema_equals_the_reference(run_dirs, name):
    ours, ref = _schema(run_dirs["port", name]), \
        _schema(run_dirs["ref", name])
    assert ours["kinds"] == ref["kinds"]
    assert ours["spans"] == ref["spans"]
    assert ours["segments"] == ref["segments"]
    assert ours["profiled_rounds"] == ref["profiled_rounds"]
    assert ours["phase_counts"] == ref["phase_counts"]
    want = {"sea": [10, 10, 10], "cfl_p1": [10, 10, 10],
            "cfl_p10": [1, 1, 1]}[name]
    assert ours["profiled_rounds"] == want
    assert {"dispatch", "device_compute", "writeback", "eval",
            "drift_decision", "dispatch_gap"} <= set(ours["segments"][0])


def test_fused_breakdown_splits_dispatch_from_the_wait(run_dirs):
    """The fused step's host enqueue is ``dispatch``, the wait after it
    ``device_compute`` (a span with the step's first global round), and
    the segments partition the iteration span's wall."""
    d = run_dirs["port", "sea"]
    waits = [s for s in _load(os.path.join(d, "spans.jsonl"))
             if s["name"] == "device_compute"]
    assert [s["args"]["round"] for s in waits] == [0, 10, 20]
    from feddrift_torch.obs import critical_path
    rows = critical_path.analyze(d)["iterations"]
    assert len(rows) == 3
    for row in rows:
        assert 0.95 <= row["coverage"] <= 1.05
        assert row["segments"]["dispatch"] > 0
        assert 0.0 <= row["host_overhead_frac"] <= 1.0
    assert os.path.getsize(os.path.join(d, "hostprof.folded")) > 0


def _run(kw, out_dir=None):
    """A port run of ``kw`` on the CPU: its (round, Test/Acc, Train/Loss)
    series and the ``Experiment``."""
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.obs import hostprof
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**kw), out_dir=out_dir, device="cpu")
    try:
        exp.run()
    finally:
        hostprof.configure_profiler(0.0)
    return [(r["round"], r["Test/Acc"], r["Train/Loss"])
            for r in exp.logger.history], exp


@pytest.mark.parametrize("kw", [SMALL, CFL], ids=["fused", "per_round"])
def test_planes_change_no_number(kw, tmp_path):
    off, _ = _run(dict(kw, profile_rounds=10 ** 9))
    on, exp = _run(dict(kw, hostprof_hz=200.0, debug_checks=True,
                        trace_sync=True, profile_rounds=1), str(tmp_path))
    assert on == off
    assert [e["profiled_rounds"] for e in
            exp.events.events("round_breakdown")] == [10, 10, 10]


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "feddrift_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("verb", [
    ("report", "--trace"), ("report", "--json"),
    ("report", "--follow", "--follow-timeout", "10"),
    ("critical_path", "--flame"), ("critical_path", "--json"),
    ("lineage", "--dot", "{dir}/lineage.dot"), ("lineage", "--json")],
    ids=lambda v: "_".join(a.strip("-") for a in v[:2]))
def test_verbs_exit_0_on_a_port_run_dir(run_dirs, verb):
    d = run_dirs["port", "sea"]
    out = _cli(verb[0], d, *(a.format(dir=d) for a in verb[1:]))
    assert out.returncode == 0, out.stderr
    if verb[0] == "report" and verb[1] == "--trace":
        with open(os.path.join(d, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"iteration", "device_compute", "train_round",
                "round_breakdown"} <= names
    if verb[1] == "--flame":
        assert "host stacks while" in out.stdout
    if verb[0] == "lineage" and verb[1] == "--dot":
        assert os.path.getsize(os.path.join(d, "lineage.dot")) > 0
