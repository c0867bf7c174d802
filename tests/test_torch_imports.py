"""The port stands alone: importing it loads no JAX, no flax, nothing of
``feddrift_tpu`` and no scikit-learn (softcluster ``gmm`` is the port's
own EM); its entry points default to the CUDA device; and
``chip_smoke.py`` refuses to run without a card or outside the repo."""

import inspect
import json
import os
import shutil
import subprocess
import sys

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import feddrift_torch
names = [m.name for m in pkgutil.walk_packages(feddrift_torch.__path__,
                                               "feddrift_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "feddrift_tpu",
                                    "sklearn"))
print(len(names), bad)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 45           # every module of the package
    assert bad == "[]", bad


def test_fmow_data_imports_no_jax():
    """``data/fmow.py`` is the port's own copy: importing it (and building a
    small fmow dataset) loads nothing of the JAX package."""
    code = ("import sys\nfrom feddrift_torch.data import fmow\n"
            "from feddrift_torch.config import ExperimentConfig\n"
            "from feddrift_torch.data.registry import make_dataset\n"
            "ds = make_dataset(ExperimentConfig(dataset='fmow', "
            "fmow_image_size=4, train_iterations=1, sample_num=4))\n"
            "print(ds.x.shape, sorted(m for m in sys.modules if m.split('.')"
            "[0] in ('jax', 'jaxlib', 'flax', 'feddrift_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(10, 2, 4, 4, 4, 3) []"


# the trace plane's modules (each imported alone in a fresh process)
TRACE_PLANE_MODULES = ("feddrift_torch.obs.spans",
                       "feddrift_torch.obs.hostprof",
                       "feddrift_torch.obs.costmodel",
                       "feddrift_torch.obs.report",
                       "feddrift_torch.obs.critical_path",
                       "feddrift_torch.obs.lineage",
                       "feddrift_torch.obs.instruments",
                       "feddrift_torch.utils.tracing",
                       "feddrift_torch.utils.invariants")
_BAD = ("jax", "jaxlib", "flax", "feddrift_tpu")


@pytest.mark.parametrize("module", TRACE_PLANE_MODULES)
def test_trace_plane_module_imports_no_jax(module):
    code = (f"import sys, importlib\nimportlib.import_module({module!r})\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_BAD!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_verbs_are_host_only(tmp_path):
    """``report``, ``critical_path`` and ``lineage`` read a run directory
    without importing torch (so no CUDA state and no kernel build), JAX
    or the JAX package."""
    run = tmp_path / "run"
    run.mkdir()
    events = [{"_ts": 1.0, "kind": "run_start", "dataset": "sea",
               "concept_matrix": [[0, 1]], "clients": 2, "num_models": 2},
              {"_ts": 2.0, "kind": "cluster_assign", "iteration": 0,
               "assignment": [0, 1]},
              {"_ts": 3.0, "kind": "iteration_end", "iteration": 0,
               "wall_s": 1.0, "rounds": 2, "examples": 4,
               "phases": {"train_round": {"total_s": 0.5, "count": 1}}},
              {"_ts": 3.0, "kind": "round_breakdown", "iteration": 0,
               "wall_s": 1.0, "rounds": 2, "profiled_rounds": 2,
               "segments": {"dispatch": 0.4, "device_compute": 0.5,
                            "dispatch_gap": 0.1},
               "host_overhead_frac": 0.5},
              {"_ts": 4.0, "kind": "run_end"}]
    (run / "events.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in events))
    (run / "spans.jsonl").write_text(json.dumps(
        {"name": "iteration", "cat": "runner", "ts": 2e6, "dur": 1e6,
         "pid": 0, "tid": 1, "args": {"iteration": 0}}) + "\n")
    code = ("import sys\nfrom feddrift_torch.cli import main\n"
            f"d = {str(run)!r}\n"
            "rcs = [main(['report', d, '--trace']), main(['critical_path', d]),"
            " main(['lineage', d])]\n"
            "print(rcs, sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_BAD + ('torch', 'triton')!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[0, 0, 0] []"
    assert (run / "trace.json").is_file()


@pytest.mark.parametrize("target", [
    "feddrift_torch.core.pool:ModelPool.create",
    "feddrift_torch.convert:params_from_jax",
    "feddrift_torch.models.transformer:TransformerLM.init_params",
    "feddrift_torch.models.mlp:FeedForwardNN.init_params",
    "feddrift_torch.models.mlp:LogisticRegression.init_params",
    "feddrift_torch.core.step:TrainStep.__init__",
    "feddrift_torch.core.step:TrainStep.create",
    "feddrift_torch.simulation.runner:Experiment.__init__",
    "feddrift_torch.simulation.runner:Experiment.resume",
    "feddrift_torch.utils.checkpoint:load_checkpoint",
    "feddrift_torch.utils.device:resolve_device",
])
def test_entry_points_default_to_cuda(target):
    import importlib
    mod, attr = target.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_package_default_device():
    import feddrift_torch
    assert feddrift_torch.DEFAULT_DEVICE == "cuda"


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_card_or_repo(tmp_path, alone):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), {k: v for k, v in os.environ.items()
                                   if k != "PYTHONPATH"}
    else:
        cwd, env = REPO, _clean_env()
    # hide any card so the run here is the same with or without one
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
