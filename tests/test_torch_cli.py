"""``python -m feddrift_torch run``: on the CPU when asked, never unasked.

Each case runs the CLI in a subprocess with no card visible
(``CUDA_VISIBLE_DEVICES=""``) at a tiny size (10 rounds, 3 steps).
"""

import json
import os
import subprocess
import sys
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, tmp_path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "feddrift_torch", "run",
                           *args], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_runs_on_the_cpu_and_resumes(tmp_path):
    args = ["--platform", "cpu", "--comm_round", "10",
            "--train_iterations", "3", "--out_dir", str(tmp_path / "runs")]
    out = _cli(args, tmp_path)
    assert out.returncode == 0, out.stderr
    run = tmp_path / "runs" / "sea-fnn-softcluster-H_A_C_1_10_0-s0"
    assert json.loads(out.stdout.strip().splitlines()[-1])["rounds"] == 30
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 3 * 3
    assert (run / "ckpt" / "MANIFEST.json").is_file()
    # a finished run resumes at its end: nothing more to train
    out = _cli(args + ["--auto_resume"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 3 * 3
    flat = _cli(["--platform", "cpu", "--comm_round", "2",
                 "--train_iterations", "2", "--flat_out_dir", "--out_dir",
                 str(tmp_path / "flat")], tmp_path)
    assert flat.returncode == 0, flat.stderr
    assert (tmp_path / "flat" / "metrics.jsonl").is_file()


def test_cli_without_a_card_exits_nonzero(tmp_path):
    out = _cli(["--comm_round", "2", "--train_iterations", "2",
                "--out_dir", str(tmp_path)], tmp_path)
    assert out.returncode != 0
    assert "--platform cpu" in out.stderr
    assert not (tmp_path / "sea-fnn-softcluster-H_A_C_1_10_0-s0").exists()


def test_cli_runs_the_per_round_path_with_sampling(tmp_path):
    out = _cli(["--platform", "cpu", "--comm_round", "6",
                "--train_iterations", "2", "--concept_drift_algo_arg",
                "cfl_0.1_win-1", "--client_num_per_round", "4",
                "--chunk_rounds", "false", "--retrain_data", "win-1",
                "--out_dir", str(tmp_path / "runs")], tmp_path)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["rounds"] == 12
    run = tmp_path / "runs" / "sea-fnn-softcluster-cfl_0.1_win-1-s0"
    assert (run / "ckpt" / "MANIFEST.json").is_file()
    cfg = json.loads((run / "ckpt" / "MANIFEST.json").read_text())["config"]
    assert (cfg["client_num_per_round"], cfg["chunk_rounds"]) == (4, False)
