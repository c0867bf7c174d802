"""Experiment configuration: the fields the ported slices read.

A copy of the subset of ``feddrift_tpu/config.py::ExperimentConfig`` that
the port uses so far, with the same names and defaults, so one set of
keyword arguments builds the same experiment in both packages. Fields are
added here as later slices need them. The port runs the dense mode only:
population cohorts, host-streamed data and the multi-step megastep are
refused with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

# Default drift-detection deltas per dataset (reference tables at
# FedAvgEnsDataLoader.py:1274 (softcluster), :455 (mmacc) and :274
# (driftsurf)).
DEFAULT_DELTAS = {"sea": 0.04, "sine": 0.20, "circle": 0.10, "MNIST": 0.10}
DRIFTSURF_DELTAS = {"sea": 0.02, "sine": 0.10, "circle": 0.05}


@dataclass
class ExperimentConfig:
    # --- model & dataset
    model: str = "fnn"
    dataset: str = "sea"
    data_dir: str = "./data"
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    batch_size: int = 500
    fnn_hidden_dim: int = 10
    fmow_image_size: int = 32          # fmow partition image resolution
    chunk_rounds: bool = True          # all rounds of a step in one loop
    megastep_k: int = 1                # > 1 not ported
    trace_sync: bool = False           # wait for the device after every
                                       # per-round round (exact attribution;
                                       # off: every profile_rounds-th)

    # --- optimization (`epochs` = local SGD steps per round)
    client_optimizer: str = "adam"     # optax amsgrad after weight decay
    lr: float = 0.01
    wd: float = 0.001
    epochs: int = 5
    comm_round: int = 200
    frequency_of_the_test: int = 5

    # --- drift simulation
    train_iterations: int = 10         # number of simulated time steps T
    sample_num: int = 500              # samples per client per time step
    concept_drift_algo: str = "softcluster"
    concept_drift_algo_arg: str = "H_A_C_1_10_0"
    concept_num: int = 4               # model-pool size M (and #concepts)
    drift_together: int = 0
    change_points: str = "A"           # preset name, 'rand', or matrix literal
    time_stretch: int = 1
    noise_prob: float = 0.0
    ensemble_window: int = 3           # AUE window (sets num_models for aue)
    retrain_data: str = "win-1"        # for single-model continual baselines
    report_client: int = 1
    # stackoverflow_lr scale (reference: vocab 10000 / 500 tags; defaults are
    # scaled down so the dense [C, T, N, F] array stays small — data/tabular.py)
    so_vocab_size: int = 1000
    so_tag_size: int = 50
    text_seq_len: int = 80             # char-dataset sequence length
    smooth_sigma: float = 3.0          # basis smoothing (px) of the
                                       # "<image>-smooth" datasets

    # --- reproducibility, execution, output
    seed: int = 0
    stream_data: bool = False          # True not ported
    population_size: int = 0           # > 0 not ported
    out_dir: str = "./runs"
    checkpoint_every_iteration: bool = True

    # --- resilience (resilience/preempt.py, resilience/divergence.py)
    # SIGTERM/SIGINT -> checkpoint at the next iteration boundary + clean
    # exit. Main-thread only; harmless elsewhere.
    preempt_signals: bool = True
    # Numeric divergence guard: NaN/Inf or loss-spike detection on the
    # fetched round losses, rollback to pre-round params, abort after
    # divergence_max_rollbacks CONSECUTIVE rollbacks. The guard never
    # alters a healthy trajectory.
    divergence_guard: bool = True
    divergence_spike_factor: float = 10.0  # x window-peak loss that counts as a spike
    divergence_max_rollbacks: int = 3      # consecutive rollbacks before abort
    divergence_warmup_rounds: int = 5      # healthy rounds before spike arms

    # --- run-health alerts (obs/alerts.py): rules over the event stream
    # -> alert_raised events + <run_dir>/alerts.jsonl
    alerts: bool = True
    alert_window: int = 3           # churn window (iterations)
    alert_churn_threshold: int = 4  # structural cluster events per window
    # Size cap (MiB) on events.jsonl / spans.jsonl / alerts.jsonl before
    # rotation to <file>.1 with a loud obs_rotated event; 0 = unbounded.
    obs_max_file_mb: float = 0.0
    # Debug mode (utils/invariants.py): validate each iteration's round
    # inputs and check every device program's outputs of a round for NaN,
    # raising FloatingPointError naming the program (a sync a program).
    debug_checks: bool = False
    # Round critical path (obs/spans.py, simulation/runner.py): every Nth
    # global round of the per-round path additionally waits for the device
    # to split host dispatch from device compute (the round_breakdown
    # event's device_compute segment and host_overhead_frac); the fused
    # path waits once a step. 1 = every round.
    profile_rounds: int = 10
    # Host-plane sampling profiler (obs/hostprof.py): stack samples per
    # second over sys._current_frames(); 0 = off. When on, the run dir
    # gets hostprof.jsonl (merged into report --trace) and
    # hostprof.folded. The per-subsystem HostLedger runs regardless.
    hostprof_hz: float = 0.0

    # --- incident plane (obs/blackbox.py, obs/incident.py): flight
    # recorder over recent events + incident bundles under
    # <run_dir>/incidents/ on crit alerts, preemption, unhandled exceptions
    # (divergence aborts included) and SIGQUIT. Triage:
    # python -m feddrift_torch incident <run_dir>
    incident_capture: bool = True
    incident_ring: int = 512            # flight-recorder capacity (records)
    incident_debounce_s: float = 30.0   # min seconds between bundles
    incident_max_bundles: int = 8       # oldest bundles pruned past this

    def __post_init__(self) -> None:
        if self.client_num_per_round > self.client_num_in_total:
            raise ValueError("client_num_per_round > client_num_in_total")
        if self.time_stretch < 1:
            raise ValueError("time_stretch must be >= 1")
        if self.divergence_spike_factor <= 1.0:
            raise ValueError("divergence_spike_factor must be > 1")
        if self.divergence_max_rollbacks < 1:
            raise ValueError("divergence_max_rollbacks must be >= 1")
        if self.alert_window < 1:
            raise ValueError("alert_window must be >= 1")
        if self.alert_churn_threshold < 1:
            raise ValueError("alert_churn_threshold must be >= 1")
        if self.obs_max_file_mb < 0:
            raise ValueError("obs_max_file_mb must be >= 0")
        if self.hostprof_hz < 0:
            raise ValueError(
                "hostprof_hz must be >= 0 (0 disables the sampling profiler)")
        if self.profile_rounds < 1:
            raise ValueError("profile_rounds must be >= 1")
        if self.incident_ring < 8:
            raise ValueError("incident_ring must be >= 8 records")
        if self.incident_debounce_s < 0:
            raise ValueError("incident_debounce_s must be >= 0")
        if self.incident_max_bundles < 1:
            raise ValueError("incident_max_bundles must be >= 1")
        for name, off, item in (
                ("population_size", 0,
                 "In-round robustness, population and streaming"),
                ("stream_data", False,
                 "In-round robustness, population and streaming"),
                ("megastep_k", 1, "Megastep")):
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: the port runs the dense "
                    f"per-iteration path only (ROADMAP §1 '{item}')")

    @property
    def device_clients(self) -> int:
        """Size of the client axis the device sees: every client (dense
        mode, the only mode ported)."""
        return self.client_num_in_total

    @property
    def base_dataset(self) -> str:
        """Dataset name with task-family suffixes stripped (the key of the
        per-dataset delta tables)."""
        return self.dataset.removesuffix("-smooth")

    @property
    def num_models(self) -> int:
        """Size M of the static model pool (reference caps at concept_num)."""
        if self.concept_drift_algo in ("aue", "auepc"):
            return self.ensemble_window
        if self.concept_drift_algo == "driftsurf":
            return 2
        if self.concept_drift_algo in ("ada", "win-1", "all", "exp", "lin",
                                       "oblivious", "window"):
            return 1
        return self.concept_num

    def algo_params(self) -> dict[str, Any]:
        """Parse ``concept_drift_algo_arg`` as the reference does.

        FedDrift:   "H_{distance}_{cluster}_{W}_{100*delta}_{100*delta'}"
        CFL:        "cfl_{gamma}_{win-1|all}"
        mmacc:      "mmacc_{100*delta}"
        softmax:    "softmax_{alpha}"
        ada:        "{win-1|all}_{round|iter}"
        driftsurf:  "{100*delta}"
        """
        arg = self.concept_drift_algo_arg
        out: dict[str, Any] = {"raw": arg}
        if self.concept_drift_algo == "driftsurf":
            delta = 0.01 * float(arg) if arg and arg.replace(".", "").isdigit() \
                else 0.0
            if delta == 0:
                delta = DRIFTSURF_DELTAS.get(self.base_dataset, 0.1)
            out.update(kind="driftsurf", delta=delta)
            return out
        if self.concept_drift_algo == "ada":
            parts = arg.split("_")
            out.update(kind="ada",
                       ada_retrain=parts[0] if parts[0] in ("win-1", "all")
                       else "win-1",
                       ada_update=parts[1] if len(parts) > 1 else "round")
            return out
        if "mmacc" in arg:
            delta = 0.01 * float(arg.split("_")[-1])
            if delta == 0:
                delta = DEFAULT_DELTAS.get(self.base_dataset, 0.1)
            out.update(kind="mmacc", mmacc_delta=delta)
        elif "softmax" in arg:
            out.update(kind="softmax", softmax_alpha=int(arg.split("_")[-1]))
        elif arg == "geni":
            out.update(kind="geni")
        elif arg.startswith("H"):
            parts = arg.split("_")
            h_delta = 0.01 * float(parts[4])
            if h_delta == 0:
                h_delta = DEFAULT_DELTAS.get(self.base_dataset, 0.1)
            h_deltap = 0.01 * float(parts[5])
            if h_deltap == 0:
                h_deltap = h_delta
            out.update(kind="hierarchical", h_distance=parts[1],
                       h_cluster=parts[2], h_w=int(parts[3]),
                       h_delta=h_delta, h_deltap=h_deltap)
        elif "cfl" in arg:
            parts = arg.split("_")
            out.update(kind="cfl", cfl_gamma=float(parts[1]),
                       cfl_retrain=parts[2])
        elif arg in ("hard", "hard-r"):
            out.update(kind=arg)
        else:
            out.update(kind=arg or "none")
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        """The config ``to_json`` wrote (keys it does not know dropped, as
        the reference's ``from_json`` drops them)."""
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
