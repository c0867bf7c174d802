"""The experiment runner: the whole time x round loop in one process.

Counterpart of ``feddrift_tpu/simulation/runner.py::Experiment`` in dense
mode (every client on the device axis, float32, no fault injection):

    for t in time steps:
        algo.begin_iteration(t)           # clustering / drift detection
        fresh per-(m, c) optimizer states
        fused (chunkable algorithms, chunk_rounds on):
            TrainStep.train_iteration_eval  # R rounds: K1 + K2 (FedAvg),
                                            # K3 evals every freq rounds + last
            algo.after_round, offer_acc_matrix, eval logging
        per-round (otherwise), for each round r:
            algo.round_inputs(t, r) -> TrainStep.train_round
            algo.after_round(t, r, ...)     # CFL splits, IFCA re-clusters
            evaluate(t, r) every freq rounds + last
        algo.end_iteration(t), checkpoint

The planes the reference's default run turns on are on here by default:
the divergence guard (``resilience/divergence.py``: every round's losses
on the per-round path, in one ``[2, M, C]`` fetch; the final round's on the
fused path, in the same single fetch as the eval buffers; a diverged round
is rolled back to its pre-round params with fresh optimizer state and no
eval, a diverged fused step to the pool it started from), SIGTERM/SIGINT
preemption at the iteration boundary (``resilience/preempt.py``), the
run-health alerts (``obs/alerts.py``, ``alerts.jsonl``) and incident
capture (``obs/blackbox.py``, ``obs/incident.py``: ``incidents/``, from
crit alerts, preemption and the exception guard in ``run``).

The trace plane is the reference's: a span recorder (``spans.jsonl``
beside ``events.jsonl``), the ``PhaseTracer`` (phases ``cluster``,
``train_round`` and ``eval``; ``iteration_end``'s ``phases``), the
host ledger and the optional sampling profiler (``hostprof_hz``:
``hostprof.jsonl`` and, at run end, ``hostprof.folded``), a live memory
watermark a step on the card, and the ``round_breakdown`` event a step:
its wall split into ``dispatch`` (the host's calls into the step),
``device_compute`` (the waits for the device: once a fused step, and
every ``profile_rounds``-th global round on the per-round path, every
round under ``trace_sync``; ``profiled_rounds`` counts the rounds they
cover), ``writeback``, ``eval``, ``drift_decision`` and the residual
``dispatch_gap``, with ``host_overhead_frac`` = 1 − device_compute / wall.
``debug_checks`` validates each step's round inputs and checks each device
program's outputs for NaN (``TrainStep.debug_nans``). None of this changes
a number the run computes.

Both paths sample ``client_num_per_round`` clients a round as the
reference does (``_client_masks``) and draw the step's batches from one
generator seeded by (seed, t), so a chunkable algorithm gives the same
numbers on either path. An ensemble algorithm (AUE, AUE-PC, KUE) runs on
the per-round path and is tested by its vote (``TrainStep.ensemble_eval``),
as the reference does. ``Experiment(cfg, out_dir=None, device="cuda")``
runs on the card unless the caller passes ``device="cpu"``. Not ported:
the megastep, population cohorts, streamed data, fault/byzantine
injection, codecs, hierarchy, secure aggregation and the SLO/ops plane.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from feddrift_torch import obs
from feddrift_torch.algorithms import algorithm_class, make_algorithm
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.core.pool import ModelPool
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models import create_model
from feddrift_torch.obs import alerts as obs_alerts
from feddrift_torch.obs import blackbox, costmodel, hostprof, incident
from feddrift_torch.resilience.divergence import DivergenceGuard
from feddrift_torch.resilience.preempt import PreemptionHandler
from feddrift_torch.utils.device import resolve_device
from feddrift_torch.utils.invariants import check_round_inputs
from feddrift_torch.utils.metrics import MetricsLogger
from feddrift_torch.utils.prng import iteration_seed
from feddrift_torch.utils.tracing import PhaseTracer

log = logging.getLogger("feddrift_torch")


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device tensors of 4-byte types (float32, int32) to host arrays in
    ONE device-to-host copy: their bits packed as int32, split on the
    host."""
    if not tensors[0].is_cuda:
        return [t.numpy() for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    host, out, off = flat.cpu().numpy(), [], 0
    for t in tensors:
        part = host[off:off + t.numel()].reshape(tuple(t.shape))
        out.append(part.view(np.float32) if t.dtype == torch.float32
                   else part)
        off += t.numel()
    return out


class Experiment:
    """The state and steps of one configured run."""

    def __init__(self, cfg: ExperimentConfig, out_dir: Optional[str] = None,
                 device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ds = make_dataset(cfg)
        self.module = create_model(cfg.model, self.ds, cfg)
        self.pool = ModelPool.create(
            self.module, torch.from_numpy(self.ds.x[0, 0, :2]),
            cfg.num_models, seed=cfg.seed + 42, device=self.device)
        # the algorithm's class trait picks the batch draw before it exists:
        # per-sample weighted (K4) for KUE, contiguous batches otherwise
        self.step = TrainStep.create(
            cfg, self.module, self.ds.num_classes, device=self.device,
            weighted_sampling=algorithm_class(
                cfg.concept_drift_algo).uses_sample_weights)
        self.x = torch.from_numpy(self.ds.x).to(self.device)
        self.y = torch.from_numpy(self.ds.y).to(self.device)
        self.algo = make_algorithm(cfg, self.ds, self.pool, self.step)
        self.logger = MetricsLogger(out_dir)
        obs_cap = int(cfg.obs_max_file_mb * (1 << 20))   # 0 = unbounded
        self.events = obs.configure(
            os.path.join(out_dir, "events.jsonl") if out_dir else None,
            max_bytes=obs_cap)
        # wall-clock spans (phases, iterations, the device waits) beside
        # the event stream; `report <run_dir> --trace` folds both into one
        # Perfetto-loadable trace.json
        self.spans = obs.spans.configure(
            os.path.join(out_dir, "spans.jsonl") if out_dir else None,
            max_bytes=obs_cap)
        # the per-subsystem host-seconds/bytes ledger, finalized at each
        # iteration's tail, and the optional sampling stack profiler
        # (hostprof_hz > 0), whose slices land in hostprof.jsonl and whose
        # folded stacks are written at run() exit; configure_profiler stops
        # a sampler left by an earlier Experiment in this process
        self._ledger = hostprof.ledger()
        self._ledger.reset()
        self.hostprof = hostprof.configure_profiler(
            cfg.hostprof_hz,
            path=os.path.join(out_dir, "hostprof.jsonl") if out_dir
            else None)
        # run-health rules on every emitted event: alert_raised events and
        # alerts.jsonl (open-append-close, so a crashed run keeps them)
        self.alerts = None
        if cfg.alerts:
            self.alerts = obs_alerts.AlertMonitor(
                rules=obs_alerts.default_rules(
                    churn_threshold=cfg.alert_churn_threshold,
                    churn_window=cfg.alert_window),
                path=os.path.join(out_dir, "alerts.jsonl") if out_dir
                else None, max_bytes=obs_cap).attach(self.events)
        # the flight recorder over the event stream, and bundles under
        # incidents/ on its triggers and on run()'s exception guard
        self.flight = self.incidents = None
        if cfg.incident_capture:
            self.flight = blackbox.configure(
                capacity=cfg.incident_ring).attach(self.events)
            self.incidents = incident.IncidentManager(
                run_dir=out_dir, recorder=self.flight,
                debounce_s=cfg.incident_debounce_s,
                max_bundles=cfg.incident_max_bundles,
                config_json=cfg.to_json(),
                ckpt_path=os.path.join(out_dir, "ckpt") if out_dir
                else None).attach(self.events)
        self.preempted = False
        self.divergence_guard = DivergenceGuard(
            spike_factor=cfg.divergence_spike_factor,
            max_rollbacks=cfg.divergence_max_rollbacks,
            warmup=cfg.divergence_warmup_rounds) \
            if cfg.divergence_guard else None
        self.algo.bind(self.x, self.y, self.logger)
        self.global_round = 0
        self.start_iteration = 0
        self.out_dir = out_dir
        self.tracer = PhaseTracer(registry=obs.registry(), spans=self.spans)
        self.last_phase_summary: dict = {}
        # per-iteration wall segments (dispatch, device_compute, eval,
        # drift_decision, writeback); the rest of the wall is the dispatch
        # gap. _profiled_rounds: the rounds the device_compute waits cover
        self._segs: dict[str, float] = {}
        self._profiled_rounds = 0
        self.last_round_breakdown: "dict | None" = None
        concepts = self.ds.concepts
        self.events.emit(
            "run_start", dataset=cfg.dataset, model=cfg.model,
            algo=cfg.concept_drift_algo, algo_arg=cfg.concept_drift_algo_arg,
            clients=self.C_, num_models=self.pool.num_models,
            comm_round=cfg.comm_round, train_iterations=cfg.train_iterations,
            backend=self.device.type, precision="f32", seed=cfg.seed,
            concept_matrix=concepts[:, : self.C_].tolist()
            if concepts[:, : self.C_].size <= 20000 else None)

    @property
    def C_(self) -> int:
        return self.cfg.device_clients

    # round_breakdown segments that are host control-plane work double-book
    # into the host ledger (dispatch, device_compute and eval do not)
    _LEDGER_SEGS = {"writeback": "registry_writeback",
                    "drift_decision": "drift_decision"}

    def _seg_add(self, name: str, dt: float) -> None:
        self._segs[name] = self._segs.get(name, 0.0) + dt
        sub = self._LEDGER_SEGS.get(name)
        if sub is not None:
            self._ledger.add_seconds(sub, dt)

    def _seg(self, name: str, **args):
        """Sub-span of the iteration (cat="round") that also accumulates
        into the iteration's round_breakdown segments."""
        return self.spans.span(
            name, cat="round",
            on_close=lambda _w, dt, _n=name: self._seg_add(_n, dt), **args)

    def _device_wait(self, t: int, g: int) -> None:
        """Wait for the device's queued work (nothing to wait for on the
        CPU) and record the wait as a ``device_compute`` span and
        segment."""
        blk_w, blk0 = time.time(), time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        blk_dt = time.perf_counter() - blk0
        self.spans.record("device_compute", blk_w, blk_dt, cat="round",
                          iteration=t, round=g)
        self._seg_add("device_compute", blk_dt)

    # ------------------------------------------------------------------
    def evaluate(self, t: int, round_idx: int) -> dict:
        """Reference ``test_on_all_clients``: each client's train accuracy
        on step t with its plurality model, and test accuracy on step t+1
        (temporal holdout), from one fresh K3 launch over both steps
        (``acc_window``); for an ensemble algorithm the test accuracy is
        its vote's (``ensemble_eval``) beside ``acc_matrix`` on step t.
        Both read the round's feature masks."""
        fm = self.algo.round_inputs(t, round_idx)[2]
        spec = self.algo.ensemble_spec(t)
        params, C = self.pool.params, self.C_
        if spec is None:
            correct, loss_sum, total = (v.cpu().numpy() for v in
                                        self.step.acc_window(
                                            params, self.x[:, t:t + 2],
                                            self.y[:, t:t + 2], fm))
            return self._log_eval(t, correct[:, :C, 0], loss_sum[:, :C, 0],
                                  correct[:, :C, 1], loss_sum[:, :C, 1],
                                  total[:C])
        correct, loss_sum, total = (v.cpu().numpy() for v in
                                    self.step.acc_matrix(
                                        params, self.x[:, t], self.y[:, t],
                                        fm))
        xe, ye = self.x[:, t + 1], self.y[:, t + 1]
        tidx = self.algo.train_model_idx(t)
        cr = np.arange(C)
        dev = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=self.device)
        ec, et, el = (v.cpu().numpy() for v in self.step.ensemble_eval(
            params, xe, ye, dev(spec.weights), spec.mode,
            dev(spec.model_mask), fm))
        return self._log_metrics(t, self.algo.test_model_idx(t),
                                 correct[tidx, cr], loss_sum[tidx, cr],
                                 total[:C], ec[:C], el[:C], et[:C])

    def _log_eval(self, t: int, correct, loss_sum, corr_te, loss_te,
                  total) -> dict:
        """Log one eval point from host-side [M, C] / [C] matrices."""
        tidx = self.algo.train_model_idx(t)
        idx = self.algo.test_model_idx(t)
        cr = np.arange(self.C_)
        return self._log_metrics(t, idx, correct[tidx, cr], loss_sum[tidx, cr],
                                 total, corr_te[idx, cr], loss_te[idx, cr],
                                 total)

    def _log_metrics(self, t: int, idx, train_correct, train_loss, total,
                     tcorrect, tloss, ttotal) -> dict:
        """The reference's metric schema from per-client vectors."""
        tot = max(float(np.asarray(total).sum()), 1.0)
        ttot = max(float(np.asarray(ttotal).sum()), 1.0)
        metrics = {
            "round": self.global_round,
            "iteration": t,
            "Train/Acc": float(train_correct.sum() / tot),
            "Train/Loss": float(train_loss.sum() / tot),
            "Test/Acc": float(tcorrect.sum() / ttot),
            "Test/Loss": float(tloss.sum() / ttot),
        }
        if self.cfg.report_client:
            for c in range(self.C_):
                metrics[f"Train/Acc-CL-{c}"] = float(train_correct[c] / total[c])
                metrics[f"Test/Acc-CL-{c}"] = float(tcorrect[c] / ttotal[c])
                metrics[f"Plurality/CL-{c}"] = int(idx[c])
        self.logger.log(metrics)
        self.events.emit("eval", round=self.global_round,
                         test_acc=metrics["Test/Acc"],
                         train_acc=metrics["Train/Acc"],
                         test_loss=metrics["Test/Loss"])
        return metrics

    # ------------------------------------------------------------------
    def run_iteration(self, t: int) -> None:
        cfg = self.cfg
        t0 = time.time()
        self._segs = {}
        self._profiled_rounds = 0
        self.events.set_context(iteration=t, round=self.global_round)
        self.events.emit("iteration_start")
        if self.divergence_guard is not None:
            # a new time step re-spikes the loss legitimately: a fresh
            # spike baseline
            self.divergence_guard.new_window()
        with self.tracer.phase("cluster"), \
                self._seg("drift_decision", iteration=t):
            self.algo.begin_iteration(t)
        if cfg.debug_checks:
            self._check_inputs(t)
        opt_states = self.step.init_opt_states(
            self.pool.params, self.pool.num_models, self.C_)
        if cfg.chunk_rounds and self.algo.chunkable(t) \
                and self.algo.ensemble_spec(t) is None:
            self._run_iteration_fused(t, opt_states)
        else:
            self._run_rounds(t, opt_states)
        with self.tracer.phase("cluster"), \
                self._seg("drift_decision", iteration=t):
            self.algo.end_iteration(t)
        if cfg.checkpoint_every_iteration and self.out_dir:
            with self._seg("writeback", iteration=t):
                self.save_checkpoint(t)
            self.events.emit("checkpoint_save", path=self.ckpt_path())
        wall = time.time() - t0
        log.info("iteration %d done in %.1fs (Test/Acc=%.4f)", t, wall,
                 self.logger.last("Test/Acc", -1))
        self.tracer.log_summary(prefix=f"iter {t}: ")
        self.last_phase_summary = self.tracer.summary()
        self.tracer.reset()   # per-iteration deltas, not cumulative totals
        B = min(cfg.batch_size, self.ds.samples_per_step)
        participants = min(cfg.client_num_per_round, self.C_)
        examples = cfg.comm_round * cfg.epochs * B * participants
        self.events.emit(
            "iteration_end", wall_s=round(wall, 4), rounds=cfg.comm_round,
            examples=examples,
            examples_per_s=round(examples / max(wall, 1e-9), 1),
            rounds_per_s=round(cfg.comm_round / max(wall, 1e-9), 3),
            test_acc=self.logger.last("Test/Acc"),
            phases={k: {"total_s": round(v["total_s"], 4),
                        "count": v["count"]}
                    for k, v in self.last_phase_summary.items()})
        self.spans.record("iteration", t0, wall, cat="runner", iteration=t)
        # the measured segments partition the wall; the residual is the
        # dispatch gap. host_overhead_frac = 1 - device_compute / wall is
        # the share of the wall the host did not spend waiting for the card
        gap = max(wall - sum(self._segs.values()), 0.0)
        dev = self._segs.get("device_compute", 0.0)
        host_frac = min(max(1.0 - dev / max(wall, 1e-9), 0.0), 1.0)
        segments = {k: round(v, 6) for k, v in sorted(self._segs.items())}
        segments["dispatch_gap"] = round(gap, 6)
        self.last_round_breakdown = {
            "iteration": t, "wall_s": round(wall, 6),
            "rounds": cfg.comm_round,
            "profiled_rounds": self._profiled_rounds,
            "segments": segments, "dispatch_gap_s": round(gap, 6),
            "host_overhead_frac": round(host_frac, 6)}
        self.events.emit("round_breakdown", **self.last_round_breakdown)
        reg = obs.registry()
        reg.gauge("host_overhead_frac").set(round(host_frac, 6))
        reg.histogram("round_wall_seconds").observe(
            wall / max(cfg.comm_round, 1))
        reg.quantile_sketch("round_wall_seconds_q").observe(
            wall / max(cfg.comm_round, 1))
        self._ledger.finalize(iteration=t, rounds=cfg.comm_round)
        if self.flight is not None:
            # the black box keeps recent metric state, not just events
            self.flight.snapshot_instruments()
        costmodel.record_hbm_watermark(self.device, iteration=t)

    def _check_inputs(self, t: int) -> None:
        """``debug_checks``: the reference's ``check_round_inputs`` on the
        step's round inputs (None sample weights and feature masks are
        ones)."""
        tw, sw, fm, _ = self.algo.round_inputs(t, 0)
        M, C, N = self.pool.num_models, self.C_, self.ds.samples_per_step
        host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)
        check_round_inputs(
            host(tw), np.ones((M, C, N), np.float32) if sw is None
            else host(sw),
            np.ones((M, *((1,) if self.ds.is_sequence
                          else self.ds.feature_shape)), np.float32)
            if fm is None else host(fm),
            num_models=M, num_clients=C, num_steps_p1=self.ds.num_steps + 1,
            sample_num=N)

    def _check_divergence(self, losses: np.ndarray, n: np.ndarray) -> bool:
        """Guard one round's host-side ``[M, C]`` losses and counts; True
        means diverged (the caller rolls back)."""
        if self.divergence_guard is None:
            return False
        g = self.divergence_guard
        diverged, reason, observed = g.check(losses, n)
        if not diverged:
            return False
        self.events.emit(
            "divergence_detected", reason=reason,
            observed_loss=(round(observed, 6) if np.isfinite(observed)
                           else None),
            baseline=(round(g.baseline, 6) if g.baseline is not None
                      else None),
            consecutive=g.consecutive_rollbacks + 1)
        obs.registry().counter("divergence_rollbacks").inc()
        log.warning("divergence (%s) at round %d: rolling back pool params",
                    reason, self.global_round)
        return True

    def _client_masks(self, rounds) -> "np.ndarray | None":
        """``[len(rounds), C]`` float32 0/1 participation masks, or None
        when every client takes part in every round: the reference's
        round-seeded sampling without replacement,
        ``RandomState(r).choice(C, k, replace=False)``, with r the round's
        index within its time step (so every step repeats the same
        participation sequence, as in the reference)."""
        k = self.cfg.client_num_per_round
        if k >= self.C_:
            return None
        masks = np.zeros((len(rounds), self.C_), dtype=np.float32)
        for i, r in enumerate(rounds):
            masks[i, np.random.RandomState(int(r)).choice(
                self.C_, k, replace=False)] = 1.0
        return masks

    def _device_masks(self, R: int) -> "torch.Tensor | None":
        masks = self._client_masks(range(R))
        return None if masks is None else torch.from_numpy(masks).to(
            self.device)

    def _run_rounds(self, t: int, opt_states) -> None:
        """The per-round host loop, for algorithms that steer every round
        (and for ``chunk_rounds`` off). The step's uniforms are drawn up
        front as on the fused path; round r turns its row into batch
        indices through round r's weights. With weighted sampling each
        round draws its own uniforms from the generator, in the order the
        fused path does."""
        cfg = self.cfg
        R, freq = cfg.comm_round, cfg.frequency_of_the_test
        step = self.step
        step.generator.manual_seed(iteration_seed(cfg.seed, t))
        if not step.weighted_sampling:
            u, slot = step.draw_uniforms(R, self.pool.num_models, self.C_,
                                         self.x.shape[2])
        masks = self._device_masks(R)
        keep_cp = self.algo.needs_client_params
        for r in range(R):
            self.events.set_context(round=self.global_round)
            tw, sw, fm, lr_scale = self.algo.round_inputs(t, r)
            prev_params = self.pool.params
            # every profile_rounds-th global round (every round under
            # trace_sync) waits for the device: the wait is the round's
            # device_compute segment
            profiled = (cfg.trace_sync
                        or self.global_round % cfg.profile_rounds == 0)
            with self.tracer.phase("train_round"):
                d0 = time.perf_counter()
                new_params, opt_states, client_params, n, losses = \
                    step.train_round(
                    prev_params, opt_states, self.x, self.y, tw, lr_scale,
                    None if masks is None else masks[r], sample_w=sw,
                    feat_mask=fm, draws=None if step.weighted_sampling
                    else (step.time_index(tw, u[r]), slot[r]))
                self._seg_add("dispatch", time.perf_counter() - d0)
                if profiled:
                    self._device_wait(t, self.global_round)
                    self._profiled_rounds += 1
                if self.divergence_guard is not None:
                    ln = torch.stack((losses, n)).cpu().numpy()  # one fetch
                    if self._check_divergence(ln[0], ln[1]):
                        # rollback: pre-round params, fresh optimizer state
                        # (the diverged step contaminated both), no
                        # after_round and no eval this round
                        self.pool.params = prev_params
                        opt_states = step.init_opt_states(
                            prev_params, self.pool.num_models, self.C_)
                        self.divergence_guard.record_rollback()
                        self.global_round += 1
                        continue
                w0 = time.perf_counter()
                self.pool.params = self.algo.after_round(
                    t, r, prev_params, new_params,
                    client_params if keep_cp else None, n)
                self._seg_add("writeback", time.perf_counter() - w0)
            if r % freq == 0 or r == R - 1:
                e0 = time.perf_counter()
                with self.tracer.phase("eval"):
                    self.evaluate(t, r)
                self._seg_add("eval", time.perf_counter() - e0)
            self.global_round += 1

    def _run_iteration_fused(self, t: int, opt_states) -> None:
        """ALL rounds of the time step and every scheduled eval in one
        ``TrainStep.train_iteration_eval`` call, then one bulk fetch of the
        eval buffers. The step's generator is seeded from (seed, t), so a
        resumed run draws what a continuous one draws."""
        cfg = self.cfg
        R, freq = cfg.comm_round, cfg.frequency_of_the_test
        tw, sw, fm, lr_scale = self.algo.round_inputs(t, 0)
        g0 = self.global_round
        self.step.generator.manual_seed(iteration_seed(cfg.seed, t))
        # the rollback target: train_iteration_eval packs the pool into new
        # buffers and never writes the tensors it was given
        start = self.pool.params
        with self.tracer.phase("train_round"):
            d0 = time.perf_counter()
            new_params, opt_states, n, losses, bufs, total, _stats = \
                self.step.train_iteration_eval(
                    start, opt_states, self.x, self.y, tw, lr_scale,
                    R, freq, t, self._device_masks(R), sample_w=sw,
                    feat_mask=fm)
            # the host's enqueue of the R rounds, then the wait for the
            # card to drain them: one wait covers all R rounds
            self._seg_add("dispatch", time.perf_counter() - d0)
            self._device_wait(t, g0)
            self._profiled_rounds += R
            e0 = time.perf_counter()
            corr_tr, loss_tr, corr_te, loss_te, total, n_h, losses_h = \
                _fetch(*bufs, total, n, losses)
            self._seg_add("eval", time.perf_counter() - e0)
            if self._check_divergence(losses_h, n_h):
                # a fused step rolls back whole: the pool it started from,
                # no after_round and no eval logging (the buffers hold
                # diverged numbers)
                self.pool.params = start
                self.divergence_guard.record_rollback()
                self.global_round = g0 + R
                return
            w0 = time.perf_counter()
            self.pool.params = self.algo.after_round(t, R - 1, None,
                                                     new_params, None, n)
            self._seg_add("writeback", time.perf_counter() - w0)
        e0 = time.perf_counter()
        C = self.C_
        with self.tracer.phase("eval"):
            for slot, r in enumerate(self.step.eval_rounds(R, freq)):
                self.global_round = g0 + r
                self._log_eval(t, corr_tr[slot][:, :C], loss_tr[slot][:, :C],
                               corr_te[slot][:, :C], loss_te[slot][:, :C],
                               total[:C])
        self._seg_add("eval", time.perf_counter() - e0)
        self.global_round = g0 + R
        # the final eval slot holds acc(final params) on steps t and t+1:
        # the next cluster phase reads them instead of recomputing (only
        # when they were taken without feature masks, as acc_matrix_at's)
        if fm is None:
            tot = np.maximum(total[None, :C], 1)
            self.algo.offer_acc_matrix(new_params,
                                       {t: corr_tr[-1][:, :C] / tot,
                                        t + 1: corr_te[-1][:, :C] / tot})

    # ------------------------------------------------------------------
    def run(self) -> MetricsLogger:
        # context managers, so a raising iteration cannot leak the JSONL
        # handles; the in-memory history and ring stay readable
        with self.logger, self.events:
            with PreemptionHandler(enabled=self.cfg.preempt_signals) as pre:
                try:
                    for t in range(self.start_iteration,
                                   self.cfg.train_iterations):
                        self.run_iteration(t)
                        if pre.requested:
                            # step t is complete: persist it and stop;
                            # --auto_resume continues after it
                            self._preempt_stop(t, pre.signal_name)
                            break
                except Exception as err:
                    # divergence aborts included: capture the black box
                    # while the sinks are open, then propagate unchanged
                    if self.incidents is not None:
                        self.incidents.on_exception(err)
                    raise
            self.events.emit("run_end", global_round=self.global_round,
                             test_acc=self.logger.last("Test/Acc"),
                             preempted=self.preempted)
        if self.hostprof is not None:
            self.hostprof.stop()
            if self.out_dir:
                self.hostprof.write_folded(
                    os.path.join(self.out_dir, "hostprof.folded"))
        return self.logger

    def _preempt_stop(self, completed_iteration: int, signal_name) -> None:
        """Checkpoint at the iteration boundary after a SIGTERM/SIGINT."""
        if self.out_dir and not self.cfg.checkpoint_every_iteration:
            # not already checkpointed by run_iteration: write one now
            self.save_checkpoint(completed_iteration)
        self.preempted = True
        self.events.emit(
            "preempt_checkpoint", iteration=completed_iteration,
            signal=signal_name,
            path=self.ckpt_path() if self.out_dir else None)
        log.warning("preempted by %s: checkpointed through iteration %d, "
                    "exiting cleanly (resume with --auto_resume)",
                    signal_name, completed_iteration)

    def ckpt_path(self) -> str:
        return os.path.join(self.out_dir or self.cfg.out_dir, "ckpt")

    def save_checkpoint(self, completed_iteration: int) -> None:
        from feddrift_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(
            self.ckpt_path(), config_json=self.cfg.to_json(),
            iteration=completed_iteration, global_round=self.global_round,
            pool_params=self.pool.params, algo_state=self.algo.state_dict())

    @classmethod
    def resume(cls, cfg: ExperimentConfig, out_dir: str,
               device: str | torch.device = "cuda") -> "Experiment":
        """Rebuild an Experiment and continue after the last completed
        iteration recorded in ``out_dir``'s checkpoint."""
        from feddrift_torch.utils.checkpoint import load_checkpoint
        exp = cls(cfg, out_dir=out_dir, device=device)
        state = load_checkpoint(os.path.join(out_dir, "ckpt"), exp.device)
        exp.pool.params = state["pool_params"]
        exp.algo.load_state_dict(state["algo_state"])
        exp.global_round = state["global_round"]
        exp.start_iteration = state["iteration"] + 1
        exp.logger.truncate_from(exp.start_iteration)
        return exp
