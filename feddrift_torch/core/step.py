"""The federated round and the serving step over the ``[M, ...]`` model pool.

``TrainStep`` is the counterpart of ``feddrift_tpu/core/step.py::TrainStep``
on the main path (dense clients, the ``mean`` aggregator, no byzantine,
codec or hierarchy path):

    params      [M, ...]        model pool: the fnn, the lr, a conv model or
                                an LSTM
    opt_state   [M, C, ...]     per-(model, client) optimizer state (AMSGrad's;
                                SGD keeps none); persists across the rounds
                                of a time step, fresh at each step boundary
    x, y        [C, T1, N, ...] the whole drift dataset, on the device
    time_w      [M, C, T1]      per-(model, client) time-step weights
    sample_w    [M, C, N]       per-sample weights (KUE's Poisson bootstrap;
                                None: ones), read when weighted_sampling
    feat_mask   [M, *features]  multiplicative feature masks (KUE; None:
                                ones)
    lr_scale    float           the LR multiplier (Adaptive-FedAvg)

A round is K1 (``kernels/local_sgd.py``: every pair's local steps) and
K2, the masked sample-weighted FedAvg, in one launch: on the fused
kernel's route (the registry's fnn widths under AMSGrad) K2 is K1's
epilogue (``local_sgd_fedavg``); on the wide route (wide inputs such as
MNIST-4's, the fnn or the lr, AMSGrad or SGD) and the general route (any
other shape) K2 is its own launch (``resilience/robust_agg.py`` ->
``kernels/fedavg.py``).
Inside a time step the parameters travel packed as one ``[M, P]`` tensor,
the kernel's layout; the caller sees the usual dict of leaves. Where the
reference draws each batch inside its program from fold_in keys, the port
draws a whole time step's randomness up front on the device from the step's own ``generator`` (``draw_uniforms``;
drawn where the generator lives and moved to the step's device, so a CPU
generator gives a card step the CPU run's draws):
``u ~ U[0, 1)`` and ``slot ~ U[0, nb)``, each ``[R, M, C, S]``. Round r's
``u`` becomes its time-step indices through the inverse CDF of round r's
weights (``time_index``, the reference's ``weight_cdf`` /
``inverse_cdf_draw``; uniform for a pair of total weight 0). The fused
loop converts all R rounds with the step's weights at once, the per-round
loop one round at a time with that round's weights, so a chunkable
algorithm trains on the same batches on both paths. With
``weighted_sampling`` (the class trait ``uses_sample_weights``: KUE) a
batch is instead B rows drawn with replacement over the pair's ``T1·N``
rows with probability ``w_t[t]·s_n[n]``: each round draws ``u [M, C, S,
B]`` from the generator and K4 (``kernels/weighted_draw.py``) turns it into
rows, which K1 gathers: the cdf of the step's unmasked weights once
(``weighted_cdf``, held while the caller passes the same, unchanged
tensors), and one search a round (``weighted_search``) under the round's
masked total weights, where a pair of total 0 draws uniformly. Both paths
draw round by round in the same order, so they agree bitwise here too (a
step's draws up front would be R·M·C·S·B floats, 80 MB at KUE's canonical
shape). The caller seeds the generator
per time step; the draws can also be passed in, which is how the tests
inject the reference's. A client mask ``[C]`` (the reference's
``client_mask``: client sampling) zeroes the unsampled clients' weights
before K1 sees their total, so K1 leaves those pairs as they were and
reports n = 0. The eval matrices are K3, one pass over a window of time
steps, so an eval of the train step t and the test step t + 1 is one
pass. On the fused loop, where ``local_sgd._folds_eval`` allows it (the
registry's fnn widths at a batch of N rows), the eval after round r runs
in round r + 1's K1 launch on that launch's input params; the final
round's eval, the per-round path's evals and ``acc_matrix`` /
``acc_window`` / ``acc_cells`` are one ``kernels/eval_cells.py`` launch
each. The ensemble vote, the MSE matrix and the confusion matrices (K5's)
are plain batched PyTorch for now.

The model-generic path (``models/base.py::GenericNet``: the cnns, the
ResNets and the LSTMs) takes no K1 or K3 layout: its round is ``core/functional.py::model_local_sgd``
(every pair's S steps as one ``torch.func.vmap`` over the M·C pairs of
``grad``, the optimizer on the flat ``[M, C, P]`` params, cuDNN and cuBLAS
on the card; a float32 LSTM layer of a width ``kernels/lstm_layer.py``
takes is one launch of its layer kernel forward and one backward, any
other LSTM step's cell one ``kernels/lstm_cell.py`` launch each way)
followed by K2, ``fedavg.cu``, one launch a
round; its evals are ``core/functional.py::model_logits`` reduced to the
same count and NLL cells. Images keep their ``[.., H, W, C]`` rows, token
sequences their ``[.., L]`` ids. Both run inside
``models/base.py::model_numerics``, restored after each call: no TF32 in
cuDNN either, and deterministic cuDNN algorithms without autotuning, so
that a round gives the same bits call after call (fused against per
round, planes on against off, resume).

``ForwardStep`` is the counterpart of ``ForwardStep`` (:905-960): one call
answers a whole micro-batch whose rows may target different models; each
row's parameters are gathered out of the pool by its model index and the
batch runs as one forward over per-row weights.

float32 matmuls stay float32 on the card, as in the reference:
``torch.backends.cuda.matmul.allow_tf32`` is False by default and the
callers that time or check these steps (``chip_smoke.py``) set it so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from feddrift_torch.core.functional import (confusion_matrix, model_local_sgd,
                                            model_logits)
from feddrift_torch.kernels.eval_cells import eval_cells
from feddrift_torch.kernels.local_sgd import (OPTIMIZERS, _folds_eval,
                                              _route, init_opt_state,
                                              layout_refusal, local_sgd,
                                              local_sgd_fedavg)
from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                  weighted_search)
from feddrift_torch.models.base import GenericNet
from feddrift_torch.models.mlp import FeedForwardNN, LogisticRegression
from feddrift_torch.resilience.robust_agg import agg_mean
from feddrift_torch.utils.device import resolve_device
from feddrift_torch.utils.invariants import check_no_nan


@dataclass(eq=False)
class TrainStep:
    """Train and eval steps for one (module, dataset geometry)."""

    module: FeedForwardNN | LogisticRegression | GenericNet
    batch_size: int
    num_steps: int              # local SGD steps per round (reference `epochs`)
    num_classes: int
    lr: float = 0.01
    wd: float = 0.001
    optimizer: str = "adam"     # make_optimizer's "adam" (AMSGrad) or "sgd"
    device: str | torch.device = "cuda"
    # per-sample weighted batches (KUE's Poisson bootstrap) through K4
    weighted_sampling: bool = False
    # check every device program's outputs for NaN after it runs (the
    # config's debug_checks; utils/invariants.py::check_no_nan)
    debug_nans: bool = False

    def __post_init__(self) -> None:
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"client_optimizer {self.optimizer!r}: the reference's "
                f"make_optimizer steps {OPTIMIZERS}")
        if not isinstance(self.module, (FeedForwardNN, LogisticRegression,
                                        GenericNet)):
            raise NotImplementedError(
                f"training {type(self.module).__name__}: the port trains the "
                f"fnn, the lr, the conv models and the LSTMs only (ROADMAP "
                f"§1 'The model zoo and transformer training')")
        self.device = resolve_device(self.device)
        self.generator = torch.Generator(device=self.device)
        # the weighted draw's cdf and the tensors (and their versions) it
        # was computed from
        self._cdf = self._cdf_key = None

    @property
    def generic(self) -> bool:
        """A conv model or an LSTM: the model-generic local SGD and evals,
        not K1 / K3."""
        return isinstance(self.module, GenericNet)

    @classmethod
    def create(cls, cfg, module, num_classes: int,
               device: str | torch.device = "cuda",
               weighted_sampling: bool = False) -> "TrainStep":
        """The step an ``ExperimentConfig`` describes. On the card a
        shape that no K1 layout takes (``local_sgd.layout_refusal``) is
        refused here, before the run puts its data on the device; the CPU
        trains every shape on the plain version."""
        step = cls(module=module, batch_size=cfg.batch_size,
                   num_steps=cfg.epochs, num_classes=num_classes, lr=cfg.lr,
                   wd=cfg.wd, optimizer=cfg.client_optimizer, device=device,
                   weighted_sampling=weighted_sampling,
                   debug_nans=cfg.debug_checks)
        if step.device.type == "cuda" and not step.generic:
            why = layout_refusal(module.in_dim, module.hidden_dim,
                                 module.num_classes,
                                 min(cfg.batch_size, cfg.sample_num),
                                 cfg.client_optimizer)
            if why is not None:
                raise ValueError(why)
        return step

    def _check(self, program: str, **outputs) -> None:
        """``debug_nans``: raise ``FloatingPointError`` naming ``program``
        if one of its floating outputs holds a NaN (one host sync)."""
        if self.debug_nans:
            check_no_nan(program, **outputs)

    # ------------------------------------------------------------------
    def init_opt_states(self, params, num_models: int,
                        num_clients: int) -> dict[str, torch.Tensor]:
        """[M, C, P] AMSGrad states (SGD: none), fresh at each time-step
        boundary."""
        del params      # optax's init is value-independent (zeros)
        return init_opt_state(num_models, num_clients,
                              self.module.num_params, self.device,
                              self.optimizer)

    def draw_uniforms(self, R: int, M: int, C: int, N: int):
        """One time step's raw batch draws ``(u, slot)``, each ``[R, M, C,
        S]``, from ``self.generator``: ``u ~ U[0, 1)`` float32 (turned into
        time-step indices by ``time_index``), ``slot ~ U[0, N // B)``
        int32."""
        shape = (R, M, C, self.num_steps)
        nb = N // min(self.batch_size, N)
        gen = self.generator
        u = torch.rand(shape, generator=gen, device=gen.device)
        slot = torch.randint(0, nb, shape, generator=gen, device=gen.device,
                             dtype=torch.int32)
        return u.to(self.device), slot.to(self.device)

    @staticmethod
    def time_index(time_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Time-step indices ``t_idx`` int32 for uniforms ``u [M, C, S]`` or
        ``[R, M, C, S]``, by the inverse CDF of ``time_w [M, C, T1]``
        (reference ``weight_cdf`` / ``inverse_cdf_draw``, core/step.py:72-91:
        ``searchsorted(side="right")``, so a zero-weight step is never
        drawn, clipped). A pair of total weight 0 draws uniformly."""
        M, C, T1 = time_w.shape
        active = time_w.sum(-1, keepdim=True) > 0
        cdf = torch.cumsum(torch.where(active, time_w,
                                       torch.ones_like(time_w)), -1)
        cdf = cdf / cdf[..., -1:]
        vals = u if u.dim() == 3 else u.permute(1, 2, 0, 3).reshape(M, C, -1)
        t_idx = torch.searchsorted(cdf, vals.contiguous(), right=True,
                                   out_int32=True).clamp_(max=T1 - 1)
        if u.dim() == 3:
            return t_idx
        R, S = u.shape[0], u.shape[-1]
        return t_idx.view(M, C, R, S).permute(2, 0, 1, 3).contiguous()

    def draw_batches(self, time_w: torch.Tensor, R: int, N: int):
        """One time step's batch draws ``(t_idx, slot)``, each ``[R, M, C,
        S]`` int32, for R rounds of the weights ``time_w``."""
        M, C, _ = time_w.shape
        u, slot = self.draw_uniforms(R, M, C, N)
        return self.time_index(time_w, u), slot

    def draw_row_uniforms(self, M: int, C: int, N: int) -> torch.Tensor:
        """One round's uniforms ``u [M, C, S, B]`` for the weighted draw,
        from ``self.generator``."""
        shape = (M, C, self.num_steps, min(self.batch_size, N))
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(self.device)

    @staticmethod
    def total_weight(time_w: torch.Tensor,
                     client_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``[M, C]`` total weight of each pair, 0 for a client the mask
        leaves out (reference ``_round_body``: ``time_w * client_mask``
        before the sum)."""
        if client_mask is not None:
            time_w = time_w * client_mask[None, :, None]
        return time_w.sum(-1)

    def step_cdf(self, time_w: torch.Tensor, sample_w: torch.Tensor | None,
                 N: int) -> torch.Tensor:
        """The weighted draw's cdf ``[M, C, T1·N]`` of a time step's
        UNMASKED ``time_w`` and ``sample_w`` (None: ones), through K4a. It
        is computed again only for other tensors than the last call's, or
        after an in-place change of either (``Tensor._version``); the check
        reads no device value."""
        versions = (time_w._version,
                    None if sample_w is None else sample_w._version, N)
        held = self._cdf_key
        if held is not None and held[0] is time_w and held[1] is sample_w \
                and held[2] == versions:
            return self._cdf
        self._cdf_key = (time_w, sample_w, versions)
        if sample_w is None:
            sample_w = torch.ones((*time_w.shape[:2], N), device=time_w.device)
        self._cdf = weighted_cdf(time_w.contiguous(), sample_w.contiguous())
        self._check("K4a (weighted_cdf)", cdf=self._cdf)
        return self._cdf

    # ------------------------------------------------------------------
    def _round_body(self, flat, opt_state, x, y, total_w, rows,
                    lr_scale: float, cdf=None, feat_mask=None,
                    stats_out=None, eval_window=None, eval_out=None):
        """One round on packed params ``flat [M, P]``: K4b (weighted
        sampling only), then K1 and K2, the masked FedAvg: one launch on the
        fused kernel's route (K2 as K1's epilogue), two on the wide and
        general ones; for a ``GenericNet`` ``model_local_sgd``, then K2.
        ``total_w [M, C]``: the round's pair weights, 0 for a client its
        mask leaves out. ``rows``: ``(t_idx, slot)`` of contiguous batches,
        or the weighted draw's uniforms ``u [M, C, S, B]``, searched in the
        step's ``cdf`` (``step_cdf``). ``stats_out``: an ``[M, 3]`` row that
        receives the aggregation stats. ``eval_window`` / ``eval_out``: an
        eval of ``flat`` folded into the launch (``local_sgd_fedavg``; only
        where ``_folds_eval`` allows it). Returns ``(new_flat, opt_state,
        client [M, C, P], n, losses, agg_stats [M, 3])`` on every route."""
        t_idx = slot = idx = None
        if self.weighted_sampling:           # K4b: the rows the uniforms draw
            idx = weighted_search(cdf, total_w, rows)
        else:
            t_idx, slot = rows
        mod, B = self.module, min(self.batch_size, x.shape[2])
        if self.generic:
            client, opt_state, n, losses = model_local_sgd(
                mod, x, y, flat, opt_state, t_idx, slot, total_w,
                batch_size=B, lr=self.lr, wd=self.wd, lr_scale=lr_scale,
                idx=idx, feat_mask=feat_mask, optimizer=self.optimizer)
            self._check("local SGD (model_local_sgd)", client=client,
                        opt_state=opt_state, losses=losses)
            new_flat, agg_stats = agg_mean(client, n, flat,
                                           stats_out=stats_out)
            self._check("K2 (fedavg)", params=new_flat, agg_stats=agg_stats)
            return new_flat, opt_state, client, n, losses, agg_stats
        fm = None if feat_mask is None else \
            feat_mask.reshape(feat_mask.shape[0], -1).contiguous()
        x = x.flatten(3)                     # image rows [.., H, W, C] -> F
        kw = dict(hidden=mod.hidden_dim, batch_size=B, lr=self.lr, wd=self.wd,
                  lr_scale=lr_scale, idx=idx, feat_mask=fm)
        if _route(mod.in_dim, mod.hidden_dim, mod.num_classes, B,
                  self.optimizer) == "fused":
            client, opt_state, n, losses, new_flat, agg_stats = \
                local_sgd_fedavg(x, y, flat, opt_state, t_idx, slot, total_w,
                                 stats_out=stats_out, eval_window=eval_window,
                                 eval_out=eval_out, **kw)
            self._check("K1 (local_sgd_fedavg)", client=client,
                        opt_state=opt_state, losses=losses, params=new_flat,
                        agg_stats=agg_stats,
                        eval_nll=None if eval_out is None else eval_out[1])
        else:
            client, opt_state, n, losses = local_sgd(
                x, y, flat, opt_state, t_idx, slot, total_w,
                optimizer=self.optimizer, **kw)
            self._check("K1 (local_sgd)", client=client, opt_state=opt_state,
                        losses=losses)
            new_flat, agg_stats = agg_mean(client, n, flat,
                                           stats_out=stats_out)
            self._check("K2 (fedavg)", params=new_flat, agg_stats=agg_stats)
        return new_flat, opt_state, client, n, losses, agg_stats

    def _round_rows(self, time_w, N: int):
        """One round's draws from ``self.generator``: the weighted draw's
        uniforms, or ``(t_idx, slot)`` under ``time_w``."""
        M, C, _ = time_w.shape
        if self.weighted_sampling:
            return self.draw_row_uniforms(M, C, N)
        t_idx, slot = self.draw_batches(time_w, 1, N)
        return t_idx[0], slot[0]

    @torch.no_grad()
    def train_round(self, params, opt_states, x, y, time_w,
                    lr_scale: float = 1.0, client_mask=None, *, sample_w=None,
                    feat_mask=None, draws=None, with_agg_stats: bool = False):
        """One communication round. Returns ``(new_params [M, ...],
        new_opt_states, client_params [M, C, ...], n [M, C], mean_loss [M,
        C])``, plus the ``[M, 3]`` aggregation stats when
        ``with_agg_stats``. ``client_mask``: ``[C]`` 0/1, the clients
        sampled this round (None: all). ``sample_w [M, C, N]`` and
        ``feat_mask [M, *features]``: None for ones. ``draws``: this round's
        ``(t_idx, slot)``, each ``[M, C, S]`` (with weighted sampling: the
        uniforms ``u [M, C, S, B]``); otherwise drawn from
        ``self.generator``."""
        if draws is None:
            draws = self._round_rows(time_w, x.shape[2])
        cdf = self.step_cdf(time_w, sample_w, x.shape[2]) \
            if self.weighted_sampling else None
        flat = self.module.pack(params)
        new_flat, opt, client, n, losses, stats = self._round_body(
            flat, opt_states, x, y, self.total_weight(time_w, client_mask),
            draws, lr_scale, cdf, feat_mask)
        out = (self.module.unpack(new_flat), opt,
               self.module.unpack(client), n, losses)
        return out + (stats,) if with_agg_stats else out

    @staticmethod
    def eval_rounds(R: int, freq: int) -> list[int]:
        """The reference's eval cadence: every ``frequency_of_the_test``
        rounds plus the final round."""
        rounds = list(range(0, R, freq))
        if rounds[-1] != R - 1:
            rounds.append(R - 1)
        return rounds

    @torch.no_grad()
    def train_iteration_eval(self, params, opt_states, x, y, time_w,
                             lr_scale: float, R: int, freq: int, t: int,
                             client_masks=None, *, sample_w=None,
                             feat_mask=None, draws=None):
        """ALL R rounds of time step ``t`` with every scheduled eval.

        Eval slot ``r // freq`` holds the eval after round r for ``r %
        freq == 0``, and the final round takes slot E-1: K3 writes slot e
        of the ``[E, M, C, 2]`` count and NLL buffers (train step t, test
        step t + 1), and K2 (K1's epilogue on the fused route) writes row r
        of the ``[R, M, 3]`` stats. Where ``_folds_eval`` allows it, the
        eval after round r < R - 1 runs inside round r + 1's launch (whose
        input params are round r's output); the final round's eval, and
        every eval on other shapes, is one ``eval_cells`` launch. With
        weighted sampling the step's cdf is computed once, from the
        unmasked weights. The buffers stay on the device; the caller
        fetches them once.
        ``client_masks``: ``[R, C]`` 0/1, round r samples row r's clients
        (None: all). ``sample_w``, ``feat_mask``: as ``train_round``.
        ``draws``: ``(t_idx, slot)`` each ``[R, M, C, S]``, else drawn up
        front from ``self.generator``; with weighted sampling the uniforms
        ``[R, M, C, S, B]``, else drawn round by round.

        Returns ``(params, opt_states, n [M, C], losses [M, C], (corr_tr,
        loss_tr, corr_te, loss_te) each [E, M, C], total [C], agg_stats [R,
        M, 3])``; n and losses are the final round's.
        """
        evs = self.eval_rounds(R, freq)
        E = len(evs)
        M, C = time_w.shape[:2]
        if draws is None and not self.weighted_sampling:
            draws = self.draw_batches(time_w, R, x.shape[2])
        xw, yw = x[:, t:t + 2], y[:, t:t + 2]
        corr = torch.empty((E, M, C, 2), dtype=torch.int32, device=x.device)
        nll = torch.empty((E, M, C, 2), device=x.device)
        stats = torch.empty((R, M, 3), device=x.device)
        flat = self.module.pack(params)
        cdf = self.step_cdf(time_w, sample_w, x.shape[2]) \
            if self.weighted_sampling else None
        total_w = self.total_weight(time_w)
        mod, N = self.module, x.shape[2]
        fold = not self.generic and _folds_eval(
            mod.in_dim, mod.hidden_dim, mod.num_classes,
            min(self.batch_size, N), N, self.optimizer)
        window = (xw.flatten(3), yw) if fold else None
        pending = None            # the eval slot the next round's launch fills
        for r in range(R):
            if client_masks is not None:
                total_w = self.total_weight(time_w, client_masks[r])
            if draws is None:
                rows = self.draw_row_uniforms(M, C, N)
            elif self.weighted_sampling:
                rows = draws[r]
            else:
                rows = (draws[0][r], draws[1][r])
            flat, opt_states, _, n, losses, _ = self._round_body(
                flat, opt_states, x, y, total_w, rows, lr_scale, cdf,
                feat_mask, stats_out=stats[r],
                eval_window=None if pending is None else window,
                eval_out=None if pending is None
                else (corr[pending], nll[pending]))
            pending = None
            if r % freq == 0 or r == R - 1:
                e = E - 1 if r == R - 1 else r // freq
                if fold and r < R - 1:
                    pending = e
                else:
                    self._eval_window(flat, xw, yw, feat_mask,
                                      out=(corr[e], nll[e]))
        total = torch.full((C,), x.shape[2], dtype=torch.int32,
                           device=x.device)
        bufs = (corr[..., 0], nll[..., 0], corr[..., 1], nll[..., 1])
        return (self.module.unpack(flat), opt_states, n, losses, bufs, total,
                stats)

    # ------------------------------------------------------------------
    def _logits(self, params, x: torch.Tensor,
                feat_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Every model on every client: params leaves ``[M, ...]``, x ``[C,
        ..., N, *features]`` -> ``[M, C, ..., N, K]``; ``feat_mask [M,
        *features]`` multiplies model m's input (None: ones)."""
        if self.generic:
            return model_logits(self.module, self.module.pack(params), x,
                                feat_mask)
        fs = len(self.module.feature_shape)
        extra = x.dim() - 1 - fs
        lead = (slice(None),) + (None,) * extra
        xin = x[None]
        if feat_mask is not None:
            xin = xin * feat_mask.reshape(
                feat_mask.shape[0], *(1,) * (x.dim() - fs),
                *feat_mask.shape[1:])
        return self.module({k: v[lead] for k, v in params.items()}, xin)

    def _eval_window(self, flat, x, y, feat_mask=None, with_nll=True,
                     out=(None, None)):
        """K3 on packed params ``flat [M, P]`` over a window ``x [C, G, N,
        ...]``: ``(correct, nll)`` each ``[M, C, G]`` (nll None unless
        ``with_nll``), written into ``out`` where it holds tensors. A
        ``GenericNet``'s cells come from its logits (``model_logits``)."""
        if self.generic:
            return self._generic_eval_window(flat, x, y, feat_mask,
                                             with_nll, out)
        fm = None if feat_mask is None else \
            feat_mask.reshape(feat_mask.shape[0], -1).contiguous()
        correct, nll = eval_cells(flat, x.flatten(3), y,
                                  hidden=self.module.hidden_dim, feat_mask=fm,
                                  with_nll=with_nll, correct_out=out[0],
                                  nll_out=out[1])
        self._check("K3 (eval_cells)", nll=nll)
        return correct, nll

    def _generic_eval_window(self, flat, x, y, feat_mask, with_nll, out):
        """``_eval_window`` of a ``GenericNet``: each (model, client, step)'s
        count of rows whose argmax is the label and sum of their NLL, the
        JAX package's ``_acc_matrix_body`` cells."""
        logits = model_logits(self.module, flat, x, feat_mask)
        yl = y.long()[None].expand(logits.shape[:-1])
        correct = (logits.argmax(-1) == yl).sum(-1).to(torch.int32)
        nll = None
        if with_nll:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, yl[..., None])[..., 0].sum(-1)
        if out[0] is not None:
            correct = out[0].copy_(correct)
        if nll is not None and out[1] is not None:
            nll = out[1].copy_(nll)
        self._check("eval (model_logits)", nll=nll)
        return correct, nll

    @torch.no_grad()
    def acc_matrix(self, params, x, y, feat_mask=None):
        """Batched ``[M, C]`` eval of every model on every client's data
        (the reference's ``acc_matrix`` / ``_acc_matrix_body``). x: ``[C,
        N, ...]``; returns (correct [M, C] int32, loss_sum [M, C], total
        [C])."""
        correct, nll, total = self.acc_window(params, x[:, None], y[:, None],
                                              feat_mask)
        return correct[..., 0], nll[..., 0], total

    @torch.no_grad()
    def acc_window(self, params, x, y, feat_mask=None):
        """``acc_matrix`` of G consecutive time steps in one launch: x
        ``[C, G, N, ...]`` (e.g. ``x[:, t:t + 2]``, the train and test steps
        of an eval); returns (correct [M, C, G] int32, loss_sum [M, C, G],
        total [C])."""
        correct, nll = self._eval_window(self.module.pack(params), x, y,
                                         feat_mask)
        total = torch.full((x.shape[0],), y.shape[2], dtype=torch.int32,
                           device=x.device)
        return correct, nll, total

    @torch.no_grad()
    def acc_cells(self, params, x, y, feat_mask=None) -> torch.Tensor:
        """Correct-prediction counts per (model, client, time step): x
        ``[C, T1, N, ...]`` -> ``[M, C, T1]`` int32."""
        return self._eval_window(self.module.pack(params), x, y, feat_mask,
                                 with_nll=False)[0]

    @torch.no_grad()
    def ensemble_eval(self, params, x, y, ens_weights: torch.Tensor,
                      mode: str = "hard", model_mask=None, feat_mask=None):
        """Weighted-vote ensemble accuracy per client (reference
        ``ensemble_eval``). ``mode="hard"``: AUE, each model casts its
        weight on its argmax class; ``"soft"``: KUE, a weighted sum of
        softmaxes over the models of weight > 0. ``ens_weights [M]`` or
        ``[M, C]`` (AUE-PC's per-client weights), ``model_mask [M]`` (1 =
        votes; None: all). x: ``[C, N, ...]``; returns (correct [C] int32,
        total [C], loss_sum [C]), the loss the NLL of the normalised
        vote."""
        logits = self._logits(params, x, feat_mask)           # [M, C, N, K]
        M, C, N, K = logits.shape
        if model_mask is None:
            model_mask = torch.ones(M, device=x.device)
        if ens_weights.dim() == 1:
            ens_weights = ens_weights[:, None].expand(M, C)
        w = ens_weights * model_mask[:, None]                 # [M, C]
        if mode == "hard":
            votes = torch.nn.functional.one_hot(logits.argmax(-1), K).to(
                logits.dtype)
        else:
            votes = torch.softmax(logits, dim=-1)
            w = w.clamp_min(0.0) * (ens_weights > 0)          # kappa > 0
        combined = (votes * w[:, :, None, None]).sum(0)       # [C, N, K]
        yl = y.long()
        correct = (combined.argmax(-1) == yl).sum(1).to(torch.int32)
        probs = combined / combined.sum(-1, keepdim=True).clamp_min(1e-12)
        nll = -torch.log(probs.gather(-1, yl[..., None])[..., 0] + 1e-12)
        total = torch.full((C,), N, dtype=torch.int32, device=x.device)
        return correct, total, nll.sum(1)

    @torch.no_grad()
    def mse_matrix(self, params, x, y, feat_mask=None):
        """Per-(model, client) Brier sums ``sum_n (1 - p_y(x_n))^2`` (AUE's
        weights). x: ``[C, N, ...]`` -> (mse_sum [M, C], total [C])."""
        probs = torch.softmax(self._logits(params, x, feat_mask), dim=-1)
        yl = y.long()[None].expand(probs.shape[:-1])
        p_true = probs.gather(-1, yl[..., None])[..., 0]
        total = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device)
        return ((1.0 - p_true) ** 2).sum(-1), total

    @torch.no_grad()
    def confusion_matrices(self, params, x, y, feat_mask=None):
        """Per-(model, client) confusion matrices ``[M, C, K, K]`` float32,
        rows the true label (KUE's kappa)."""
        logits = self._logits(params, x, feat_mask)
        return confusion_matrix(logits, y[None].expand(logits.shape[:-1]),
                                self.num_classes)


@dataclass(eq=False)
class ForwardStep:
    apply_rows: Callable    # (per-row params [B, ...], x [B, ...]) -> logits

    @torch.no_grad()
    def forward(self, params: dict[str, torch.Tensor], x: torch.Tensor,
                model_idx: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, K]`` for ``x [B, ...]`` routed by ``model_idx [B]``
        into ``params [M, ...]``."""
        idx = model_idx.to(device=x.device, dtype=torch.long)
        rows = {k: p.index_select(0, idx) for k, p in params.items()}
        return self.apply_rows(rows, x)
