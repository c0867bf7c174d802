"""The federated round and the serving step over the ``[M, ...]`` model pool.

``TrainStep`` is the counterpart of ``feddrift_tpu/core/step.py::TrainStep``
on the main path (dense clients, the ``mean`` aggregator, no byzantine,
codec or hierarchy path):

    params      [M, ...]        model pool
    opt_state   [M, C, ...]     per-(model, client) AMSGrad state; persists
                                across the rounds of a time step, fresh at
                                each step boundary
    x, y        [C, T1, N, ...] the whole drift dataset, on the device
    time_w      [M, C, T1]      per-(model, client) time-step weights

A round is K1 (``kernels/local_sgd.py``: every pair's local steps in one
launch) followed by the masked sample-weighted FedAvg
(``resilience/robust_agg.py``). Inside a time step the parameters travel
packed as one ``[M, P]`` tensor, the kernel's layout; the caller sees the
usual dict of leaves. Where the reference draws each batch inside its
program from fold_in keys, the port draws a whole time step's randomness up
front on the device from the step's own ``generator`` (``draw_uniforms``):
``u ~ U[0, 1)`` and ``slot ~ U[0, nb)``, each ``[R, M, C, S]``. Round r's
``u`` becomes its time-step indices through the inverse CDF of round r's
weights (``time_index``, the reference's ``weight_cdf`` /
``inverse_cdf_draw``; uniform for a pair of total weight 0). The fused
loop converts all R rounds with the step's weights at once, the per-round
loop one round at a time with that round's weights, so a chunkable
algorithm trains on the same batches on both paths. The caller seeds the
generator per time step; the draws can also be passed in, which is how the
tests inject the reference's. A client mask ``[C]`` (the reference's
``client_mask``: client sampling) zeroes the unsampled clients' weights
before K1 sees their total, so K1 leaves those pairs as they were and
reports n = 0. The eval matrices (K3's function) are plain batched PyTorch
for now.

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

from feddrift_torch.kernels.local_sgd import init_opt_state, local_sgd
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_torch.resilience.robust_agg import agg_mean
from feddrift_torch.utils.device import resolve_device


@dataclass(eq=False)
class TrainStep:
    """Train and eval steps for one (module, dataset geometry)."""

    module: FeedForwardNN
    batch_size: int
    num_steps: int              # local SGD steps per round (reference `epochs`)
    num_classes: int
    lr: float = 0.01
    wd: float = 0.001
    optimizer: str = "adam"
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        if self.optimizer != "adam":
            raise NotImplementedError(
                f"client_optimizer {self.optimizer!r}: the port's local SGD "
                f"kernel steps AMSGrad only (ROADMAP item 4)")
        if not isinstance(self.module, FeedForwardNN):
            raise NotImplementedError(
                f"training {type(self.module).__name__}: the port's local "
                f"SGD kernel trains the fnn only (ROADMAP items 8-10)")
        self.device = resolve_device(self.device)
        self.generator = torch.Generator(device=self.device)

    @classmethod
    def create(cls, cfg, module, num_classes: int,
               device: str | torch.device = "cuda") -> "TrainStep":
        """The step an ``ExperimentConfig`` describes."""
        return cls(module=module, batch_size=cfg.batch_size,
                   num_steps=cfg.epochs, num_classes=num_classes, lr=cfg.lr,
                   wd=cfg.wd, optimizer=cfg.client_optimizer, device=device)

    # ------------------------------------------------------------------
    def init_opt_states(self, params, num_models: int,
                        num_clients: int) -> dict[str, torch.Tensor]:
        """[M, C, P] AMSGrad states, fresh at each time-step boundary."""
        del params      # optax's init is value-independent (zeros)
        return init_opt_state(num_models, num_clients,
                              self.module.num_params, self.device)

    def draw_uniforms(self, R: int, M: int, C: int, N: int):
        """One time step's raw batch draws ``(u, slot)``, each ``[R, M, C,
        S]``, from ``self.generator``: ``u ~ U[0, 1)`` float32 (turned into
        time-step indices by ``time_index``), ``slot ~ U[0, N // B)``
        int32."""
        shape = (R, M, C, self.num_steps)
        nb = N // min(self.batch_size, N)
        u = torch.rand(shape, generator=self.generator, device=self.device)
        slot = torch.randint(0, nb, shape, generator=self.generator,
                             device=self.device, dtype=torch.int32)
        return u, slot

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

    @staticmethod
    def total_weight(time_w: torch.Tensor,
                     client_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``[M, C]`` total weight of each pair, 0 for a client the mask
        leaves out (reference ``_round_body``: ``time_w * client_mask``
        before the sum)."""
        if client_mask is not None:
            time_w = time_w * client_mask[None, :, None]
        return time_w.sum(-1)

    # ------------------------------------------------------------------
    def _round_body(self, flat, opt_state, x, y, total_w, t_idx, slot,
                    lr_scale: float):
        """One round on packed params ``flat [M, P]``: K1, then the masked
        FedAvg. Returns ``(new_flat, opt_state, client [M, C, P], n, losses,
        agg_stats [M, 3])``."""
        client, opt_state, n, losses = local_sgd(
            x, y, flat, opt_state, t_idx, slot, total_w,
            hidden=self.module.hidden_dim,
            batch_size=min(self.batch_size, x.shape[2]), lr=self.lr,
            wd=self.wd, lr_scale=lr_scale)
        new_flat, agg_stats = agg_mean(client, n, flat)
        return new_flat, opt_state, client, n, losses, agg_stats

    @torch.no_grad()
    def train_round(self, params, opt_states, x, y, time_w,
                    lr_scale: float = 1.0, client_mask=None, *, draws=None,
                    with_agg_stats: bool = False):
        """One communication round. Returns ``(new_params [M, ...],
        new_opt_states, client_params [M, C, ...], n [M, C], mean_loss [M,
        C])``, plus the ``[M, 3]`` aggregation stats when
        ``with_agg_stats``. ``client_mask``: ``[C]`` 0/1, the clients
        sampled this round (None: all). ``draws``: this round's ``(t_idx,
        slot)``, each ``[M, C, S]``; otherwise drawn from
        ``self.generator``."""
        if draws is None:
            t_idx, slot = self.draw_batches(time_w, 1, x.shape[2])
            draws = (t_idx[0], slot[0])
        flat = self.module.pack(params)
        new_flat, opt, client, n, losses, stats = self._round_body(
            flat, opt_states, x, y, self.total_weight(time_w, client_mask),
            *draws, lr_scale)
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
                             client_masks=None, *, draws=None):
        """ALL R rounds of time step ``t`` with every scheduled eval.

        Eval slot ``r // freq`` holds the eval after round r for ``r %
        freq == 0``, and the final round takes slot E-1. The ``[E, M, C]``
        buffers stay on the device; the caller fetches them once.
        ``client_masks``: ``[R, C]`` 0/1, round r samples row r's clients
        (None: all). ``draws``: ``(t_idx, slot)`` each ``[R, M, C, S]``,
        else drawn up front from ``self.generator``.

        Returns ``(params, opt_states, n [M, C], losses [M, C], (corr_tr,
        loss_tr, corr_te, loss_te) each [E, M, C], total [C], agg_stats [R,
        M, 3])``; n and losses are the final round's.
        """
        evs = self.eval_rounds(R, freq)
        E = len(evs)
        M, C = time_w.shape[:2]
        if draws is None:
            draws = self.draw_batches(time_w, R, x.shape[2])
        t_idx, slot = draws
        xt, yt, xe, ye = x[:, t], y[:, t], x[:, t + 1], y[:, t + 1]
        total_w = self.total_weight(time_w)
        bufs = tuple(torch.zeros((E, M, C), dtype=d, device=x.device)
                     for d in (torch.int32, torch.float32) * 2)
        flat = self.module.pack(params)
        stats = []
        for r in range(R):
            if client_masks is not None:
                total_w = self.total_weight(time_w, client_masks[r])
            flat, opt_states, _, n, losses, st = self._round_body(
                flat, opt_states, x, y, total_w, t_idx[r], slot[r], lr_scale)
            stats.append(st)
            if r % freq == 0 or r == R - 1:
                e = E - 1 if r == R - 1 else r // freq
                p = self.module.unpack(flat)
                mats = (*self._acc_matrix_body(p, xt, yt)[:2],
                        *self._acc_matrix_body(p, xe, ye)[:2])
                for b, v in zip(bufs, mats):
                    b[e] = v
        total = torch.full((C,), x.shape[2], dtype=torch.int32,
                           device=x.device)
        return (self.module.unpack(flat), opt_states, n, losses, bufs, total,
                torch.stack(stats))

    # ------------------------------------------------------------------
    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Every model on every client: params leaves ``[M, ...]``, x ``[C,
        ..., N, *features]`` -> ``[M, C, ..., N, K]``."""
        extra = x.dim() - 1 - len(self.module.feature_shape)
        lead = (slice(None),) + (None,) * extra
        return self.module({k: v[lead] for k, v in params.items()}, x[None])

    def _acc_matrix_body(self, params, x, y):
        logits = self._logits(params, x)                       # [M, C, N, K]
        logp = torch.log_softmax(logits, dim=-1)
        yl = y.long()[None].expand(logits.shape[:-1])
        nll = -logp.gather(-1, yl[..., None])[..., 0].sum(-1)
        correct = (logits.argmax(-1) == yl).sum(-1).to(torch.int32)
        total = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device)
        return correct, nll, total

    @torch.no_grad()
    def acc_matrix(self, params, x, y):
        """Batched ``[M, C]`` eval of every model on every client's data.
        x: ``[C, N, ...]``; returns (correct [M, C] int32, loss_sum [M, C],
        total [C])."""
        return self._acc_matrix_body(params, x, y)

    @torch.no_grad()
    def acc_cells(self, params, x, y) -> torch.Tensor:
        """Correct-prediction counts per (model, client, time step): x
        ``[C, T1, N, ...]`` -> ``[M, C, T1]`` int32."""
        logits = self._logits(params, x)                    # [M, C, T1, N, K]
        return (logits.argmax(-1) == y.long()[None]).sum(-1).to(torch.int32)


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
