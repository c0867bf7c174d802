"""Numerical primitives: loss, confusion matrices and selection over
parameter dicts, and the model-generic local SGD and forward of the conv
models and the LSTMs.

Counterparts of ``feddrift_tpu/core/functional.py::cross_entropy``,
``confusion_matrix`` and ``tree_select``. ``model_local_sgd`` computes what
``feddrift_tpu/core/step.py::TrainStep._local_sgd`` computes under
``_round_body``'s double vmap for any functional module (the conv models
and the LSTMs: K1 trains the fnn and the lr only), and ``model_logits``
what the eval programs' ``jax.vmap(one)(params, ...)`` over ``apply_fn``
compute. Both are PyTorch (cuDNN's convolutions and cuBLAS' products on the
card; an LSTM layer's recurrence is ``kernels/lstm_layer.py``'s kernels,
or its steps' cells ``kernels/lstm_cell.py``'s): the JAX
package runs these models' layers in XLA, outside any Pallas kernel. The
inputs are float features or, for the LSTMs, int32 token ids ``[..., L]``,
which a feature mask (``[M, 1]`` ones for a sequence, as the JAX package
keeps) turns into float ids that the embedding casts back.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from feddrift_torch.kernels.local_sgd import local_steps
from feddrift_torch.models.base import model_numerics

# The most rows of one ``pair_logits`` forward in ``model_logits``: its
# activations grow with the rows (CharLSTM: ~0.5 MB a row at seq 80), so an
# eval over every cell of a run runs in pieces of this many rows.
EVAL_ROWS = 8192


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every leading axis (the reference's
    ``nn.CrossEntropyLoss``)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """``[..., K, K]`` float32 counts over the sample axis (the last axis of
    ``labels``): rows the true label, columns the argmax prediction (KUE's
    kappa)."""
    K = num_classes
    flat = labels.long() * K + logits.argmax(-1)
    counts = torch.zeros((*flat.shape[:-1], K * K), dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts.unflatten(-1, (K, K))


def tree_select(cond: torch.Tensor | bool, a: dict, b: dict) -> dict:
    """Leaf-wise ``where(cond, a, b)`` over two dicts of tensors; ``cond``
    is a scalar (a Python bool or a 0-d tensor)."""
    return {k: torch.where(torch.as_tensor(cond, device=a[k].device), a[k],
                           b[k]) for k in a}


def model_local_sgd(module, x, y, params, opt_state, t_idx, slot, total_w, *,
                    batch_size: int, lr: float, wd: float,
                    lr_scale: float = 1.0, idx=None, feat_mask=None,
                    optimizer: str = "adam"):
    """Every (model, client) pair's S local steps of ``module`` at once:
    ``kernels/local_sgd.py::local_steps`` (its shapes, draws, optimizers and
    return) with a step's gradients ``torch.func.vmap`` over the M·C pairs
    of ``grad`` of the mean cross entropy of the pair's B rows, so a batch
    norm normalises by the pair's own batch; for a model with
    ``pair_logits`` (the LSTMs) plain autograd of the pairs' summed losses
    through that one batched program. ``x [C, T1, N, *features]``,
    ``params [M, P]`` in ``module.pack`` order, ``feat_mask [M,
    *features]`` (a sequence's ``[M, 1]``). Runs inside
    ``model_numerics``."""
    M, C, P = params.shape[0], x.shape[0], params.shape[1]

    def loss(flat, xb, yb):
        return cross_entropy(module(module.unpack(flat), xb), yb)
    step = vmap(grad_and_value(loss))

    def grad_fn(p, xb, yb):
        grad, ls = step(p.reshape(M * C, P), xb.flatten(0, 1),
                        yb.flatten(0, 1))
        return grad.view(M, C, P), ls.view(M, C)

    def pair_grad_fn(p, xb, yb):
        # the pairs' losses are independent: the gradient of their sum is
        # each pair's own gradient
        with torch.enable_grad():
            flat = p.reshape(M * C, P).detach().requires_grad_(True)
            logp = torch.log_softmax(module.pair_logits(
                module.unpack(flat), xb.flatten(0, 1)), -1)
            ls = -logp.gather(-1, yb.flatten(0, 1)[..., None])[..., 0] \
                .mean(-1)
            grad, = torch.autograd.grad(ls.sum(), flat)
        return grad.view(M, C, P), ls.detach().view(M, C)
    fn = grad_fn if module.pair_logits is None else pair_grad_fn
    with model_numerics():
        return local_steps(fn, x, y, params, opt_state, t_idx, slot,
                           total_w, batch_size=batch_size, lr=lr, wd=wd,
                           lr_scale=lr_scale, idx=idx, feat_mask=feat_mask,
                           optimizer=optimizer)


def model_logits(module, params: torch.Tensor, x: torch.Tensor,
                 feat_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Every model of ``params [M, P]`` on every group of rows of ``x [C,
    ..., N, *features]``: ``[M, C, ..., N, K]``. Each group of N rows is one
    forward (a batch norm takes the statistics of those N rows, as the JAX
    package's per-client ``apply_fn`` does); the groups of one model are a
    ``vmap`` of its forward, one model at a time (with ``pair_logits``, whose
    rows are independent, forwards of ``EVAL_ROWS`` rows). ``feat_mask [M,
    *features]`` (a sequence's ``[M, 1]``) multiplies model m's input
    (None: ones). Runs inside ``model_numerics``."""
    feat = tuple(module.feature_shape)
    N = x.shape[x.dim() - len(feat) - 1]
    lead = x.shape[:x.dim() - len(feat) - 1]
    xq = x.reshape(-1, N, *feat)
    out = []
    with model_numerics():
        for m in range(params.shape[0]):
            pm = module.unpack(params[m])
            xm = xq if feat_mask is None else xq * feat_mask[m]
            if module.pair_logits is not None:    # rows independent
                one = {k: v[None] for k, v in pm.items()}
                out.append(torch.cat([
                    module.pair_logits(one, rows) for rows in
                    xm.reshape(1, -1, *feat).split(EVAL_ROWS, 1)], 1)
                    .view(*xm.shape[:2], -1))
            else:
                out.append(vmap(lambda xb, pm=pm: module(pm, xb))(xm))
    logits = torch.stack(out)
    return logits.reshape(logits.shape[0], *lead, N, logits.shape[-1])
