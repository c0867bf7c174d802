"""The LSTM cell (``kernels/lstm_cell.py``) on the CPU: its plain version
against one step of flax's ``OptimizedLSTMCell`` (the JAX package's cell),
its backward against autograd, and ``lstm_cell``, the op the LSTM layer
calls, inside ``models/base.py::pair_lstm`` (how ``model_local_sgd``
takes the pairs' gradients: one batched program, plain autograd) against
a loop of plain autograd a pair.

Tolerances: the plain cell against flax within 1e-6 of the largest output
(float32 exp and tanh, a few ulp apart; ~2e-7 measured), its backward
against autograd's gradient of the same float64 function within 1e-12;
through the op the pairs' losses and gradients equal a loop of plain
autograd within 1e-12 in float64 (the same operations, batched).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                              lstm_cell_bwd_ref,
                                              lstm_cell_fwd,
                                              lstm_cell_fwd_ref)
from feddrift_torch.models.base import LSTM_GATES, lstm_specs, pair_lstm

FLAX_RTOL, F64_TOL = 1e-6, 1e-12


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("R,H", [(5, 16), (7, 670)])
def test_plain_cell_matches_one_flax_step(R, H):
    """One ``OptimizedLSTMCell`` step from carry (c, h) on input x: the
    port's pre-activations ``(h·W_h + b) + x·W_i`` through the plain cell
    give flax's new carry."""
    import flax.linen as nn
    from flax.traverse_util import flatten_dict, unflatten_dict
    rng = np.random.default_rng(0)
    x, c, h = _rand(rng, R, 3), _rand(rng, R, H), _rand(rng, R, H)
    cell = nn.OptimizedLSTMCell(H)
    params = cell.init(jax.random.PRNGKey(1), (jnp.asarray(c),
                                               jnp.asarray(h)),
                       jnp.asarray(x))["params"]
    flat = flatten_dict(params, sep="/")
    flat = {k: v + 0.1 * _rand(rng, *v.shape) if k.endswith("bias") else v
            for k, v in flat.items()}          # nonzero biases
    (jc, jh), _ = cell.apply({"params": unflatten_dict(flat, sep="/")},
                             (jnp.asarray(c), jnp.asarray(h)),
                             jnp.asarray(x))
    t = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    wi = torch.cat([t[f"i{g}/kernel"] for g in "ifgo"], -1)
    wh = torch.cat([t[f"h{g}/kernel"] for g in "ifgo"], -1)
    b = torch.cat([t[f"h{g}/bias"] for g in "ifgo"], -1)
    z = (torch.from_numpy(h) @ wh + b) + torch.from_numpy(x) @ wi
    hn, cn, gates = lstm_cell_fwd_ref(z, torch.from_numpy(c))
    for got, want in ((hn, jh), (cn, jc)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() \
            <= FLAX_RTOL * np.abs(want).max()
    assert gates.shape == (R, 4 * H)


def test_plain_backward_is_autograds():
    rng = np.random.default_rng(2)
    R, H = 6, 9
    z = torch.from_numpy(_rand(rng, R, 4 * H, scale=2.0)).double()
    c = torch.from_numpy(_rand(rng, R, H)).double()
    dh = torch.from_numpy(_rand(rng, R, H)).double()
    dcn = torch.from_numpy(_rand(rng, R, H)).double()
    zr, cr = z.clone().requires_grad_(True), c.clone().requires_grad_(True)
    h, cn, _ = lstm_cell_fwd_ref(zr, cr)
    want = torch.autograd.grad((h * dh).sum() + (cn * dcn).sum(), (zr, cr))
    _, cn_, gates = lstm_cell_fwd_ref(z, c)
    got = lstm_cell_bwd_ref(dh, dcn, gates, c, cn_)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= F64_TOL


def test_cpu_takes_the_plain_versions_and_counts_no_launch():
    rng = np.random.default_rng(3)
    z = torch.from_numpy(_rand(rng, 4, 20))
    c = torch.from_numpy(_rand(rng, 4, 5))
    launches = lstm_cell_fwd.launches, lstm_cell_bwd.launches
    calls = lstm_cell_fwd_ref.cuda_calls, lstm_cell_bwd_ref.cuda_calls
    got = lstm_cell_fwd(z, c)
    want = lstm_cell_fwd_ref(z, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    back = lstm_cell_bwd(c, c, got[2], c, got[1])
    assert all(torch.equal(a, b) for a, b in
               zip(back, lstm_cell_bwd_ref(c, c, got[2], c, got[1])))
    assert (lstm_cell_fwd.launches, lstm_cell_bwd.launches) == launches
    assert (lstm_cell_fwd_ref.cuda_calls,
            lstm_cell_bwd_ref.cuda_calls) == calls


def _plain_layer(leaves, x, sequence):
    """One pair's LSTM layer on ``x [N, L, in]`` from a zero carry, step by
    step through the plain cell: every step's output, or the last."""
    wi, wh, b = (torch.cat([leaves[f"cell/{k}{g}/{leaf}"]
                            for g in LSTM_GATES], -1)
                 for k, leaf in (("i", "kernel"), ("h", "kernel"),
                                 ("h", "bias")))
    h = c = x.new_zeros(x.shape[0], wh.shape[0])
    outs = []
    for t in range(x.shape[1]):
        h, c, _ = lstm_cell_fwd_ref((h @ wh + b) + x[:, t] @ wi, c)
        outs.append(h)
    return torch.stack(outs, 1) if sequence else h


@pytest.mark.parametrize("pairs,rows,H,sequence",
                         [(3, 4, 5, True), (2, 1, 8, False)])
def test_pair_lstm_grad_equals_per_pair_plain_autograd(pairs, rows, H,
                                                       sequence):
    """Autograd of the pairs' summed losses through ``pair_lstm``, each pair
    with its own leaves and rows: the pairs fold into ``lstm_cell``'s rows,
    whose backward is the backward op, and each pair's loss and gradient
    are its own (a loop of plain autograd through the plain cell)."""
    rng = np.random.default_rng(4)
    leaves = {k: torch.from_numpy(_rand(rng, pairs, *shape, scale=0.5))
              .double().requires_grad_(True)
              for k, (shape, _) in lstm_specs("cell", 3, H).items()}
    x = torch.from_numpy(_rand(rng, pairs, rows, 2, 3)).double()
    out = pair_lstm(x, leaves, "cell", sequence=sequence)
    losses = (out * out).flatten(1).sum(1)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    for p in range(pairs):
        mine = {k: v[p].detach().clone().requires_grad_(True)
                for k, v in leaves.items()}
        want = _plain_layer(mine, x[p], sequence)
        loss = (want * want).sum()
        wants = torch.autograd.grad(loss, list(mine.values()))
        assert abs(float(losses[p].detach() - loss.detach())) <= F64_TOL
        for g, w in zip(grads, wants):
            assert (g[p] - w).abs().max() <= F64_TOL
