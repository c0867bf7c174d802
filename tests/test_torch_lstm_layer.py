"""The LSTM layer op (``kernels/lstm_layer.py``) on the CPU: its plain
versions against flax's ``nn.RNN(nn.OptimizedLSTMCell)`` (the JAX
package's layer) and ``jax.grad``, the route between the layer kernels and
the per-step cell (``layer_refusal``), and ``models/base.py::pair_lstm``
through the layer op against its per-step loop.

Sizes: K 3 pairs, N 5 rows, L 7 steps, H 16 units, 4 inputs, from a numpy
seed; each pair its own flax params (nonzero biases), carried across by
``convert.py::params_from_jax``. Tolerances, on the largest difference:
float64 1e-10 (the same function, sums in other orders), float32 1e-5
(float32 sums through 7 recurrent steps). Through the op, ``pair_lstm``'s
forward is bitwise its per-step loop's (the same operations), its
gradients within 1e-5 in float32 and 1e-12 in float64 (dW_h one product
over the stacked steps, where the loop sums a product a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import feddrift_torch.models.base as base
from feddrift_torch.convert import params_from_jax
from feddrift_torch.kernels.lstm_cell import CellLauncher, cell_launcher
from feddrift_torch.kernels.lstm_layer import (LAYER_HIDDEN, _dims,
                                               layer_refusal, lstm_layer,
                                               lstm_layer_bwd,
                                               lstm_layer_bwd_ref,
                                               lstm_layer_fwd,
                                               lstm_layer_fwd_ref)
from feddrift_torch.models.base import LSTM_GATES, lstm_specs, pair_lstm
from torch_threads import one_intra_op_thread  # noqa: F401

K, N, L, H, F = 3, 5, 7, 16, 4
TOL = {np.float64: 1e-10, np.float32: 1e-5}
PAIR_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = [pytest.param(np.float64, id="f64"), pytest.param(np.float32,
                                                           id="f32")]
SEQUENCE = [pytest.param(True, id="sequence"), pytest.param(False,
                                                            id="last")]


@pytest.fixture
def x64(request):
    """JAX in float64 for a float64 case, restored after it."""
    on = request.node.callspec.params["dtype"] is np.float64
    held = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", on)
    yield
    jax.config.update("jax_enable_x64", held)


def _flax_pairs(dtype):
    """K flax layers' params (nonzero biases) in ``dtype``, the inputs ``x
    [K, N, L, F]`` and the output weights ``w``, from a numpy seed."""
    import flax.linen as nn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((K, N, L, F)).astype(dtype)
    w = rng.standard_normal((K, N, L, H)).astype(dtype)
    # param_dtype also types flax's zero carry
    layer = nn.RNN(nn.OptimizedLSTMCell(H, param_dtype=dtype))
    trees = []
    for k in range(K):
        p = layer.init(jax.random.PRNGKey(k), jnp.zeros((N, L, F)))
        flat = {key: np.asarray(v, dtype) for key, v in
                flatten_dict(p["params"], sep="/").items()}
        flat = {key: v + (0.3 * rng.standard_normal(v.shape)).astype(dtype)
                if key.endswith("bias") else v for key, v in flat.items()}
        trees.append(flat)
    return layer, trees, x, w


def _flax_out(layer, trees, x, sequence):
    """flax's outputs of the K pairs, one vmapped program over them."""
    from flax.traverse_util import unflatten_dict
    stacked = {key: jnp.stack([t[key] for t in trees]) for key in trees[0]}
    out = jax.vmap(lambda p, xk: layer.apply(
        {"params": unflatten_dict(p, sep="/")}, xk))(stacked, x)
    return out if sequence else out[:, :, -1]


def _port_leaves(trees):
    """The K pairs' leaves ``[K, ...]`` under the port's names, through
    ``params_from_jax``."""
    per = [params_from_jax(t, "cpu") for t in trees]
    return {key: torch.stack([p[key] for p in per]) for key in per[0]}


def _stacked(leaves):
    wi = torch.cat([leaves[f"cell/i{g}/kernel"] for g in LSTM_GATES], -1)
    wh = torch.cat([leaves[f"cell/h{g}/kernel"] for g in LSTM_GATES], -1)
    b = torch.cat([leaves[f"cell/h{g}/bias"] for g in LSTM_GATES], -1)
    return wi, wh, b


@pytest.mark.parametrize("sequence", SEQUENCE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_layer_matches_flax(x64, dtype, sequence):
    layer, trees, x, _ = _flax_pairs(dtype)
    want = np.asarray(_flax_out(layer, trees, x, sequence))
    assert want.dtype == dtype
    wi, wh, b = _stacked(_port_leaves(trees))
    xt = torch.from_numpy(x)
    zx = torch.bmm(xt.reshape(K, N * L, F), wi).view(K, N, L, 4 * H)
    h, c, gates = lstm_layer_fwd_ref(zx, wh, b, h_all=sequence)
    assert h.shape == want.shape and c.shape == (K, N, L, H) \
        and gates.shape == (K, N, L, 4 * H)
    assert float(np.abs(h.numpy() - want).max()) <= TOL[dtype]
    # the CPU wrapper is its plain version; without state it writes only h
    again, none_c, none_g = lstm_layer_fwd(zx, wh, b, state=False,
                                           h_all=sequence)
    assert torch.equal(again, h) and none_c is None and none_g is None


@pytest.mark.parametrize("sequence", SEQUENCE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_backward_matches_jax_grad(x64, dtype, sequence):
    """``lstm_layer``'s ``autograd.Function`` (the backward's plain version,
    then dW_h as one product and db as a sum) against ``jax.grad`` of the
    same weighted sum of outputs, for the inputs and every leaf."""
    layer, trees, x, w = _flax_pairs(dtype)
    wl = w if sequence else w[:, :, -1]

    def loss(params, xs):
        return jnp.sum(_flax_out(layer, params, xs, sequence) * wl)
    gp, gx = jax.grad(loss, argnums=(0, 1))(trees, x)
    leaves = {key: v.requires_grad_() for key, v in
              _port_leaves(trees).items()}
    xt = torch.from_numpy(x).requires_grad_()
    wi, wh, b = _stacked(leaves)
    zx = torch.bmm(xt.reshape(K, N * L, F), wi).view(K, N, L, 4 * H)
    out = lstm_layer(zx, wh, b, sequence)
    grads = torch.autograd.grad((out * torch.from_numpy(wl)).sum(),
                                [xt, *leaves.values()])
    assert float(np.abs(grads[0].numpy() - np.asarray(gx)).max()) \
        <= TOL[dtype]
    for key, g in zip(leaves, grads[1:]):
        ref = np.stack([np.asarray(gp[k][key]) for k in range(K)])
        assert g.dtype == leaves[key].dtype
        assert float(np.abs(g.numpy() - ref).max()) <= TOL[dtype], key


@pytest.mark.parametrize("sequence", SEQUENCE)
def test_plain_backward_is_autograd_of_the_plain_forward(sequence):
    """``lstm_layer_bwd_ref``'s dZ is autograd's gradient of every step's
    pre-activations through the plain forward (float64, 1e-12)."""
    rng = np.random.default_rng(3)
    zx = torch.from_numpy(2 * rng.standard_normal((K, N, L, 4 * H))) \
        .requires_grad_()
    wh = torch.from_numpy(0.3 * rng.standard_normal((K, H, 4 * H)))
    b = torch.from_numpy(rng.standard_normal((K, 4 * H)))
    h, c, gates = lstm_layer_fwd_ref(zx, wh, b, h_all=sequence)
    dH = torch.from_numpy(rng.standard_normal(h.shape))
    want, = torch.autograd.grad((h * dH).sum(), zx)
    got = lstm_layer_bwd(dH, gates.detach(), c.detach(), wh)
    assert got.shape == zx.shape
    assert float((got - want).abs().max()) <= 1e-12


def test_refusal_names_the_routes():
    """float32 at the instances' widths takes the layer kernels; float64,
    WordLSTM's H 670, widths no instance has and other types take the
    per-step route, with the reason."""
    for width in LAYER_HIDDEN:
        assert layer_refusal(torch.float32, width) is None
    for dtype, width, word in ((torch.float64, 256, "float64"),
                               (torch.float32, 670, "670"),
                               (torch.float32, H, "16"),
                               (torch.float32, 96, "96"),
                               (torch.float16, 256, "float16"),
                               (torch.bfloat16, 32, "bfloat16")):
        why = layer_refusal(dtype, width)
        assert why is not None and word in why


def test_wrappers_refuse_what_neither_kernel_takes():
    """The layer wrappers' shape checks refuse what no instance takes, and
    the cell's launcher refuses what the cell kernels do not take (the CPU
    takes neither launcher: its route is the plain versions)."""
    for shape, dtype in (((K, N, L, 4 * 670), torch.float32),
                         ((K, N, L, 4 * 256), torch.float64),
                         ((K, N, L, 4 * H + 2), torch.float32),
                         ((K, N, 4 * 256), torch.float32),
                         ((K, 0, L, 4 * 256), torch.float32)):
        with pytest.raises(ValueError):
            _dims("lstm_layer_fwd", torch.empty(shape, dtype=dtype))
    assert _dims("lstm_layer_fwd", torch.empty(K, N, L, 4 * 256)) \
        == (K, N, L, 256)
    assert cell_launcher(K * N, H, torch.zeros(1)) is None
    for R, width, dtype, device in ((K * N, H, torch.float32, "cpu"),
                                    (K * N, H, torch.float16, "cuda"),
                                    (0, H, torch.float32, "cuda"),
                                    (K * N, 0, torch.float64, "cuda")):
        with pytest.raises(ValueError):
            CellLauncher(R, width, dtype, device)


def _pair_leaves(dtype, width, seed=5):
    rng = np.random.default_rng(seed)
    params = {}
    for key, (shape, _) in lstm_specs("cell", F, width).items():
        scale = 0.3 if "/h" in key and key.endswith("kernel") else 1.0
        params[key] = torch.from_numpy(
            scale * rng.standard_normal((K, *shape))).to(dtype) \
            .requires_grad_()
    x = torch.from_numpy(rng.standard_normal((K, N, L, F))).to(dtype)
    return params, x.requires_grad_()


@pytest.mark.parametrize("sequence", SEQUENCE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_pair_lstm_layer_route_equals_the_per_step_loop(monkeypatch, dtype,
                                                        sequence):
    """``pair_lstm`` at H 32 through the layer op (float64 let through the
    route for the comparison) against its per-step loop (the route
    forced): the forward bitwise, the gradients of x and every leaf
    within ``PAIR_TOL``; no kernel launches or plain call on the card."""
    params, x = _pair_leaves(dtype, 32)
    out = {}
    for route, refusal in (("layer", lambda d, w: None),
                           ("step", lambda d, w: "forced")):
        monkeypatch.setattr(base, "layer_refusal", refusal)
        y = pair_lstm(x, params, "cell", sequence)
        w = torch.linspace(-1, 1, y.numel(), dtype=dtype).view(y.shape)
        out[route] = (y.detach(), torch.autograd.grad(
            (y * w).sum(), [x, *params.values()]))
    assert torch.equal(out["layer"][0], out["step"][0])
    for a, b in zip(out["layer"][1], out["step"][1]):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= PAIR_TOL[dtype] * scale
    assert lstm_layer_fwd_ref.cuda_calls == lstm_layer_bwd_ref.cuda_calls \
        == 0


def test_pair_lstm_takes_the_layer_op_where_the_route_allows(monkeypatch):
    """Unpatched, float32 at H 32 goes through ``lstm_layer`` and float64
    or H 16 through the per-step cell."""
    calls = []
    real = base.lstm_layer
    monkeypatch.setattr(base, "lstm_layer",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    for dtype, width in ((torch.float32, 32), (torch.float64, 32),
                         (torch.float32, H)):
        params, x = _pair_leaves(dtype, width)
        pair_lstm(x, params, "cell")
    assert calls == [torch.float32]
