"""K3, the eval matrices (``kernels/eval_cells.py``), against the JAX
package's ``TrainStep.acc_matrix`` and ``acc_cells`` on the CPU, and its
CUDA kernels against the plain version on the card (``gpu``).

Both packages get the same seeded numpy data and parameters (flax's,
carried across with ``params_from_jax``). The windows are views of one
``[C, T1, N, F]`` dataset: ``x[:, t, None]`` (G = 1, acc_matrix),
``x[:, t:t + 2]`` (G = 2, an eval's train and test steps) and the whole
``x`` (G = T1, acc_cells).

Tolerance. Counts exactly; NLL sums at rtol 1e-5 on the CPU (float32 sums
of 40-60 NLLs in another order). On the card the kernel and the plain
version compute the logits in other orders (~1 ulp), so a row whose top
two logits lie within 1e-5 may be counted differently (such rows are
counted and allowed), and NLL sums agree to 1e-4 relative.

JAX is imported inside the CPU tests, so the ``gpu`` tests run on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_eval_cells.py``.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.eval_cells import (_route, _threads, eval_cells,
                                               eval_cells_ref)
from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
from feddrift_torch.models.mlp import FeedForwardNN
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T1, N = 3, 4, 5, 40
NLL_RTOL = 1e-5
CARD_NLL_RTOL = 1e-4
TIE_GAP = 1e-5


def _data(seed, F=3, K=2, n=N, c=C, t1=T1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (c, t1, n, F)).astype(np.float32)
    y = rng.integers(0, K, (c, t1, n)).astype(np.int32)
    return x, y


def _jax_pool(seed, F=3, H=10, K=2, m=M):
    """A pool of ``m`` flax fnns and the reference step over them."""
    import jax
    import jax.numpy as jnp
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer("adam", 0.01, 0.001), 20, 1, K)
    return jp, jstep


def _port(jp, F=3, H=10, K=2):
    import jax
    from feddrift_torch.convert import params_from_jax
    mod = FeedForwardNN((F,), num_classes=K, hidden_dim=H)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return mod, mod.pack(tree)


def _masks(seed, F=3, m=M):
    rng = np.random.default_rng(seed + 50)
    fm = (rng.random((m, F)) < 0.6).astype(np.float32)
    fm[np.arange(m), rng.integers(0, F, m)] = 1.0
    return fm


def _jax_matrix(jstep, jp, x, y, fm):
    import jax.numpy as jnp
    c, l, _ = jstep.acc_matrix(jp, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(fm))
    return np.asarray(c), np.asarray(l)


# (label, F, H, K, feature masks): the fused widths (SEA, sine) and the
# general route (H = 32, three classes), each with and without masks
WIDTHS = (("sea", 3, 10, 2, False), ("sine", 2, 10, 2, False),
          ("sea_masked", 3, 10, 2, True), ("h32", 3, 32, 2, False),
          ("h32_masked_k3", 3, 32, 3, True))


@pytest.mark.parametrize("label,F,H,K,masked", WIDTHS,
                         ids=[w[0] for w in WIDTHS])
@pytest.mark.parametrize("window", ["G1", "G2"])
def test_matrix_windows_match_reference(label, F, H, K, masked, window):
    """G = 1 (``x[:, t, None]``) and G = 2 (``x[:, t:t + 2]``) windows of
    strided views against one reference ``acc_matrix`` per step."""
    seed = len(label) + (window == "G2")
    x, y = _data(seed, F, K)
    jp, jstep = _jax_pool(seed, F, H, K)
    _, flat = _port(jp, F, H, K)
    fm = _masks(seed, F) if masked else np.ones((M, F), np.float32)
    t = 2
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    xw, yw = (X[:, t, None], Y[:, t, None]) if window == "G1" \
        else (X[:, t:t + 2], Y[:, t:t + 2])
    assert not xw.is_contiguous()
    correct, nll = eval_cells(flat, xw, yw, hidden=H, feat_mask=(
        torch.from_numpy(fm) if masked else None))
    G = xw.shape[1]
    assert correct.shape == nll.shape == (M, C, G)
    assert correct.dtype == torch.int32 and nll.dtype == torch.float32
    for g in range(G):
        wc, wl = _jax_matrix(jstep, jp, x[:, t + g], y[:, t + g], fm)
        assert np.array_equal(correct[..., g].numpy(), wc)
        np.testing.assert_allclose(nll[..., g].numpy(), wl, rtol=NLL_RTOL,
                                   atol=0)


@pytest.mark.parametrize("label,F,H,K,masked", WIDTHS[::2],
                         ids=[w[0] for w in WIDTHS[::2]])
def test_cells_over_every_step_match_reference(label, F, H, K, masked):
    """G = T1 without NLL: the reference's ``acc_cells``."""
    import jax.numpy as jnp
    x, y = _data(10 + len(label), F, K)
    jp, jstep = _jax_pool(10 + len(label), F, H, K)
    _, flat = _port(jp, F, H, K)
    fm = _masks(3, F) if masked else np.ones((M, F), np.float32)
    correct, nll = eval_cells(flat, torch.from_numpy(x), torch.from_numpy(y),
                              hidden=H, with_nll=False, feat_mask=(
                                  torch.from_numpy(fm) if masked else None))
    want = jstep.acc_cells(jp, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(fm))
    assert nll is None and correct.shape == (M, C, T1)
    assert np.array_equal(correct.numpy(), np.asarray(want))


def _tied(jp):
    """Dense_1's column 1 set to its column 0 (kernel and bias): classes 0
    and 1 tie on every row."""
    d1 = jp["Dense_1"]
    d1["kernel"] = d1["kernel"].copy()
    d1["bias"] = d1["bias"].copy() + np.float32(0.05)
    d1["kernel"][..., 1] = d1["kernel"][..., 0]
    d1["bias"][..., 1] = d1["bias"][..., 0]
    return jp


@pytest.mark.parametrize("H", [10, 32])
def test_tied_logits_count_class_zero(H):
    """Rows whose two largest logits are equal count class 0 as the
    argmax, as the reference's ``jnp.argmax`` does."""
    F, K = 3, 3
    x, y = _data(20 + H, F, K)
    jp, jstep = _jax_pool(20 + H, F, H, K)
    jp = _tied(jp)
    mod, flat = _port(jp, F, H, K)
    fm = np.ones((M, F), np.float32)
    correct, _ = eval_cells(flat, torch.from_numpy(x[:, 1, None]),
                            torch.from_numpy(y[:, 1, None]), hidden=H)
    wc, _ = _jax_matrix(jstep, jp, x[:, 1], y[:, 1], fm)
    assert np.array_equal(correct[..., 0].numpy(), wc)
    logits = mod({k: v[:, None] for k, v in mod.unpack(flat).items()},
                 torch.from_numpy(x[:, 1])[None])
    assert torch.equal(logits[..., 0], logits[..., 1])
    assert (logits.argmax(-1) == 0).any()
    ones = torch.ones_like(torch.from_numpy(y[:, 1, None]))
    assert (eval_cells(flat, torch.from_numpy(x[:, 1, None]), ones,
                       hidden=H)[0] == 0).all()


def test_step_eval_matrices_go_through_the_wrapper():
    """``acc_matrix``, ``acc_window`` and ``acc_cells`` of ``TrainStep``
    are the wrapper's numbers; on the CPU no launch is counted."""
    x, y = _data(30)
    jp, _ = _jax_pool(30)
    mod, flat = _port(jp)
    step = TrainStep(mod, 20, 1, 2, device="cpu")
    params = mod.unpack(flat)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    launches, plain = eval_cells.launches, eval_cells_ref.cuda_calls
    c1, l1, tot = step.acc_matrix(params, X[:, 3], Y[:, 3])
    cw, lw, totw = step.acc_window(params, X[:, 3:5], Y[:, 3:5])
    cells = step.acc_cells(params, X, Y)
    want_c, want_l = eval_cells_ref(flat, X, Y, hidden=10)
    assert torch.equal(c1, want_c[..., 3])
    assert torch.equal(cw, want_c[..., 3:5])
    assert torch.equal(cells, want_c)
    torch.testing.assert_close(l1, want_l[..., 3], rtol=NLL_RTOL, atol=0)
    torch.testing.assert_close(lw, want_l[..., 3:5], rtol=NLL_RTOL, atol=0)
    assert tot.tolist() == totw.tolist() == [N] * C
    assert eval_cells.launches == launches
    assert eval_cells_ref.cuda_calls == plain


def test_fused_iteration_buffers_are_the_windows_evals():
    """``train_iteration_eval``'s four ``[E, M, C]`` results are the
    train-step and test-step halves of its ``[E, M, C, 2]`` buffers: the
    final slot equals a fresh eval of the final params, and the ``[R, M,
    3]`` stats are the rounds' K2 stats."""
    x, y = _data(31)
    jp, _ = _jax_pool(31)
    mod, flat = _port(jp)
    step = TrainStep(mod, 20, 2, 2, lr=0.05, device="cpu")
    tw = np.ones((M, C, T1), np.float32)
    tw[..., -1] = 0.0
    tw[1] = 0.0                                  # a model with no client
    step.generator.manual_seed(4)
    R, freq, t = 5, 2, 1
    newp, _, n, _, bufs, total, stats = step.train_iteration_eval(
        mod.unpack(flat), step.init_opt_states(None, M, C),
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(tw), 1.0,
        R, freq, t)
    E = len(step.eval_rounds(R, freq))
    corr_tr, loss_tr, corr_te, loss_te = bufs
    assert all(b.shape == (E, M, C) for b in bufs)
    assert corr_tr._base is corr_te._base and loss_tr._base is loss_te._base
    c, l, _ = step.acc_window(newp, torch.from_numpy(x[:, t:t + 2]),
                              torch.from_numpy(y[:, t:t + 2]))
    assert torch.equal(corr_tr[-1], c[..., 0])
    assert torch.equal(corr_te[-1], c[..., 1])
    torch.testing.assert_close(loss_tr[-1], l[..., 0], rtol=NLL_RTOL, atol=0)
    torch.testing.assert_close(loss_te[-1], l[..., 1], rtol=NLL_RTOL, atol=0)
    assert stats.shape == (R, M, 3)
    assert stats[:, :, 0].tolist() == [[C, 0, C]] * R
    assert (stats[:, :, 1:] == 0).all() and total.tolist() == [N] * C


def test_route_and_block_size_are_pinned():
    assert _route(3, 10, 2) == _route(2, 10, 2) == "fused"
    assert _route(3, 32, 2) == _route(3, 10, 3) == "general"
    assert _route(784, 10, 10) == "wide"
    assert [_threads(n) for n in (1, 7, 32, 33, 500, 512, 513, 70000)] \
        == [32, 32, 32, 64, 512, 512, 512, 512]


def test_rejects_what_is_not_an_fnn():
    x, y = _data(32)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="not a 3->7->K fnn"):
        eval_cells(torch.zeros(M, 62), X, Y, hidden=7)
    with pytest.raises(ValueError, match=r"x \[C, G, N, F\]"):
        eval_cells(torch.zeros(M, 62), X[:, 0], Y, hidden=10)


# --------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(seed, F=3, H=10, K=2, m=4, c=10, t1=11, n=500):
    rng = np.random.default_rng(seed)
    P = F * H + H + H * K + K
    flat = (rng.standard_normal((m, P)) * 0.5).astype(np.float32)
    x, y = _data(seed, F, K, n, c, t1)
    return (torch.from_numpy(a).cuda() for a in (flat, x, y))


def _near_ties(flat, x, fm, H):
    """Rows per cell whose top two plain logits lie within TIE_GAP."""
    from feddrift_torch.kernels.local_sgd import _unpack
    F = x.shape[-1]
    K = (flat.shape[1] - F * H - H) // (H + 1)
    w0, b0, w1, b1 = (v[:, None, None] for v in _unpack(flat, F, H, K))
    xin = x[None] if fm is None else x[None] * fm[:, None, None, None, :]
    z = torch.relu(xin @ w0 + b0.unsqueeze(-2)) @ w1 + b1.unsqueeze(-2)
    top = z.topk(2, dim=-1).values
    return ((top[..., 0] - top[..., 1]) <= TIE_GAP).sum(-1)


def _hold(flat, xw, yw, H, fm=None, route=None, with_nll=True):
    launches, plain = eval_cells.launches, eval_cells_ref.cuda_calls
    got = eval_cells(flat, xw, yw, hidden=H, feat_mask=fm, route=route,
                     with_nll=with_nll)
    again = eval_cells(flat, xw, yw, hidden=H, feat_mask=fm, route=route,
                       with_nll=with_nll)
    torch.cuda.synchronize()
    assert eval_cells.launches == launches + 2
    assert eval_cells_ref.cuda_calls == plain
    assert torch.equal(got[0], again[0])
    want = eval_cells_ref(flat, xw, yw, hidden=H, feat_mask=fm,
                          with_nll=with_nll)
    ties = _near_ties(flat, xw, fm, H)
    assert ((got[0] - want[0]).abs() <= ties).all()
    if with_nll:
        assert torch.equal(got[1], again[1])
        assert ((got[1] - want[1]).abs()
                <= CARD_NLL_RTOL * want[1].abs()).all()
    else:
        assert got[1] is None


@pytest.mark.gpu
@pytest.mark.parametrize("F,H,route", [(3, 10, None), (2, 10, None),
                                       (3, 10, "general"), (3, 32, None)])
@pytest.mark.parametrize("window", ["G1", "G2", "T1"])
def test_kernel_matches_plain(cuda, F, H, route, window):
    """Both routes at the canonical shape (M 4, C 10, T1 11, N 500) on
    strided windows: counts equal but for near-tied rows, NLL to 1e-4
    relative, two calls bitwise, one launch a call and no plain call."""
    flat, x, y = _card_case(F + H, F, H)
    xw, yw = {"G1": (x[:, 4, None], y[:, 4, None]),
              "G2": (x[:, 4:6], y[:, 4:6]), "T1": (x, y)}[window]
    _hold(flat, xw, yw, H, route=route, with_nll=window != "T1")


@pytest.mark.gpu
@pytest.mark.parametrize("route", [None, "general"])
def test_kernel_with_feature_masks(cuda, route):
    flat, x, y = _card_case(5)
    fm = torch.from_numpy(_masks(5, 3, 4)).cuda()
    _hold(flat, x[:, 2:4], y[:, 2:4], 10, fm=fm, route=route)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 1000])
def test_kernel_with_fewer_or_more_rows_than_threads(cuda, n):
    flat, x, y = _card_case(6, n=n)
    _hold(flat, x[:, 1:3], y[:, 1:3], 10)
    _hold(flat, x[:, 1:3], y[:, 1:3], 10, route="general")


@pytest.mark.gpu
@pytest.mark.parametrize("H,route", [(10, None), (10, "general"),
                                     (32, None)])
def test_kernel_counts_class_zero_on_ties(cuda, H, route):
    F, K = 3, 3
    flat, x, y = _card_case(7, F, H, K)
    o = F * H + H
    w1 = flat[:, o:o + H * K].view(-1, H, K)
    w1[..., 1] = w1[..., 0]
    flat[:, o + H * K + 1] = flat[:, o + H * K]
    xw, yw = x[:, :2], y[:, :2]
    # no row counts class 1, which ties class 0 on every row
    ones = torch.ones_like(yw)
    assert (eval_cells(flat, xw, ones, hidden=H, route=route)[0] == 0).all()
    # class 0 against class 2: equal but where those two nearly tie
    zeros = torch.zeros_like(yw)
    got, _ = eval_cells(flat, xw, zeros, hidden=H, route=route)
    want, _ = eval_cells_ref(flat, xw, zeros, hidden=H)
    from feddrift_torch.kernels.local_sgd import _unpack
    w0, b0, w1_, b1 = (v[:, None, None] for v in _unpack(flat, F, H, K))
    z = torch.relu(xw[None] @ w0 + b0.unsqueeze(-2)) @ w1_ \
        + b1.unsqueeze(-2)
    near = ((z[..., 0] - z[..., 2]).abs() <= TIE_GAP).sum(-1)
    assert ((got - want).abs() <= near).all()


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    flat, x, y = _card_case(8)
    launches = eval_cells.launches
    with pytest.raises(ValueError, match="contiguous"):
        eval_cells(flat, x.transpose(2, 3).contiguous().transpose(2, 3), y,
                   hidden=10)
    with pytest.raises(ValueError, match="int32"):
        eval_cells(flat, x, y.long(), hidden=10)
    with pytest.raises(ValueError, match="route 'fused'"):
        eval_cells(torch.zeros(4, 3 * 32 + 32 + 32 * 2 + 2, device=cuda),
                   x, y, hidden=32, route="fused")
    big = torch.zeros(1, 1 * 1 + 1 + 1 * 30000 + 30000, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        eval_cells(big, x[:1, :1, :, :1].contiguous(), y[:1, :1], hidden=1)
    assert eval_cells.launches == launches


@pytest.mark.gpu
def test_fused_step_launches_k1_every_round_and_folds_all_but_the_last_eval(
        cuda):
    """A fused time step of R rounds: R K1 launches, each aggregating its
    round in its K2 epilogue (no separate K2 launch), every eval but the
    final round's folded into the next round's K1 launch (E - 1 folded
    evals), one K3 launch for the final round, and no plain K2 or K3 call
    on the card; its buffers equal a fresh eval of its final params."""
    mod = FeedForwardNN((3,), 2, 10)
    step = TrainStep(mod, 500, 5, 2, device=cuda)
    flat, x, y = _card_case(9)
    params = mod.unpack(flat)
    tw = torch.ones(4, 10, 11, device=cuda)
    tw[..., -1] = 0
    tw[3] = 0
    step.generator.manual_seed(1)
    counts = (local_sgd.launches, local_sgd_fedavg.launches,
              local_sgd_fedavg.evals, fedavg.launches, eval_cells.launches,
              fedavg_ref.cuda_calls, eval_cells_ref.cuda_calls)
    R, freq, t = 12, 5, 3
    newp, _, _, _, bufs, _, stats = step.train_iteration_eval(
        params, step.init_opt_states(params, 4, 10), x, y, tw, 1.0, R, freq,
        t)
    torch.cuda.synchronize()
    E = len(step.eval_rounds(R, freq))
    assert (local_sgd.launches, local_sgd_fedavg.launches,
            local_sgd_fedavg.evals, fedavg.launches, eval_cells.launches,
            fedavg_ref.cuda_calls, eval_cells_ref.cuda_calls) == (
        counts[0] + R, counts[1] + R, counts[2] + E - 1, counts[3],
        counts[4] + 1, counts[5], counts[6])
    c, l, _ = step.acc_window(newp, x[:, t:t + 2], y[:, t:t + 2])
    assert torch.equal(bufs[0][-1], c[..., 0])
    assert torch.equal(bufs[3][-1], l[..., 1])
    assert stats[:, 3, 0].eq(0).all() and stats[:, :3, 0].eq(10).all()
