"""K3 folded into K1's fused launch (``local_sgd_fedavg``'s ``eval_window``)
against the standalone eval and the JAX package, on the CPU, and the
folded launch against K1 + K2 followed by K3 on the card (``gpu``).

The fused round loop evaluates round r's params in round r + 1's launch,
whose input params they are; the final round's eval stays a standalone
``eval_cells`` launch. Both packages get the same seeded numpy data and
parameters (flax's, carried across with ``params_from_jax``); the
reference draws its batches from fold_in keys, which the parity test
reproduces and injects as ``tests/test_torch_train_step.py`` does.

Tolerances. The fold's plain version is ``eval_cells_ref`` on the input
params, so it equals that bitwise. Against the reference's
``_acc_matrix_body`` on the same params: counts exactly, NLL sums at rtol
1e-5 (float32 sums of 40 NLLs in another order). After R rounds trained in
both packages: counts within 1 and NLL sums within 1e-3, as the existing
fused-loop parity tests (float32 training in another order moves a row
near the boundary). On the card the folded cells are bitwise those of the
standalone kernel (the same device code, block size and order).

JAX is imported inside the CPU tests, so the ``gpu`` tests run on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_fused_eval.py``.
"""

import numpy as np
import pytest
import torch

import feddrift_torch.core.step as step_module
from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
from feddrift_torch.kernels.fedavg import fedavg
from feddrift_torch.kernels.local_sgd import (_folds_eval, init_opt_state,
                                              local_sgd, local_sgd_fedavg,
                                              local_sgd_fedavg_ref)
from feddrift_torch.models.mlp import FeedForwardNN
from torch_threads import one_intra_op_thread  # noqa: F401

# the fused widths at a small size: K1's block (64 threads at B = 20) is
# K3's (N = 40 rows), so the fold applies
M, C, T1, N, B, S, F, H, K = 3, 4, 5, 40, 20, 2, 3, 10, 2
LR, WD = 0.05, 0.001
NLL_RTOL = 1e-5
TRAINED_NLL_ATOL = 1e-3


def _data(seed, c=C, t1=T1, n=N, f=F):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (c, t1, n, f)).astype(np.float32)
    y = (x[..., 0] + 0.3 * rng.standard_normal((c, t1, n)) > 0.5) \
        .astype(np.int32)
    return x, y


def _masks(seed, m=M, f=F):
    rng = np.random.default_rng(seed + 50)
    fm = (rng.random((m, f)) < 0.6).astype(np.float32)
    fm[np.arange(m), rng.integers(0, f, m)] = 1.0
    return fm


def _time_w(seed, t1=T1):
    rng = np.random.default_rng(seed + 100)
    tw = (rng.random((M, C, t1)) < 0.6).astype(np.float32)
    tw[:, :, t1 - 1] = 0.0                 # the test step never trains
    tw[0, 0] = 0.0                         # an inactive pair
    tw[1, 1, 0] = 1.0
    return tw


def _jax_setup(seed, num_steps=S):
    import jax
    import jax.numpy as jnp
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer("adam", LR, WD), B, num_steps, K)
    return jp, jstep


def _port(jp):
    import jax
    from feddrift_torch.convert import params_from_jax
    mod = FeedForwardNN((F,), num_classes=K, hidden_dim=H)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return mod, tree


def _jax_tree(jp):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, jp)


def _jax_draws(key, time_w, nb=N // B):
    """The reference's batch indices of one round, [M, C, S] each (the
    key path of ``feddrift_tpu/core/step.py::_round_body``)."""
    import jax
    import jax.numpy as jnp
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def pair(k, w):
        logits = jnp.log(jnp.where(w.sum() > 0, w, jnp.ones_like(w)) + 1e-30)

        def one(kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.categorical(k1, logits),
                    jax.random.randint(k2, (), 0, nb))
        return jax.vmap(one)(jax.random.split(k, S))
    t_idx, slot = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    return (torch.from_numpy(np.array(t_idx, np.int32)),
            torch.from_numpy(np.array(slot, np.int32)))


def _round_inputs(seed, flat):
    rng = np.random.default_rng(seed + 7)
    tw = torch.from_numpy(_time_w(seed)).sum(-1)
    t_idx = torch.from_numpy(rng.integers(0, T1 - 1, (M, C, S)).astype(
        np.int32))
    slot = torch.from_numpy(rng.integers(0, N // B, (M, C, S)).astype(
        np.int32))
    return (init_opt_state(M, C, flat.shape[1], "cpu"), t_idx, slot, tw)


@pytest.mark.parametrize("masked", [False, True], ids=["ones", "masks"])
def test_plain_fold_is_the_eval_of_the_input_params(masked):
    """The fold's plain version writes ``eval_cells_ref`` of the round's
    INPUT params (bitwise), which is the reference's ``_acc_matrix_body``
    of those params on each step of the window, and leaves the round's
    own outputs as they are without it."""
    import jax.numpy as jnp
    seed = 3 + masked
    x, y = _data(seed)
    jp, jstep = _jax_setup(seed)
    mod, tree = _port(jp)
    flat = mod.pack(tree)
    fm = _masks(seed) if masked else np.ones((M, F), np.float32)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    kw = dict(hidden=H, batch_size=B, lr=LR, wd=WD,
              feat_mask=torch.from_numpy(fm) if masked else None)
    t = 2
    window = (X[:, t:t + 2], Y[:, t:t + 2])
    out = (torch.full((M, C, 2), -1, dtype=torch.int32),
           torch.full((M, C, 2), -1.0))
    opt, t_idx, slot, tw = _round_inputs(seed, flat)
    got = local_sgd_fedavg_ref(X, Y, flat, opt, t_idx, slot, tw,
                               eval_window=window, eval_out=out, **kw)
    want = local_sgd_fedavg_ref(X, Y, flat, opt, t_idx, slot, tw, **kw)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    wc, wl = eval_cells_ref(flat, *window, hidden=H,
                            feat_mask=kw["feat_mask"])
    assert torch.equal(out[0], wc) and torch.equal(out[1], wl)
    for g in range(2):
        jc, jl, _ = jstep._acc_matrix_body(
            _jax_tree(jp), jnp.asarray(x[:, t + g]), jnp.asarray(y[:, t + g]),
            jnp.asarray(fm))
        assert np.array_equal(out[0][..., g].numpy(), np.asarray(jc))
        np.testing.assert_allclose(out[1][..., g].numpy(), np.asarray(jl),
                                   rtol=NLL_RTOL, atol=0)
    # the wrapper takes the same path on CPU tensors
    again = (torch.zeros_like(out[0]), torch.zeros_like(out[1]))
    local_sgd_fedavg(X, Y, flat, opt, t_idx, slot, tw, eval_window=window,
                     eval_out=again, **kw)
    assert torch.equal(again[0], out[0]) and torch.equal(again[1], out[1])


@pytest.mark.parametrize("F_,H_,K_,B_,N_,want", [
    (3, 10, 2, 500, 500, True), (3, 10, 2, 64, 500, False),
    (3, 32, 2, 500, 500, False), (2, 10, 2, 500, 500, True),
    (18, 10, 2, 500, 500, True), (5, 10, 2, 500, 500, True),
    (18, 10, 2, 192, 192, False), (18, 10, 2, 193, 193, True),
    (5, 10, 2, 64, 64, False)])
def test_folds_eval_is_pinned(F_, H_, K_, B_, N_, want):
    """The fold needs both fused kernels and one block size: at B = 64
    K1's block has 64 threads and K3's 512, and H = 32 takes the general
    kernels. At susy's and ro's widths K1's fused kernel needs a thread for
    each of the P + 1 values (susy 213, ro 83): below that batch the round
    takes the general kernel and folds no eval."""
    assert _folds_eval(F_, H_, K_, B_, N_) is want


def test_fold_refuses_what_it_cannot_take():
    """A shape ``_folds_eval`` leaves to ``eval_cells``, a window of
    another shape or type, or outputs of another shape: ValueError, on
    any device, and no eval written."""
    flat = torch.zeros(M, F * H + H + H * K + K)
    opt, t_idx, slot, tw = _round_inputs(5, flat)
    kw = dict(hidden=H, lr=LR, wd=WD)
    out = (torch.full((M, C, 2), -1, dtype=torch.int32),
           torch.full((M, C, 2), -1.0))
    # 100 rows: K3's block has 128 threads, K1's 64 at B = 20
    X, Y = (torch.from_numpy(a) for a in _data(5, n=100))
    with pytest.raises(ValueError, match="_folds_eval"):
        local_sgd_fedavg(X, Y, flat, opt, t_idx, slot, tw, batch_size=B,
                         eval_window=(X[:, 1:3], Y[:, 1:3]), eval_out=out,
                         **kw)
    X, Y = (torch.from_numpy(a) for a in _data(5))
    window = (X[:, 1:3], Y[:, 1:3])
    with pytest.raises(ValueError, match="eval y"):
        local_sgd_fedavg(X, Y, flat, opt, t_idx, slot, tw, batch_size=B,
                         eval_window=(X[:, 1:3], Y[:, 1:3].long()),
                         eval_out=out, **kw)
    with pytest.raises(ValueError, match="eval x"):
        local_sgd_fedavg(X, Y, flat, opt, t_idx, slot, tw, batch_size=B,
                         eval_window=(X[:, 1:2], Y[:, 1:2]), eval_out=out,
                         **kw)
    with pytest.raises(ValueError, match="eval_out"):
        local_sgd_fedavg(X, Y, flat, opt, t_idx, slot, tw, batch_size=B,
                         eval_window=window, **kw)
    assert (out[0] == -1).all() and (out[1] == -1).all()


def _counted_evals(monkeypatch):
    """Wraps ``core.step``'s ``eval_cells`` and ``local_sgd_fedavg`` to count
    standalone evals and folded ones (the CPU counts no launch)."""
    seen = {"standalone": 0, "folded": 0}

    def standalone(*a, **k):
        seen["standalone"] += 1
        return eval_cells(*a, **k)

    def fused(*a, **k):
        seen["folded"] += k.get("eval_window") is not None
        return local_sgd_fedavg(*a, **k)
    monkeypatch.setattr(step_module, "eval_cells", standalone)
    monkeypatch.setattr(step_module, "local_sgd_fedavg", fused)
    return seen


@pytest.mark.parametrize("R", [1, 5, 6, 11, 12])
def test_fused_loop_buffers_are_each_eval_rounds_eval(R, monkeypatch):
    """``train_iteration_eval`` at freq 5 folds every eval but the final
    round's into the next round's launch; slot for slot its buffers are an
    eval of the params after each eval round, which R separate
    ``train_round`` calls on the same draws reproduce bitwise."""
    freq, t = 5, 2
    x, y = _data(10 + R)
    tw = torch.from_numpy(_time_w(10 + R))
    jp, _ = _jax_setup(10 + R)
    mod, tree = _port(jp)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, device="cpu")
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    step.generator.manual_seed(R)
    draws = step.draw_batches(tw, R, N)
    seen = _counted_evals(monkeypatch)
    newp, _, _, _, bufs, _, _ = step.train_iteration_eval(
        tree, step.init_opt_states(None, M, C), X, Y, tw, 1.0, R, freq, t,
        draws=draws)
    evs = step.eval_rounds(R, freq)
    assert seen == {"standalone": 1, "folded": len(evs) - 1}
    params, opt = tree, step.init_opt_states(None, M, C)
    want = []
    for r in range(R):
        params, opt, *_ = step.train_round(params, opt, X, Y, tw, 1.0,
                                           draws=(draws[0][r], draws[1][r]))
        if r in evs:
            want.append(step.acc_window(params, X[:, t:t + 2],
                                        Y[:, t:t + 2])[:2])
    assert all(torch.equal(newp[k], params[k]) for k in params)
    corr_tr, loss_tr, corr_te, loss_te = bufs
    for e, (c, l) in enumerate(want):
        assert torch.equal(corr_tr[e], c[..., 0])
        assert torch.equal(corr_te[e], c[..., 1])
        assert torch.equal(loss_tr[e], l[..., 0])
        assert torch.equal(loss_te[e], l[..., 1])


@pytest.mark.parametrize("R", [1, 5, 6, 11, 12])
def test_fused_loop_buffers_match_reference(R):
    """The same loop against the reference's ``train_iteration_eval``
    (``_iteration_body``) on the reference's own draws."""
    import jax
    import jax.numpy as jnp
    freq, t = 5, 1
    x, y = _data(20 + R)
    tw = _time_w(20 + R)
    jp, jstep = _jax_setup(20 + R)
    it_key = jax.random.PRNGKey(40 + R)
    jout = jstep.train_iteration_eval(
        _jax_tree(jp), jstep.init_opt_states(jp, M, C), it_key,
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
        jnp.ones((M, F)), jnp.float32(1.0), R, freq, jnp.int32(t))
    draws = [_jax_draws(jax.random.fold_in(it_key, r), tw) for r in range(R)]
    draws = tuple(torch.stack([d[i] for d in draws]) for i in (0, 1))
    mod, tree = _port(jp)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, device="cpu")
    _, _, _, _, bufs, _, _ = step.train_iteration_eval(
        tree, step.init_opt_states(None, M, C), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(tw), 1.0, R, freq, t,
        draws=draws)
    E = len(step.eval_rounds(R, freq))
    for got, want in zip(bufs, jout[4]):
        want = np.asarray(want)
        assert got.shape == want.shape == (E, M, C)
        if got.dtype == torch.int32:
            assert np.abs(got.numpy() - want).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=TRAINED_NLL_ATOL, rtol=0)


# --------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_round(seed, f, b, masked, m=4, c=10, t1=11, n=500, s=5):
    """One round at the canonical shape (SEA: f = 3; sine: f = 2): pairs
    (0, 3) and all of model m - 1 inactive."""
    rng = np.random.default_rng(seed)
    P = f * H + H + H * K + K
    x = rng.uniform(0, 10, (c, t1, n, f)).astype(np.float32)
    y = (x[..., -1] + x[..., 0] > 10).astype(np.int32)
    flat = (rng.standard_normal((m, P)) * 0.3).astype(np.float32)
    tw = (rng.random((m, c, t1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    tw[:, :, 0] = 1
    tw[0, 3] = tw[m - 1] = 0
    t_idx = rng.integers(0, t1 - 1, (m, c, s)).astype(np.int32)
    slot = rng.integers(0, n // b, (m, c, s)).astype(np.int32)
    fm = _masks(seed, m, f) if masked else None
    cu = lambda a: None if a is None else torch.from_numpy(a).cuda()
    return (cu(x), cu(y), cu(flat), init_opt_state(m, c, P, "cuda"),
            cu(t_idx), cu(slot), cu(tw.sum(-1))), dict(
        hidden=H, batch_size=b, lr=0.01, wd=0.001, feat_mask=cu(fm))


# (f, feature masks, N, B): SEA, sine and SEA with masks stage the window
# by TMA bulk copies; at N = 498 its rows are not 16-byte aligned
# (4-byte cp.async); at N = 6000 they do not fit in shared memory beside
# the batch ring and are read from device memory; susy (f = 18, with and
# without masks) and ro (f = 5) fold a row's values in chunks, susy's ring
# giving up stages so that the window fits, and at N = 3000 reading it
# where it lies
FOLD_CASES = ((3, False, 500, 500), (2, False, 500, 500), (3, True, 500, 500),
              (3, False, 498, 498), (3, True, 6000, 500),
              (18, False, 500, 500), (18, True, 500, 500),
              (5, False, 500, 500), (18, False, 3000, 500))


@pytest.mark.gpu
@pytest.mark.parametrize("f,masked,n,b", FOLD_CASES,
                         ids=["sea", "sine", "sea_masks", "unaligned",
                              "unstaged", "susy", "susy_masks", "ro",
                              "susy_unstaged"])
def test_folded_launch_is_k1_k2_then_k3(cuda, f, masked, n, b):
    """One launch with the eval folded in equals the K1 + K2 launch
    followed by a standalone K3 launch on its input params, bitwise in
    every output, over calls back to back."""
    (x, y, flat, opt, t_idx, slot, tw), kw = _card_round(f, f, b, masked,
                                                          n=n)
    window = (x[:, 4:6], y[:, 4:6])
    state = {k: v.clone() for k, v in opt.items()}
    want = local_sgd_fedavg(x, y, flat, state, t_idx, slot, tw, **kw)
    wc, wl = eval_cells(flat, *window, hidden=H, feat_mask=kw["feat_mask"])
    evals, launches = local_sgd_fedavg.evals, local_sgd_fedavg.launches
    k3 = eval_cells.launches
    for _ in range(20):
        st = {k: v.clone() for k, v in opt.items()}
        out = (torch.full((4, 10, 2), -1, dtype=torch.int32, device=cuda),
               torch.full((4, 10, 2), -1.0, device=cuda))
        got = local_sgd_fedavg(x, y, flat, st, t_idx, slot, tw,
                               eval_window=window, eval_out=out, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[0], wc) and torch.equal(out[1], wl)
        for a, b in zip(got, want):
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in a)
            else:
                assert torch.equal(a, b)
    assert local_sgd_fedavg.evals == evals + 20
    assert local_sgd_fedavg.launches == launches + 20
    assert eval_cells.launches == k3


@pytest.mark.gpu
def test_unfolded_shape_launches_k3_itself(cuda):
    """At B = 64 (K1's block 64 threads, K3's 512) the fold is refused and
    the fused loop launches K3 for every eval; its buffers are a
    standalone eval of each eval round's params."""
    (x, y, flat, opt, t_idx, slot, tw), kw = _card_round(11, 3, 64, False)
    with pytest.raises(ValueError, match="_folds_eval"):
        local_sgd_fedavg(x, y, flat, opt, t_idx, slot, tw,
                         eval_window=(x[:, 4:6], y[:, 4:6]),
                         eval_out=(torch.empty(4, 10, 2, dtype=torch.int32,
                                               device=cuda),
                                   torch.empty(4, 10, 2, device=cuda)),
                         **kw)
    mod = FeedForwardNN((3,), K, H)
    step = TrainStep(mod, 64, 5, K, device=cuda)
    time_w = torch.ones(4, 10, 11, device=cuda)
    time_w[..., -1] = 0
    step.generator.manual_seed(2)
    R, freq, t = 7, 5, 4
    draws = step.draw_batches(time_w, R, 500)
    counts = (local_sgd.launches, local_sgd_fedavg.evals, eval_cells.launches,
              fedavg.launches)
    params = mod.unpack(flat)
    _, _, _, _, bufs, _, _ = step.train_iteration_eval(
        params, step.init_opt_states(params, 4, 10), x, y, time_w, 1.0, R,
        freq, t, draws=draws)
    torch.cuda.synchronize()
    evs = step.eval_rounds(R, freq)
    assert (local_sgd.launches, local_sgd_fedavg.evals, eval_cells.launches,
            fedavg.launches) == (counts[0] + R, counts[1],
                                 counts[2] + len(evs), counts[3])
    p, o = params, step.init_opt_states(params, 4, 10)
    for r in range(R):
        p, o, *_ = step.train_round(p, o, x, y, time_w, 1.0,
                                    draws=(draws[0][r], draws[1][r]))
        if r in evs:
            c, l, _ = step.acc_window(p, x[:, t:t + 2], y[:, t:t + 2])
            e = evs.index(r)
            assert torch.equal(bufs[0][e], c[..., 0])
            assert torch.equal(bufs[3][e], l[..., 1])
