"""K2, the masked FedAvg (``kernels/fedavg.py``), against the JAX package's
``robust_agg.aggregate("mean", ...)`` on the CPU, and its CUDA kernel
against the plain version on the card (``gpu``).

K2 also runs as the epilogue of K1's fused kernel
(``kernels/local_sgd.py::local_sgd_fedavg``): its plain version is
``local_sgd_ref`` then ``fedavg_ref``, and on the card the one launch must
equal the K1 launch followed by the ``fedavg.cu`` launch bit for bit, in
every output, call after call (a ticket counter picks each model's last
block and is left zero for the next launch). The round path takes it on
the fused kernel's route and launches ``fedavg.cu`` on the general one.

Both packages get the same seeded numpy client stack, weights and previous
params. Tolerance: the mean at atol 1e-6 (float32; ten or fewer weighted
terms of size ~1 summed in another order), the stats exactly, and a
cluster with no active client returns its previous params bitwise.

JAX is imported inside the CPU tests, so the ``gpu`` tests run on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_fedavg.py``.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
from feddrift_torch.kernels.local_sgd import (_tickets, init_opt_state,
                                              local_sgd,
                                              local_sgd_fedavg,
                                              local_sgd_fedavg_ref,
                                              local_sgd_ref)
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_torch.resilience.robust_agg import agg_mean
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-6

# (label, M, C, P, which weights are 0): a cluster with no active client,
# clients with n = 0, one model, and P not a multiple of 32 (62 is the
# canonical fnn's; 300 spans two kernel blocks)
CASES = (("empty_cluster", 3, 4, 7, "cluster"),
         ("zero_clients", 4, 10, 62, "clients"),
         ("one_model", 1, 5, 33, "clients"),
         ("wide", 2, 6, 300, "both"))


def _case(seed, M, C, P, zeros):
    rng = np.random.default_rng(seed)
    client = rng.standard_normal((M, C, P)).astype(np.float32)
    prev = rng.standard_normal((M, P)).astype(np.float32)
    n = (rng.random((M, C)) * 500).astype(np.float32)
    if zeros in ("cluster", "both"):
        n[M - 1] = 0.0
    if zeros in ("clients", "both"):
        n[0, ::3] = 0.0
    return client, n, prev


def _round_case(seed, F=3, H=10, M=4, C=10, T1=4, N=100, B=100, S=3):
    """Seeded inputs of one K1 round at the fused kernel's widths (H = 10,
    K = 2): pairs (0, 3), (2, 7) and all of model M - 1 inactive, so that
    model has no active client."""
    rng = np.random.default_rng(seed)
    P = F * H + H + H * 2 + 2
    x = rng.uniform(0, 10, (C, T1, N, F)).astype(np.float32)
    y = (x[..., -1] + x[..., 0] > 10).astype(np.int32)
    params = (rng.standard_normal((M, P)) * 0.3).astype(np.float32)
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    tw[:, :, 0] = 1
    tw[0, 3] = tw[2, 7] = tw[M - 1] = 0
    t_idx = rng.integers(0, T1 - 1, (M, C, S)).astype(np.int32)
    slot = rng.integers(0, N // B, (M, C, S)).astype(np.int32)
    t = torch.from_numpy
    return [t(x), t(y), t(params), init_opt_state(M, C, P, "cpu"),
            t(t_idx), t(slot), t(tw.sum(-1))], dict(
        hidden=H, batch_size=B, lr=0.01, wd=0.001)


def _reference(client, n, prev):
    import jax.numpy as jnp
    from feddrift_tpu.resilience import robust_agg as jagg
    out, stats = jagg.aggregate("mean", jnp.asarray(client), jnp.asarray(n),
                                jnp.asarray(prev), None,
                                jagg.RobustAggConfig())
    return np.asarray(out), np.asarray(stats)


@pytest.mark.parametrize("label,M,C,P,zeros", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_matches_reference(label, M, C, P, zeros):
    client, n, prev = _case(len(label), M, C, P, zeros)
    want, want_stats = _reference(client, n, prev)
    got, stats = fedavg(*(torch.from_numpy(a) for a in (client, n, prev)))
    assert got.shape == (M, P) and stats.shape == (M, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.array_equal(stats.numpy(), want_stats)
    assert stats[:, 0].tolist() == (n > 0).sum(1).tolist()
    empty = n.sum(1) == 0
    assert np.array_equal(got.numpy()[empty], prev[empty])


def test_zero_weight_clients_do_not_enter_the_mean():
    """A client with n = 0 leaves the mean as it is, whatever its row
    holds (reference: its weight is 0)."""
    client, n, prev = _case(1, 2, 6, 62, "clients")
    t = [torch.from_numpy(a) for a in (client, n, prev)]
    base, _ = fedavg(*t)
    t[0][0, ::3] = 1e3
    moved, _ = fedavg(*t)
    assert torch.equal(base, moved)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    client, n, prev = (torch.from_numpy(a)
                       for a in _case(2, 3, 4, 7, "cluster"))
    launches, plain = fedavg.launches, fedavg_ref.cuda_calls
    stats_buf = torch.full((5, 3, 3), -1.0)
    out, stats = agg_mean(client, n, prev, stats_out=stats_buf[2])
    want, want_stats = fedavg_ref(client, n, prev)
    assert torch.equal(out, want) and torch.equal(stats, want_stats)
    assert torch.equal(stats_buf[2], want_stats)
    assert (stats_buf[[0, 1, 3, 4]] == -1).all()
    assert fedavg.launches == launches and fedavg_ref.cuda_calls == plain


def test_rejects_mismatched_shapes():
    client, n, prev = (torch.from_numpy(a)
                       for a in _case(3, 3, 4, 7, "clients"))
    with pytest.raises(ValueError, match=r"client \[M, C, P\]"):
        fedavg(client, n[:2], prev)
    with pytest.raises(ValueError, match=r"prev \[M, P\]"):
        fedavg(client, n, prev[:, :5])
    with pytest.raises(ValueError, match="stats_out"):
        fedavg(client, n, prev, stats_out=torch.empty(3, 2))


def test_fused_round_plain_version_is_k1_then_k2():
    """On the CPU the fused round is ``local_sgd_ref`` then ``fedavg_ref``
    of its client stack with the params as prev, bitwise; the stats land
    in the caller's row; no launch is counted."""
    args, kw = _round_case(1)
    counts = (local_sgd.launches, local_sgd_fedavg.launches, fedavg.launches,
              fedavg_ref.cuda_calls)
    buf = torch.full((3, 4, 3), -1.0)
    got = local_sgd_fedavg(*args, **kw, stats_out=buf[1])
    client, opt, n, loss = local_sgd_ref(*args, **kw)
    agg, stats = fedavg_ref(client, n, args[2])
    want = (client, opt, n, loss, agg, stats)
    assert torch.equal(got[0], client) and torch.equal(got[2], n)
    assert torch.equal(got[3], loss) and torch.equal(got[4], agg)
    assert all(torch.equal(got[1][k], opt[k]) for k in opt)
    assert got[5].data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], stats) and (buf[[0, 2]] == -1).all()
    assert torch.equal(got[4][3], args[2][3])      # no active client: prev
    assert stats[:, 0].tolist() == (n > 0).sum(1).tolist()
    ref = local_sgd_fedavg_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref[2:], want[2:]))
    assert (local_sgd.launches, local_sgd_fedavg.launches, fedavg.launches,
            fedavg_ref.cuda_calls) == counts


@pytest.mark.parametrize("hidden,fused", [(10, True), (32, False)])
def test_round_body_takes_the_epilogue_on_the_fused_route(monkeypatch,
                                                          hidden, fused):
    """``TrainStep._round_body`` routes by shape before any launch: the
    fused kernel's widths go through ``local_sgd_fedavg`` (one launch on
    the card), any other through ``local_sgd`` then ``agg_mean`` (K2's own
    launch); both give the same outputs."""
    import feddrift_torch.core.step as step_mod
    calls = {"fused": 0, "k1": 0, "agg": 0}

    def count(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner
    monkeypatch.setattr(step_mod, "local_sgd_fedavg",
                        count("fused", step_mod.local_sgd_fedavg))
    monkeypatch.setattr(step_mod, "local_sgd", count("k1", step_mod.local_sgd))
    monkeypatch.setattr(step_mod, "agg_mean", count("agg", step_mod.agg_mean))
    args, kw = _round_case(2, H=hidden)
    x, y, params, opt, t_idx, slot, total_w = args
    mod = FeedForwardNN((3,), 2, hidden)
    step = TrainStep(mod, kw["batch_size"], t_idx.shape[2], 2, lr=kw["lr"],
                     wd=kw["wd"], device="cpu")
    stats = torch.full((2, 4, 3), -1.0)
    out = step._round_body(params, opt, x, y, total_w, (t_idx, slot), 1.0,
                           stats_out=stats[1])
    assert calls == ({"fused": 1, "k1": 0, "agg": 0} if fused
                     else {"fused": 0, "k1": 1, "agg": 1})
    want = local_sgd_fedavg_ref(*args, **kw)
    assert torch.equal(out[0], want[4]) and torch.equal(out[5], want[5])
    assert torch.equal(out[2], want[0]) and torch.equal(out[3], want[2])
    assert torch.equal(stats[1], want[5]) and (stats[0] == -1).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("label,M,C,P,zeros", CASES + (
    ("canonical", 4, 10, 62, "both"), ("thousands", 3, 10, 5000, "both")),
    ids=[c[0] for c in CASES] + ["canonical", "thousands"])
def test_kernel_matches_plain(cuda, label, M, C, P, zeros):
    """Within 1e-6 of the plain version, empty clusters bitwise prev,
    stats equal, two calls bitwise, one launch a call and no plain call."""
    client, n, prev = (torch.from_numpy(a).to(cuda)
                       for a in _case(len(label), M, C, P, zeros))
    launches, plain = fedavg.launches, fedavg_ref.cuda_calls
    got, stats = fedavg(client, n, prev)
    again, again_stats = fedavg(client, n, prev)
    torch.cuda.synchronize()
    assert fedavg.launches == launches + 2
    assert fedavg_ref.cuda_calls == plain
    assert torch.equal(got, again) and torch.equal(stats, again_stats)
    want, want_stats = fedavg_ref(client, n, prev)
    assert (got - want).abs().max().item() <= ATOL
    assert torch.equal(stats, want_stats)
    empty = n.sum(1) == 0
    assert torch.equal(got[empty], prev[empty])


@pytest.mark.gpu
def test_kernel_writes_stats_into_a_row_of_a_buffer(cuda):
    client, n, prev = (torch.from_numpy(a).to(cuda)
                       for a in _case(4, 4, 10, 62, "both"))
    buf = torch.full((6, 4, 3), -1.0, device=cuda)
    _, stats = fedavg(client, n, prev, stats_out=buf[4])
    torch.cuda.synchronize()
    assert stats.data_ptr() == buf[4].data_ptr()
    assert torch.equal(buf[4], fedavg_ref(client, n, prev)[1])
    assert (buf[[0, 1, 2, 3, 5]] == -1).all()


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    client, n, prev = (torch.from_numpy(a).to(cuda)
                       for a in _case(5, 2, 4, 40, "clients"))
    launches = fedavg.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        fedavg(client.double(), n, prev)
    with pytest.raises(ValueError, match="contiguous float32"):
        fedavg(client.transpose(0, 1).contiguous().transpose(0, 1), n, prev)
    with pytest.raises(ValueError, match="contiguous float32"):
        fedavg(client, n.cpu(), prev)
    assert fedavg.launches == launches


def _card_round(cuda, gathered: bool, F: int = 3, seed: int = 6):
    """The canonical round shape (M 4, C 10, T1 11, N = B = 500, S 5) on the
    card, contiguous batches or rows gathered by K4 with feature masks."""
    from feddrift_torch.kernels.weighted_draw import weighted_draw
    args, kw = _round_case(seed, F=F, T1=11, N=500, B=500, S=5)
    args = [a.to(cuda) if torch.is_tensor(a) else
            {k: v.to(cuda) for k, v in a.items()} for a in args]
    if gathered:
        rng = np.random.default_rng(seed + 1)
        M, C, T1 = 4, 10, 11
        tw = torch.from_numpy((rng.random((M, C, T1)) < 0.5)
                              .astype(np.float32)).to(cuda)
        sw = torch.from_numpy(rng.poisson(1.0, (M, C, 500))
                              .astype(np.float32)).to(cuda)
        u = torch.rand((M, C, 5, 500), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(seed))
        fm = torch.ones((M, F), device=cuda)
        fm[1, 0] = 0
        args[4] = args[5] = None
        kw = dict(kw, idx=weighted_draw(tw, sw, u), feat_mask=fm)
    return args, kw


FUSED_ROUNDS = (("canonical", False, 3), ("gathered", True, 3),
                ("sine", False, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("label,gathered,F", FUSED_ROUNDS,
                         ids=[c[0] for c in FUSED_ROUNDS])
def test_fused_round_equals_k1_then_k2(cuda, label, gathered, F):
    """One launch of K1 with its K2 epilogue equals the K1 launch followed
    by the ``fedavg.cu`` launch bitwise: aggregated params, stats, client
    stack, optimizer state, n and losses; 200 calls back to back give the
    same bits (a ticket race or a ticket left non-zero would not)."""
    args, kw = _card_round(cuda, gathered, F)
    x, y, params, opt, t_idx, slot, total_w = args
    fresh = lambda: {k: v.clone() for k, v in opt.items()}
    state = fresh()
    client, state, n, loss = local_sgd(x, y, params, state, t_idx, slot,
                                       total_w, **kw)
    agg, stats = fedavg(client, n, params)
    counts = (local_sgd.launches, local_sgd_fedavg.launches, fedavg.launches)
    states = [fresh() for _ in range(200)]
    rows = torch.full((200, 4, 3), -1.0, device=cuda)
    outs = [local_sgd_fedavg(x, y, params, st, t_idx, slot, total_w, **kw,
                             stats_out=rows[i])
            for i, st in enumerate(states)]
    torch.cuda.synchronize()
    assert (local_sgd.launches, local_sgd_fedavg.launches,
            fedavg.launches) == (counts[0] + 200, counts[1] + 200, counts[2])
    for i, out in enumerate(outs):
        f_client, f_state, f_n, f_loss, f_agg, f_stats = out
        assert f_stats.data_ptr() == rows[i].data_ptr()
        assert torch.equal(f_agg, agg) and torch.equal(f_stats, stats), i
        assert torch.equal(f_client, client) and torch.equal(f_n, n)
        assert torch.equal(f_loss, loss)
        assert all(torch.equal(f_state[k], state[k]) for k in state)
    assert torch.equal(agg[3], params[3]) and stats[3, 0] == 0
    want, want_stats = fedavg_ref(client, n, params)
    assert (agg - want).abs().max().item() <= ATOL
    assert torch.equal(stats, want_stats)


@pytest.mark.gpu
def test_general_route_launches_fedavg(cuda):
    """At H = 32 the round takes the general kernel, which has no
    epilogue: K1 and ``fedavg.cu`` launch once each, and the fused call
    refuses the shape without a launch."""
    args, kw = _round_case(3, H=32, T1=4, N=100, B=100, S=3)
    x, y, params, opt, t_idx, slot, total_w = [
        a.to(cuda) if torch.is_tensor(a) else
        {k: v.to(cuda) for k, v in a.items()} for a in args]
    step = TrainStep(FeedForwardNN((3,), 2, 32), 100, 3, 2, lr=kw["lr"],
                     wd=kw["wd"], device=cuda)
    counts = (local_sgd.launches, local_sgd_fedavg.launches, fedavg.launches)
    out = step._round_body(params, {k: v.clone() for k, v in opt.items()},
                           x, y, total_w, (t_idx, slot), 1.0)
    torch.cuda.synchronize()
    assert (local_sgd.launches, local_sgd_fedavg.launches,
            fedavg.launches) == (counts[0] + 1, counts[1], counts[2] + 1)
    assert torch.equal(out[0], fedavg(out[2], out[3], params)[0])
    with pytest.raises(ValueError, match="no FedAvg epilogue"):
        local_sgd_fedavg(x, y, params, opt, t_idx, slot, total_w, **kw)
    assert local_sgd.launches == counts[0] + 1


@pytest.mark.gpu
def test_fused_round_launches_or_raises(cuda):
    """A CUDA tensor the fused call does not take raises; nothing falls
    back to the plain version."""
    args, kw = _card_round(cuda, False)
    x, y, params, opt, t_idx, slot, total_w = args
    counts = (local_sgd.launches, fedavg_ref.cuda_calls)
    with pytest.raises(ValueError, match="stats_out"):
        local_sgd_fedavg(x, y, params, opt, t_idx, slot, total_w, **kw,
                         stats_out=torch.empty((4, 3), device=cuda).t())
    with pytest.raises(ValueError, match="total_w"):
        local_sgd_fedavg(x, y, params, opt, t_idx, slot, total_w.double(),
                         **kw)
    assert (local_sgd.launches, fedavg_ref.cuda_calls) == counts
    torch.cuda.synchronize()
    assert all((t == 0).all() for t in _tickets.values())
