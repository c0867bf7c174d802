"""Tests of the port that need the CUDA card (``gpu`` marker); they skip
without one. They import nothing of JAX, so they run on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_card.py

- K1 (``kernels/csrc/local_sgd.cu``) against its plain version
  ``local_sgd_ref``, through both of its kernels: the fused one at the
  canonical SEA shape (M=4, C=10, T1=11, N=B=500, S=5, F=3, H=10, K=2), at
  F=2 (sine, circle), with more steps than its ring has stages, with rows
  whose offsets rule out the bulk copies, and with fewer rows than
  threads, and at susy's F=18 (contiguous, and gathered with feature
  masks) and ro's F=5, where it folds a row's values in chunks; the
  general one at H=32 and, forced, at the SEA shape; some
  pairs inactive. Tolerance: params, mu and losses at atol 1e-5 (float32
  sums over 500 rows in another order, five AMSGrad steps of lr = 0.01);
  nu and nu_max at rtol 1e-4 (squares of gradients). Inactive pairs come
  back bitwise equal to what went in, and two calls agree bitwise.
- ``local_sgd.launches`` advances by one per round, and a canonical
  ``Experiment`` on the card takes every round through K1, on the fused
  and the per-round path alike (the two give the same numbers bitwise). A
  client mask reaches K1 as total weight 0: masked pairs come back as they
  went in, sampled pairs bitwise as in the unmasked call.
- A step draws where its generator lives: a card step given a CPU
  generator draws bitwise what a CPU step draws from the same seed.
- K1's gather route (explicit rows from the weighted draw, K4, and
  per-model feature masks) against the plain version through both
  kernels, and a KUE run through K4 (its cdf once a step, its search once
  a round) and K1.
- A served row's answer does not depend on its batch: one serving forward
  at b1 and at b32 with the same row agree bitwise, op by op.
- A serving forward at every bucket goes through the per-row Dense kernel
  (9 launches: four Dense layers in each of two blocks and the lm_head)
  and gives the plain CPU path's logits within 1e-4 (two 128-wide blocks
  summed in other orders).
"""

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.local_sgd import (_route, init_opt_state,
                                              local_sgd, local_sgd_ref)

ATOL = 1e-5
NU_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(F, M=4, C=10, T1=11, N=500, B=500, S=5, H=10, K=2, seed=0):
    """Seeded inputs of one round; pairs (0, 3), (2, 7) and all of model 3
    inactive; optimizer state part-way through a step (count 15)."""
    rng = np.random.default_rng(seed)
    P = F * H + H + H * K + K
    x = rng.uniform(0, 10, (C, T1, N, F)).astype(np.float32)
    y = (x[..., -1] + x[..., 0] > 10).astype(np.int32)
    params = (rng.standard_normal((M, P)) * 0.3).astype(np.float32)
    opt = {"mu": rng.standard_normal((M, C, P)).astype(np.float32) * 1e-2,
           "nu": rng.random((M, C, P)).astype(np.float32) * 1e-3,
           "count": np.full((M, C), 15, np.int32)}
    opt["nu_max"] = opt["nu"] * 1.5
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    if M == 4 and C == 10:
        tw[0, 3] = tw[2, 7] = tw[3] = 0
    t_idx = rng.integers(0, T1 - 1, (M, C, S)).astype(np.int32)
    slot = rng.integers(0, N // B, (M, C, S)).astype(np.int32)
    return (x, y, params, opt, t_idx, slot, tw.sum(-1)), dict(
        hidden=H, batch_size=B, lr=0.01, wd=0.001)


def _to(dev, args):
    x, y, params, opt, t_idx, slot, total_w = args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(x), t(y), t(params), {k: t(v) for k, v in opt.items()},
            t(t_idx), t(slot), t(total_w))


# (name, _case arguments, route): the canonical SEA shape and sine's F = 2;
# 12 steps through the fused kernel's 8-stage ring; N = B = 498, whose
# batch offsets are not 16-byte aligned (per-thread copies); 20 rows in a
# block of 64 threads; H = 32 (the general kernel); SEA forced general;
# susy's and ro's widths (18 -> 10 -> 2, P 212, and 5 -> 10 -> 2, P 82: the
# fused kernel folding a row's values 32 at a time), and susy's on gathered
# rows with feature masks (K4's draw, the per-thread copies)
K1_CASES = (("sea", dict(F=3), "fused"), ("sine", dict(F=2), "fused"),
            ("ring", dict(F=2, S=12), "fused"),
            ("unaligned", dict(F=3, N=498, B=498, S=10), "fused"),
            ("few_rows", dict(F=3, N=40, B=20, S=12), "fused"),
            ("h32", dict(F=3, H=32), "general"),
            ("sea_general", dict(F=3), "general"),
            ("susy", dict(F=18), "fused"), ("ro", dict(F=5), "fused"),
            ("susy_gather", dict(F=18, gather=True), "fused"))


@pytest.mark.gpu
@pytest.mark.parametrize("name,case,route", K1_CASES,
                         ids=[c[0] for c in K1_CASES])
def test_local_sgd_kernel_matches_plain(cuda, name, case, route):
    case = dict(case)
    gather = case.pop("gather", False)
    args, kw = _case(**case)
    F, H, B = case["F"], kw["hidden"], kw["batch_size"]
    forced = name == "sea_general"
    assert forced or _route(F, H, 2, B) == route
    k_args, r_args = _to(cuda, args), _to(cuda, args)
    if gather:
        # K4's rows and feature masks; the case's weights keep its
        # inactive pairs
        idx, fm, _ = _gathered(cuda, args, kw)
        kw = dict(kw, idx=idx, feat_mask=fm)
        k_args = k_args[:4] + (None, None) + k_args[6:]
        r_args = r_args[:4] + (None, None) + r_args[6:]
    before = local_sgd.launches
    client, opt, n, loss = local_sgd(*k_args, **kw,
                                     route=route if forced else None)
    torch.cuda.synchronize()
    assert local_sgd.launches == before + 1
    assert opt is k_args[3]                     # updated in place
    r_client, r_opt, r_n, r_loss = local_sgd_ref(*r_args, **kw)
    torch.testing.assert_close(client, r_client, atol=ATOL, rtol=0)
    torch.testing.assert_close(loss, r_loss, atol=ATOL, rtol=0)
    assert torch.equal(n, r_n)
    torch.testing.assert_close(opt["mu"], r_opt["mu"], atol=ATOL, rtol=0)
    for k in ("nu", "nu_max"):
        torch.testing.assert_close(opt[k], r_opt[k], atol=1e-9, rtol=NU_RTOL)
    assert torch.equal(opt["count"], r_opt["count"])
    # inactive pairs: outputs bitwise equal to the inputs
    fresh = _to(cuda, args)
    for m, c in ((0, 3), (2, 7), (3, 0), (3, 9)):
        assert torch.equal(client[m, c], fresh[2][m])
        for key in ("mu", "nu", "nu_max", "count"):
            assert torch.equal(opt[key][m, c], fresh[3][key][m, c])
        assert n[m, c] == 0 and loss[m, c] > 0
    active = k_args[-1] > 0
    assert (opt["count"][active] == 15 + case.get("S", 5)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "general"])
def test_local_sgd_two_calls_are_bitwise_equal(cuda, route):
    """A fixed summation order: the same inputs give the same bits."""
    args, kw = _case(3)
    outs = []
    for _ in range(2):
        a = _to(cuda, args)
        client, opt, n, loss = local_sgd(*a, **kw, route=route)
        outs.append((client, loss, n, *opt.values()))
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_local_sgd_with_a_client_mask(cuda):
    """A client mask reaches K1 as total weight 0: the masked pairs come
    back bitwise as they went in, with n = 0, and every sampled pair's
    rows are bitwise those of the unmasked call."""
    from feddrift_torch.core.step import TrainStep
    args, kw = _case(3)
    mask = torch.zeros(10, device=cuda)
    mask[[1, 4, 5, 8]] = 1.0
    tw = np.random.default_rng(3).random((4, 10, 11)).astype(np.float32)
    tw[..., -1] = 0
    tw = torch.from_numpy(tw).to(cuda)
    a, b = _to(cuda, args), _to(cuda, args)
    full = local_sgd(*a[:6], TrainStep.total_weight(tw), **kw)
    masked = local_sgd(*b[:6], TrainStep.total_weight(tw, mask), **kw)
    torch.cuda.synchronize()
    fresh = _to(cuda, args)
    on, off = mask.bool(), ~mask.bool()
    assert (masked[2][:, off] == 0).all() and (masked[2][:, on] > 0).all()
    assert torch.equal(masked[0][:, off],
                       fresh[2][:, None].expand(4, 10, -1)[:, off])
    for key in ("mu", "nu", "nu_max", "count"):
        assert torch.equal(masked[1][key][:, off], fresh[3][key][:, off])
        assert torch.equal(masked[1][key][:, on], full[1][key][:, on])
    for i in (0, 2, 3):
        assert torch.equal(masked[i][:, on], full[i][:, on])


@pytest.mark.gpu
def test_per_round_path_goes_through_the_kernel(cuda):
    """CFL (per-round) and a sampled run on both paths, on the card: one
    K1 launch a round, and the fused and per-round paths give the same
    Test/Acc series and pool bitwise."""
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    kw = dict(train_iterations=2, comm_round=20, client_num_per_round=4)
    runs = {}
    for name, extra in (("fused", {}), ("per_round", {"chunk_rounds": False}),
                        ("cfl", {"concept_drift_algo_arg": "cfl_0.1_win-1"})):
        exp = Experiment(ExperimentConfig(**kw, **extra))
        before = local_sgd.launches
        exp.run()
        assert local_sgd.launches == before + 40, name
        runs[name] = exp
    series = [[(r["round"], r["Test/Acc"]) for r in runs[k].logger.history]
              for k in ("fused", "per_round")]
    assert series[0] == series[1]
    for key, v in runs["fused"].pool.params.items():
        assert torch.equal(v, runs["per_round"].pool.params[key])


def _gathered(dev, args, kw, seed=0):
    """Gathered batches for ``_case``'s inputs: rows of each pair's client
    from K4 (the weighted draw under the case's time weights and Poisson
    sample weights) and 0/1 feature masks, as KUE trains."""
    from feddrift_torch.kernels.weighted_draw import weighted_draw
    x = args[0]
    C, T1, N, F = x.shape
    M = args[2].shape[0]
    rng = np.random.default_rng(seed + 50)
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    sw = rng.poisson(1.0, (M, C, N)).astype(np.float32)
    u = rng.random((M, C, 5, kw["batch_size"])).astype(np.float32)
    fm = (rng.random((M, F)) < 0.6).astype(np.float32)
    fm[:, 0] = 1.0
    t = lambda a: torch.from_numpy(a).to(dev)
    return weighted_draw(t(tw), t(sw), t(u)), t(fm), t(tw.sum(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "general"])
def test_local_sgd_gather_route_matches_plain(cuda, route):
    """K1 on explicit rows ``idx [M, C, S, B]`` with per-model feature
    masks (the gathered batches of the weighted draw): the per-thread copy
    branch of either kernel against ``local_sgd_ref`` on the same rows and
    masks, at the tolerances above; two calls bitwise equal."""
    args, kw = _case(3)
    idx, fm, total_w = _gathered(cuda, args, kw)
    outs = []
    for _ in range(2):
        a = _to(cuda, args)
        outs.append(local_sgd(a[0], a[1], a[2], a[3], None, None, total_w,
                              **kw, route=route, idx=idx, feat_mask=fm))
    torch.cuda.synchronize()
    for x, y in zip((outs[0][0], outs[0][2], outs[0][3],
                     *outs[0][1].values()),
                    (outs[1][0], outs[1][2], outs[1][3],
                     *outs[1][1].values())):
        assert torch.equal(x, y)
    r = _to(cuda, args)
    r_client, r_opt, r_n, r_loss = local_sgd_ref(
        r[0], r[1], r[2], r[3], None, None, total_w, **kw, idx=idx,
        feat_mask=fm)
    client, opt, n, loss = outs[0]
    torch.testing.assert_close(client, r_client, atol=ATOL, rtol=0)
    torch.testing.assert_close(loss, r_loss, atol=ATOL, rtol=0)
    torch.testing.assert_close(opt["mu"], r_opt["mu"], atol=ATOL, rtol=0)
    for k in ("nu", "nu_max"):
        torch.testing.assert_close(opt[k], r_opt[k], atol=1e-9, rtol=NU_RTOL)
    assert torch.equal(n, r_n) and torch.equal(opt["count"], r_opt["count"])
    # a mask with every feature off: the rows' x do not matter
    none = torch.zeros_like(fm)
    a, b = _to(cuda, args), _to(cuda, args)
    b[0].normal_()
    first = local_sgd(a[0], a[1], a[2], a[3], None, None, total_w, **kw,
                      route=route, idx=idx, feat_mask=none)
    second = local_sgd(b[0], a[1], a[2], b[3], None, None, total_w, **kw,
                       route=route, idx=idx, feat_mask=none)
    assert torch.equal(first[0], second[0])


@pytest.mark.gpu
def test_kue_rounds_go_through_the_draw_and_the_kernel(cuda):
    """A KUE run on the card: K4's cdf once a step, its search and K1 once
    a round, finite ensemble metrics."""
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                      weighted_search)
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(concept_drift_algo="kue",
                                      train_iterations=2, comm_round=20))
    k1, k4a, k4b = (local_sgd.launches, weighted_cdf.launches,
                    weighted_search.launches)
    exp.run()
    assert (local_sgd.launches, weighted_cdf.launches,
            weighted_search.launches) == (k1 + 40, k4a + 2, k4b + 40)
    assert all(0.0 <= r["Test/Acc"] <= 1.0 for r in exp.logger.history)


@pytest.mark.gpu
def test_local_sgd_refuses_what_it_cannot_take(cuda):
    args, kw = _case(3, M=1, C=1, T1=2, N=6000, B=6000)
    a = _to(cuda, args)
    before = local_sgd.launches
    with pytest.raises(ValueError, match="shared memory"):
        local_sgd(*a, **kw)                # 283 KB > 227 KB a block
    assert local_sgd.launches == before    # refused without a launch
    args, kw = _case(3, M=1, C=2, T1=3, N=40, B=40)
    a = _to(cuda, args)
    with pytest.raises(ValueError, match="not a 3->7->K fnn"):
        local_sgd(*a, **{**kw, "hidden": 7})
    with pytest.raises(ValueError, match="y: want torch.int32"):
        local_sgd(a[0], a[1].long(), *a[2:], **kw)


@pytest.mark.gpu
def test_launches_one_per_round(cuda):
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    mod = FeedForwardNN((3,), 2, 10)
    step = TrainStep(mod, 500, 5, 2, device=cuda)
    gen = torch.Generator().manual_seed(0)
    params = mod.unpack(torch.stack([mod.pack(mod.init_params(gen, cuda))
                                     for _ in range(4)]))
    (x, y, *_), _ = _case(3)
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    tw = torch.ones(4, 10, 11, device=cuda)
    tw[..., -1] = 0
    step.generator.manual_seed(1)
    before = local_sgd.launches
    step.train_round(params, step.init_opt_states(params, 4, 10), x, y, tw)
    assert local_sgd.launches == before + 1
    out = step.train_iteration_eval(params, step.init_opt_states(params, 4, 10),
                                    x, y, tw, 1.0, 12, 5, 3)
    torch.cuda.synchronize()
    assert local_sgd.launches == before + 13
    assert all(b.shape == (4, 4, 10) for b in out[4])


@pytest.mark.gpu
def test_a_cpu_generator_gives_a_card_step_the_cpu_draws(cuda):
    """A step draws where its generator lives: a card step given a CPU
    generator draws, bitwise, what a CPU step draws from the same seed,
    and returns the draws on the card."""
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    mod = FeedForwardNN((3,), 2, 10)
    cpu = TrainStep(mod, 50, 5, 2, device="cpu")
    card = TrainStep(mod, 50, 5, 2, device=cuda)
    card.generator = torch.Generator()
    draws = []
    for step in (cpu, card):
        step.generator.manual_seed(3)
        draws.append((*step.draw_uniforms(4, 2, 3, 500),
                      step.draw_row_uniforms(2, 3, 500)))
    for want, got in zip(*draws):
        assert got.is_cuda and not want.is_cuda
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_experiment_rounds_go_through_the_kernel(cuda, tmp_path):
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(train_iterations=2, comm_round=20)
    exp = Experiment(cfg, out_dir=str(tmp_path))
    before = local_sgd.launches
    exp.run()
    assert local_sgd.launches == before + 40
    accs = [r["Test/Acc"] for r in exp.logger.history]
    assert len(accs) == 2 * 5 and all(0.0 <= a <= 1.0 for a in accs)
    assert accs[-1] > 0.7
    assert (tmp_path / "ckpt" / "MANIFEST.json").is_file()


@pytest.mark.gpu
def test_served_row_batch_variance_located(cuda):
    """Row 0 served alone (b1) and in a batch of 32: every op's output for
    that row, and so its logits, agree bitwise (the Dense layers' kernel
    tiles do not depend on the batch)."""
    from feddrift_torch.core.step import ForwardStep
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.models import transformer
    from feddrift_torch.obs.optrace import first_difference, record_calls
    model = transformer.TransformerLM(vocab_size=90, max_len=128)
    pool = ModelPool.create(model, None, 4, seed=0, identical=False,
                            device=cuda)
    step = ForwardStep(apply_rows=pool.apply_rows)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 90, (32, 80))).to(cuda)
    midx = torch.from_numpy(rng.integers(0, 4, 32)).to(cuda)
    ops = ("embed", "layer_norm", "dense", "flash_attention")
    with record_calls(transformer, ops) as one:
        out1 = step.forward(pool.params, x[:1], midx[:1])
    with record_calls(transformer, ops) as many:
        out32 = step.forward(pool.params, x, midx)
    diffs, first = first_difference(one, many)
    print("batch-variance per op:", diffs, "first:", first)
    assert len(diffs) == 2 + 2 * 7 + 2
    assert first is None, diffs
    assert torch.equal(out1[0], out32[0])


@pytest.mark.gpu
def test_served_forward_goes_through_dense_rows_at_every_bucket(cuda):
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.core.step import ForwardStep
    from feddrift_torch.kernels.dense_rows import dense_rows
    from feddrift_torch.models import transformer
    from feddrift_torch.platform.serving import SERVE_BUCKETS
    model = transformer.TransformerLM(vocab_size=90, max_len=128)
    pool = ModelPool.create(model, None, 4, seed=0, identical=False,
                            device=cuda)
    step = ForwardStep(apply_rows=pool.apply_rows)
    plain = transformer.TransformerLM(vocab_size=90, max_len=128,
                                      attention_impl="blockwise")
    cpu_params = {k: v.cpu() for k, v in pool.params.items()}
    rng = np.random.default_rng(1)
    for B in SERVE_BUCKETS:
        x = torch.from_numpy(rng.integers(0, 90, (B, 80)))
        midx = torch.from_numpy(rng.integers(0, 4, B))
        before = dense_rows.launches
        out = step.forward(pool.params, x.to(cuda), midx.to(cuda))
        torch.cuda.synchronize()
        assert dense_rows.launches == before + 9, B
        with torch.no_grad():
            want = plain({k: v[midx] for k, v in cpu_params.items()}, x)
        torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=0)
