"""The conv path on the card (``gpu``-marked: they skip without one; on the
card ``python -m pytest --noconftest -m gpu tests/test_torch_conv_card.py``).
No JAX here: the card's results are held to the port's own CPU path.

- Each conv model of the registry at its published width: logits and the
  gradient of the cross entropy on the card against the CPU path in
  float64, relative to the largest magnitude. In float64 on the card
  within 1e-8 (the card's convolutions, paddings and norms, apart from
  TF32: the deep ResNets amplify float64's rounding to ~1e-11). In
  float32 under ``conv_numerics`` within the larger of 1e-4 and 4 times
  the CPU float32 path's own distance from float64 (TF32's ~1e-3 fails
  it where float32 is well conditioned, as for the cnn and resnet8; the
  deep ResNets' float32 gradients at init lie ~1e-2 from float64 on the
  CPU too).
- K2 (``agg_mean`` through ``fedavg.cu``) at fmow's cnn width, P
  2,183,166, M 4, C 10, against ``fedavg_ref`` within 1e-6, model 3's
  empty cluster bitwise its previous params.
- A conv round (``TrainStep.train_round`` of the cnn) twice from the same
  inputs: bitwise equal, one ``fedavg.cu`` launch each, no K1 or K3
  launch; every forward of the round under cuDNN's TF32 off and its
  algorithms deterministic, and the process's flags as they were after
  it.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.core.functional import cross_entropy
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.kernels.eval_cells import eval_cells
from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
from feddrift_torch.kernels.local_sgd import local_sgd
from feddrift_torch.models import create_model
from feddrift_torch.models.base import conv_numerics
from feddrift_torch.resilience.robust_agg import agg_mean

MODELS = (("cnn", (784,), 62), ("cnn_dropout", (784,), 62),
          ("resnet8", (32, 32, 3), 10), ("resnet20", (32, 32, 3), 10),
          ("resnet56", (32, 32, 3), 10), ("resnet110", (32, 32, 3), 10),
          ("resnet56_gn", (32, 32, 3), 10), ("resnet18", (32, 32, 3), 10))
ROWS, FLOOR, FACTOR, F64_TOL, AGG_ATOL = 32, 1e-4, 4.0, 1e-8, 1e-6
CONV_FLAGS = (False, True, False, False)


def _flags():
    """cuDNN's TF32, determinism and autotuning, and the matmuls' TF32."""
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cudnn.deterministic, b.cudnn.benchmark,
            b.cuda.matmul.allow_tf32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _module(name, shape, classes):
    ds = DriftDataset(x=np.zeros((1, 1, 1, *shape), np.float32),
                      y=np.zeros((1, 1, 1), np.int32),
                      concepts=np.zeros((1, 1), np.int64),
                      num_classes=classes)
    return create_model(name, ds, ExperimentConfig())


def _rel(got, want):
    return float((got.double().cpu() - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,classes", MODELS,
                         ids=[m[0] for m in MODELS])
def test_forward_and_gradient_match_the_cpu_path(cuda, name, shape,
                                                 classes):
    mod = _module(name, shape, classes)
    params = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(ROWS, *shape, generator=gen)
    y = torch.randint(0, classes, (ROWS,), generator=gen)
    out = {}
    before = _flags()
    for key, dt, dev in (("card", torch.float32, cuda),
                         ("card64", torch.float64, cuda),
                         ("cpu32", torch.float32, "cpu"),
                         ("cpu64", torch.float64, "cpu")):
        with conv_numerics():
            assert _flags() == CONV_FLAGS
            flat = mod.pack(params).to(dev, dt).requires_grad_(True)
            logits = mod(mod.unpack(flat), x.to(dev, dt))
            grad, = torch.autograd.grad(cross_entropy(logits, y.to(dev)),
                                        flat)
        out[key] = (logits.detach(), grad)
    assert _flags() == before
    for i in (0, 1):
        want = out["cpu64"][i]
        assert _rel(out["card64"][i], want) <= F64_TOL
        tol = max(FLOOR, FACTOR * _rel(out["cpu32"][i], want))
        assert _rel(out["card"][i], want) <= tol


@pytest.mark.gpu
def test_agg_mean_at_the_conv_width(cuda):
    M, C, P = 4, 10, 2183166
    gen = torch.Generator(device=cuda).manual_seed(3)
    client = torch.randn(M, C, P, device=cuda, generator=gen) * 0.05
    prev = torch.randn(M, P, device=cuda, generator=gen) * 0.05
    n = torch.full((M, C), 500.0, device=cuda)
    n[3] = 0.0
    n[0, 2] = 0.0
    launches, plain = fedavg.launches, fedavg_ref.cuda_calls
    got, stats = agg_mean(client, n, prev)
    torch.cuda.synchronize()
    assert fedavg.launches == launches + 1
    assert fedavg_ref.cuda_calls == plain
    want, want_stats = fedavg_ref(client, n, prev)
    assert (got - want).abs().max().item() <= AGG_ATOL
    assert torch.equal(stats, want_stats)
    assert torch.equal(got[3], prev[3])


@pytest.mark.gpu
def test_conv_round_is_bitwise_call_after_call(cuda):
    M, C, T1, N, B, S, K = 4, 10, 3, 64, 32, 5, 62
    mod = _module("cnn", (32, 32, 3), K)
    step = TrainStep(mod, B, S, K, device=cuda)
    assert step.conv
    seen = []
    hook = mod.register_forward_pre_hook(lambda m, a: seen.append(_flags()))
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(C, T1, N, 32, 32, 3, device=cuda, generator=gen)
    y = torch.randint(0, K, (C, T1, N), device=cuda, generator=gen,
                      dtype=torch.int32)
    params = {k: v[None].expand(M, *v.shape).clone() for k, v in
              mod.init_params(torch.Generator().manual_seed(0),
                              cuda).items()}
    tw = torch.zeros(M, C, T1, device=cuda)
    tw[:3, :, :2] = 1.0
    opt = step.init_opt_states(params, M, C)
    step.generator.manual_seed(1)
    t_idx, slot = step.draw_batches(tw, 1, N)
    draws = (t_idx[0], slot[0])
    counts = (local_sgd.launches, eval_cells.launches, fedavg.launches)
    before = _flags()
    a = step.train_round(params, opt, x, y, tw, draws=draws)
    b = step.train_round(params, opt, x, y, tw, draws=draws)
    torch.cuda.synchronize()
    hook.remove()
    assert seen and set(seen) == {CONV_FLAGS} and _flags() == before
    assert (local_sgd.launches, eval_cells.launches, fedavg.launches) == (
        counts[0], counts[1], counts[2] + 2)
    for i in (0, 1, 2):
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    assert all(v.is_cuda for v in a[0].values())
