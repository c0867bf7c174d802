"""The LSTM cell's kernels on the card (``gpu``-marked: they skip without
one; on the card ``python -m pytest --noconftest -m gpu
tests/test_torch_lstm_cell_card.py``). No JAX here: the kernels are held to
their plain versions (``tests/test_torch_lstm_cell.py`` holds those to
flax) and the LSTMs on the card to the port's CPU path.

- ``lstm_cell_fwd`` / ``lstm_cell_bwd`` at CharLSTM's (R 960, H 256) and
  WordLSTM's (R 1280, H 670: no multiple of 32) step shapes and at ragged
  ones, float32 and float64: within 1e-6 of the plain output's largest
  magnitude (float32 exp and tanh a few ulp apart), one launch a call and
  no plain call; what the kernel refuses, refused.
- Both LSTMs at their published widths on 8 rows: float64 logits and
  gradients on the card through the kernels within 1e-8 of the CPU path's.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.core.functional import cross_entropy
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                              lstm_cell_bwd_ref,
                                              lstm_cell_fwd,
                                              lstm_cell_fwd_ref)
from feddrift_torch.models import create_model
from feddrift_torch.models.base import model_numerics

RTOL, F64_TOL = 1e-6, 1e-8
SHAPES = ((960, 256), (1280, 670), (1, 1), (33, 31), (7, 670))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("R,H", SHAPES)
def test_kernels_match_their_plain_versions(cuda, R, H, dtype):
    gen = torch.Generator(device=cuda).manual_seed(R * 1000 + H)
    z = 2.0 * torch.randn(R, 4 * H, device=cuda, generator=gen, dtype=dtype)
    c, dh, dcn = (torch.randn(R, H, device=cuda, generator=gen, dtype=dtype)
                  for _ in range(3))
    launches = lstm_cell_fwd.launches, lstm_cell_bwd.launches
    calls = lstm_cell_fwd_ref.cuda_calls, lstm_cell_bwd_ref.cuda_calls
    fwd = lstm_cell_fwd(z, c)
    bwd = lstm_cell_bwd(dh, dcn, fwd[2], c, fwd[1])
    torch.cuda.synchronize()
    assert (lstm_cell_fwd.launches - launches[0],
            lstm_cell_bwd.launches - launches[1]) == (1, 1)
    want_f = lstm_cell_fwd_ref(z, c)
    want_b = lstm_cell_bwd_ref(dh, dcn, want_f[2], c, want_f[1])
    assert (lstm_cell_fwd_ref.cuda_calls - calls[0],
            lstm_cell_bwd_ref.cuda_calls - calls[1]) == (1, 1)
    for got, want in zip((*fwd, *bwd), (*want_f, *want_b)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel(got, want) <= RTOL


@pytest.mark.gpu
def test_refusals(cuda):
    z = torch.zeros(4, 8, device=cuda)
    c = torch.zeros(4, 2, device=cuda)
    with pytest.raises(ValueError):               # z not [R, 4H]
        lstm_cell_fwd(z[:, :7], c)
    with pytest.raises(ValueError):               # a strided view
        lstm_cell_fwd(torch.zeros(4, 16, device=cuda)[:, ::2], c)
    with pytest.raises(ValueError):               # mixed types
        lstm_cell_fwd(z, c.double())
    with pytest.raises(ValueError):               # no kernel for half
        lstm_cell_fwd(z.half(), c.half())


@pytest.mark.gpu
@pytest.mark.parametrize("name,dataset,L,V", [
    ("rnn", "fed_shakespeare", 80, 90),
    ("rnn_stackoverflow", "stackoverflow_nwp", 20, 10000)])
def test_lstms_through_the_kernels_match_the_cpu_path(cuda, name, dataset,
                                                      L, V):
    ds = DriftDataset(x=np.zeros((1, 1, 1, L), np.int32),
                      y=np.zeros((1, 1, 1), np.int32),
                      concepts=np.zeros((1, 1), np.int64), num_classes=V,
                      name=dataset, is_sequence=True)
    mod = create_model(name, ds, ExperimentConfig())
    params = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, V, (8, L), generator=gen, dtype=torch.int32)
    y = torch.randint(0, V, (8,), generator=gen)
    out = {}
    launches = lstm_cell_fwd.launches
    for dev in ("cuda", "cpu"):
        with model_numerics():
            flat = mod.pack(params).to(dev, torch.float64).requires_grad_()
            logits = mod(mod.unpack(flat), x.to(dev))
            grad, = torch.autograd.grad(cross_entropy(logits, y.to(dev)),
                                        flat)
        out[dev] = (logits.detach().cpu(), grad.cpu())
    assert lstm_cell_fwd.launches - launches == L * (2 if name == "rnn"
                                                     else 1)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel(got, want) <= F64_TOL
