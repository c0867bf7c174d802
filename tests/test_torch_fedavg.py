"""K2, the masked FedAvg (``kernels/fedavg.py``), against the JAX package's
``robust_agg.aggregate("mean", ...)`` on the CPU, and its CUDA kernel
against the plain version on the card (``gpu``).

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

from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
from feddrift_torch.resilience.robust_agg import agg_mean

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
