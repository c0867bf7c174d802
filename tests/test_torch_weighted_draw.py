"""K4, the weighted draw (``kernels/weighted_draw.py``), against the JAX
package's ``weight_cdf`` + ``inverse_cdf_draw`` arithmetic on the CPU, and
its CUDA kernels (K4a ``weighted_cdf``, K4b ``weighted_search``) against
their plain versions on the card (``gpu``).

A round's client mask zeroes the unsampled clients' pair weights; the port
searches the cdf of the step's UNMASKED weights, with the round's masked
total weights choosing the uniform fallback, so the tests hold that to the
reference's rows for the masked weights.

Both packages get the same numpy weights and uniforms. The reference's
per-pair probabilities are built as ``TrainStep._local_sgd`` builds them
under ``weighted_sampling`` (``where(active, 1, 0) * w_t[:, None] *
s_n[None, :]``, uniform where they sum to 0), then ``weight_cdf`` and a
``searchsorted(side="right")`` clipped to the last row, which is
``inverse_cdf_draw`` with its uniforms handed over.

Tolerance. Integer weights (0/1 time weights times Poisson counts, KUE's):
every partial sum is exact in float32 in any order, so the rows are equal
bit for bit. Other weights: ``torch.cumsum``, XLA's cumsum and the
kernel's block scan round in other orders, so the cdf is held to 1e-6
relative, and a row may differ only where its uniform lies within that
distance of a cdf boundary (the count is printed).

JAX is imported inside the CPU tests, so the ``gpu`` tests run on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_weighted_draw.py``.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                  weighted_cdf_ref,
                                                  weighted_draw,
                                                  weighted_draw_ref,
                                                  weighted_search,
                                                  weighted_search_ref)
from torch_threads import one_intra_op_thread  # noqa: F401

CDF_RTOL = 1e-6


def _case(seed, M=3, C=4, T1=5, N=60, D=(3, 40), integer=True):
    rng = np.random.default_rng(seed)
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    tw[0, 1] = 0.0                              # an inactive pair
    sw = rng.poisson(1.0, (M, C, N)).astype(np.float32)
    sw[1, 2] = 0.0                              # active, all counts 0
    if not integer:
        tw *= rng.uniform(0.5, 3.0, tw.shape).astype(np.float32)
        sw *= rng.uniform(0.5, 2.0, sw.shape).astype(np.float32)
    u = rng.random((M, C, *D)).astype(np.float32)
    u[0, 0, 0, :3] = (0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5)
    return tw, sw, u


def _client_mask(C, off):
    """A round's client mask with the clients ``off`` left out: pair (m, c)
    of every model m for each c in ``off``."""
    mask = np.ones(C, np.float32)
    mask[list(off)] = 0.0
    return mask


def _reference(tw, sw, u):
    """The reference's rows and cdf of every pair, [M, C, *D] and
    [M, C, T1·N]."""
    import jax.numpy as jnp
    from feddrift_tpu.core.step import weight_cdf
    M, C, T1 = tw.shape
    rows = np.zeros(u.shape, np.int32)
    cdfs = np.zeros((M, C, T1 * sw.shape[-1]), np.float32)
    for m in range(M):
        for c in range(C):
            w_t, s_n = jnp.asarray(tw[m, c]), jnp.asarray(sw[m, c])
            active = w_t.sum() > 0
            probs = jnp.where(active, 1.0, 0.0) * (w_t[:, None] * s_n[None, :])
            probs = jnp.where(probs.sum() > 0, probs, jnp.ones_like(probs))
            cdf = weight_cdf(probs.reshape(-1))
            idx = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(
                u[m, c]).reshape(-1), side="right"), 0, cdf.shape[0] - 1)
            rows[m, c] = np.asarray(idx).reshape(u.shape[2:])
            cdfs[m, c] = np.asarray(cdf)
    return rows, cdfs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integer_weights_draw_the_references_rows(seed):
    tw, sw, u = _case(seed)
    want, want_cdf = _reference(tw, sw, u)
    t = [torch.from_numpy(a) for a in (tw, sw, u)]
    got = weighted_draw_ref(*t)
    assert got.dtype == torch.int32 and got.shape == u.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(weighted_cdf_ref(*t[:2]).numpy(), want_cdf)
    # a zero-weight row is never drawn
    p = (tw[..., :, None] * sw[..., None, :]).reshape(*tw.shape[:2], -1)
    live = p.sum(-1) > 0
    drawn = np.take_along_axis(p, got.numpy().reshape(*tw.shape[:2], -1),
                               -1)
    assert (drawn[live] > 0).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_non_integer_weights_within_the_rounding_rule(seed):
    tw, sw, u = _case(seed, integer=False, N=300, D=(5, 200))
    want, want_cdf = _reference(tw, sw, u)
    t = [torch.from_numpy(a) for a in (tw, sw, u)]
    cdf = weighted_cdf_ref(*t[:2]).numpy()
    np.testing.assert_allclose(cdf, want_cdf, rtol=CDF_RTOL, atol=0)
    got = weighted_draw_ref(*t).numpy()
    differ = got != want
    lo = np.minimum(got, want).reshape(*tw.shape[:2], -1)
    edge = np.take_along_axis(want_cdf, lo, -1).reshape(u.shape)
    near = np.abs(u - edge) <= CDF_RTOL * np.abs(edge)
    print(f"seed {seed}: {int(differ.sum())} of {u.size} rows differ, "
          f"all within {CDF_RTOL} of a boundary: {bool(near[differ].all())}")
    assert near[differ].all()


def test_uniform_fallback_is_the_references():
    """An inactive pair, and an active pair whose sample weights are all 0,
    draw uniformly over all ``T1·N`` rows, as the reference does before it
    masks the pair's result."""
    tw, sw, u = _case(5, D=(1, 2000))
    want, _ = _reference(tw, sw, u)
    got = weighted_draw_ref(*(torch.from_numpy(a) for a in (tw, sw, u)))
    L = tw.shape[-1] * sw.shape[-1]
    for m, c in ((0, 1), (1, 2)):
        assert np.array_equal(got[m, c].numpy(), want[m, c])
        rows = got[m, c].numpy().reshape(-1)
        assert rows.min() >= 0 and rows.max() <= L - 1
        expect = np.minimum((u[m, c].reshape(-1) * L).astype(np.int64), L - 1)
        assert np.abs(rows - expect).max() <= 1


@pytest.mark.parametrize("seed,off", [(0, (3,)), (1, (0, 2)), (2, (1,))])
def test_masked_search_draws_the_references_rows(seed, off):
    """The step's cdf of the unmasked weights, searched under a round's
    masked total weights, gives the reference's rows for the masked
    weights: a sampled pair's weights are its unmasked ones, and a pair
    the mask leaves out draws uniformly, as the reference's does."""
    tw, sw, u = _case(seed)
    masked = tw * _client_mask(tw.shape[1], off)[None, :, None]
    want, _ = _reference(masked, sw, u)
    t = [torch.from_numpy(a) for a in (tw, sw, u)]
    cdf = weighted_cdf_ref(*t[:2])
    got = weighted_search_ref(cdf, torch.from_numpy(masked).sum(-1), t[2])
    assert got.dtype == torch.int32 and got.shape == u.shape
    assert np.array_equal(got.numpy(), want)
    # unmasked, the same search is the one-call draw
    assert torch.equal(weighted_search_ref(cdf, t[0].sum(-1), t[2]),
                       weighted_draw_ref(*t))


def test_masked_search_keeps_the_fallback_pairs():
    """Under a mask: the inactive pair (0, 1) and the active pair with all
    counts 0 (1, 2) draw uniformly over all ``T1·N`` rows as the
    reference's do, and so do the left-out client's pairs."""
    tw, sw, u = _case(5, D=(1, 2000))
    off = (3,)
    masked = tw * _client_mask(tw.shape[1], off)[None, :, None]
    want, _ = _reference(masked, sw, u)
    t = [torch.from_numpy(a) for a in (tw, sw, u)]
    got = weighted_search_ref(weighted_cdf_ref(*t[:2]),
                              torch.from_numpy(masked).sum(-1), t[2]).numpy()
    L = tw.shape[-1] * sw.shape[-1]
    for m, c in ((0, 1), (1, 2)) + tuple((m, 3) for m in range(tw.shape[0])):
        assert np.array_equal(got[m, c], want[m, c])
        rows = got[m, c].reshape(-1)
        expect = np.minimum((u[m, c].reshape(-1) * L).astype(np.int64), L - 1)
        assert np.abs(rows - expect).max() <= 1


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    tw, sw, u = (torch.from_numpy(a) for a in _case(6))
    counts = (weighted_cdf.launches, weighted_search.launches,
              weighted_cdf_ref.cuda_calls, weighted_search_ref.cuda_calls)
    assert torch.equal(weighted_draw(tw, sw, u), weighted_draw_ref(tw, sw, u))
    cdf = weighted_cdf(tw, sw)
    assert torch.equal(cdf, weighted_cdf_ref(tw, sw))
    out = torch.full_like(cdf, -1.0)
    assert weighted_cdf(tw, sw, out=out) is out and torch.equal(out, cdf)
    total_w = tw.sum(-1) * torch.tensor([1.0, 0.0, 1.0, 1.0])
    assert torch.equal(weighted_search(cdf, total_w, u),
                       weighted_search_ref(cdf, total_w, u))
    assert (weighted_cdf.launches, weighted_search.launches,
            weighted_cdf_ref.cuda_calls,
            weighted_search_ref.cuda_calls) == counts


def test_rejects_mismatched_shapes():
    tw, sw, u = (torch.from_numpy(a) for a in _case(7))
    with pytest.raises(ValueError, match=r"time_w \[M, C, T1\]"):
        weighted_draw(tw[:2], sw, u)
    with pytest.raises(ValueError, match=r"sample_w \[M, C, N\]"):
        weighted_draw(tw, sw[..., None], u)
    with pytest.raises(ValueError, match=r"u \[M, C, \.\.\.\]"):
        weighted_draw(tw, sw, u[:2])


def test_search_rejects_mismatched_shapes():
    tw, sw, u = (torch.from_numpy(a) for a in _case(7))
    cdf = weighted_cdf(tw, sw)
    with pytest.raises(ValueError, match=r"cdf \[M, C, L\]"):
        weighted_search(cdf[0], tw.sum(-1), u)
    with pytest.raises(ValueError, match=r"total_w \[M, C\]"):
        weighted_search(cdf, tw.sum(-1)[:2], u)
    with pytest.raises(ValueError, match=r"u \[M, C, \.\.\.\]"):
        weighted_search(cdf, tw.sum(-1), u[:, :2])
    with pytest.raises(ValueError, match="out: want float32"):
        weighted_cdf(tw, sw, out=torch.empty(3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(cuda, seed, off=(3,), **kw):
    """A case on the card and a round's masked total weights."""
    tw, sw, u = (torch.from_numpy(a).to(cuda) for a in _case(seed, **kw))
    mask = torch.from_numpy(_client_mask(tw.shape[1], off)).to(cuda)
    return tw, sw, u, (tw * mask[None, :, None]).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("integer,shape", [
    (True, dict(M=4, C=10, T1=11, N=500, D=(5, 500))),   # KUE's canonical
    (True, dict(M=2, C=3, T1=3, N=7, D=(2, 9))),
    (True, dict(M=2, C=3, T1=20, N=2000, D=(5, 500))),   # 160 KB of cdf
    (True, dict(M=2, C=4, T1=3, N=333, D=(3, 1001))),    # unaligned rows
    (False, dict(M=4, C=10, T1=11, N=500, D=(5, 500)))])
def test_kernel_matches_plain(cuda, integer, shape):
    """K4a and K4b under a client mask. Integer weights: the cdf and rows
    bitwise; other weights: the cdf to 1e-6 relative and rows equal except
    within that distance of a boundary. Two calls agree bitwise, each
    launch is counted, and no plain version runs."""
    off = (3,) if shape["C"] > 3 else (1,)
    tw, sw, u, total_w = _on_card(cuda, 8, off, integer=integer, **shape)
    M, C = u.shape[:2]
    counts = (weighted_cdf.launches, weighted_search.launches,
              weighted_cdf_ref.cuda_calls, weighted_search_ref.cuda_calls)
    cdf = weighted_cdf(tw, sw)
    got = weighted_search(cdf, total_w, u)
    again = weighted_search(weighted_cdf(tw, sw), total_w, u)
    torch.cuda.synchronize()
    assert (weighted_cdf.launches, weighted_search.launches,
            weighted_cdf_ref.cuda_calls, weighted_search_ref.cuda_calls) == (
        counts[0] + 2, counts[1] + 2, counts[2], counts[3])
    assert torch.equal(got, again)
    want_cdf = weighted_cdf_ref(tw, sw)
    want = weighted_search_ref(want_cdf, total_w, u)
    if integer:
        assert torch.equal(got, want) and torch.equal(cdf, want_cdf)
        return
    assert ((cdf - want_cdf).abs() <= CDF_RTOL * want_cdf.abs()).all()
    assert torch.equal(weighted_search(want_cdf, total_w, u), want)
    differ = got != want
    lo = torch.minimum(got, want).reshape(M, C, -1).long()
    edge = want_cdf.gather(-1, lo).reshape(u.shape)
    assert ((u - edge).abs() <= CDF_RTOL * edge.abs())[differ].all()


@pytest.mark.gpu
def test_kernel_at_the_shared_memory_limit(cuda):
    """L = 57856 rows, the most a block stages, bitwise with masked pairs;
    one row more is refused by both kernels without a launch."""
    tw, sw, u, total_w = _on_card(cuda, 10, (1,), M=2, C=3, T1=4, N=14464,
                                  D=(2, 700))
    cdf = weighted_cdf(tw, sw)
    got = weighted_search(cdf, total_w, u)
    torch.cuda.synchronize()
    want_cdf = weighted_cdf_ref(tw, sw)
    assert torch.equal(cdf, want_cdf)
    assert torch.equal(got, weighted_search_ref(want_cdf, total_w, u))
    counts = (weighted_cdf.launches, weighted_search.launches)
    with pytest.raises(ValueError, match="shared memory"):
        weighted_cdf(torch.ones((1, 1, 1), device=cuda),
                     torch.ones((1, 1, 57857), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        weighted_search(torch.ones((1, 1, 57857), device=cuda),
                        torch.ones((1, 1), device=cuda),
                        torch.rand((1, 1, 4), device=cuda))
    assert (weighted_cdf.launches, weighted_search.launches) == counts


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
    """A CUDA tensor the kernels do not take raises; nothing falls back to
    a plain version."""
    tw, sw, u, total_w = _on_card(cuda, 9)
    plain = (weighted_cdf_ref.cuda_calls, weighted_search_ref.cuda_calls)
    with pytest.raises(ValueError, match="contiguous float32"):
        weighted_draw(tw.double(), sw, u)
    with pytest.raises(ValueError, match="contiguous float32"):
        weighted_draw(tw, sw, u.transpose(2, 3))
    cdf = weighted_cdf(tw, sw)
    with pytest.raises(ValueError, match="contiguous float32"):
        weighted_search(cdf, total_w.cpu(), u)
    with pytest.raises(ValueError, match="contiguous float32"):
        weighted_search(cdf.transpose(0, 1).contiguous().transpose(0, 1),
                        total_w, u)
    big = torch.ones((1, 1, 60000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        weighted_draw(torch.ones((1, 1, 1), device=cuda), big,
                      torch.rand((1, 1, 4), device=cuda))
    assert (weighted_cdf_ref.cuda_calls,
            weighted_search_ref.cuda_calls) == plain
