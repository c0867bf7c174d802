"""Debug-mode invariant checks (``cfg.debug_checks``).

Copy of ``feddrift_tpu/utils/invariants.py``'s ``check_round_inputs`` and
``check_weight_partition`` (numpy), and the port's counterpart of its
``enable_nan_debugging``: where the reference turns on ``jax_debug_nans``
so that a NaN raises in the program that produced it, the port checks the
outputs of each device program of a round for NaN right after the program
runs (``check_no_nan``; ``TrainStep(debug_nans=True)``): K1 with its
epilogue, K2's own launch, the K3 launches and K4. NaN only, as
``jax_debug_nans`` checks: an inf alone does not raise. A failed check
raises ``FloatingPointError`` naming the program. It costs one host sync
a program, and only when the checks are on.
"""

from __future__ import annotations

import numpy as np


class InvariantError(AssertionError):
    pass


def _fail(msg: str) -> None:
    raise InvariantError(msg)


def check_round_inputs(tw, sw, fm, *, num_models: int, num_clients: int,
                       num_steps_p1: int, sample_num: int) -> None:
    """Validate (time_w, sample_w, feat_mask) for one round/iteration.

    tw: [M, C, T1] — finite, nonnegative, at least one active (m, c) pair.
    sw: [M, C, N]  — finite, nonnegative.
    fm: [M, F...]  — finite.
    """
    tw = np.asarray(tw)
    sw = np.asarray(sw)
    fm = np.asarray(fm)
    M, C, T1, N = num_models, num_clients, num_steps_p1, sample_num
    if tw.shape != (M, C, T1):
        _fail(f"time_w shape {tw.shape} != {(M, C, T1)}")
    if sw.shape != (M, C, N):
        _fail(f"sample_w shape {sw.shape} != {(M, C, N)}")
    if fm.shape[0] != M:
        _fail(f"feat_mask leading axis {fm.shape[0]} != M={M}")
    for name, a in (("time_w", tw), ("sample_w", sw), ("feat_mask", fm)):
        if not np.isfinite(a).all():
            _fail(f"{name} contains non-finite values")
    if (tw < 0).any():
        _fail("time_w has negative weights")
    if (sw < 0).any():
        _fail("sample_w has negative weights")
    if tw.sum() == 0:
        _fail("time_w is all-zero: no (model, client) pair would train")


def check_weight_partition(weights_tmc: np.ndarray, t: int,
                           atol: float = 1e-5) -> None:
    """SoftCluster invariant: at step t the per-client weights over models
    sum to 1 (cluster assignment is a distribution)."""
    w = np.asarray(weights_tmc)[t]          # [M, C]
    col = w.sum(axis=0)
    if not np.allclose(col, 1.0, atol=atol):
        _fail(f"cluster weights at t={t} do not partition: {col}")


def check_no_nan(program: str, **outputs) -> None:
    """Raise ``FloatingPointError`` naming ``program`` if any floating
    tensor among ``outputs`` (name -> tensor, a dict of tensors, or None)
    holds a NaN. One host sync for all of them."""
    import torch
    names, flags = [], []
    for name, out in outputs.items():
        leaves = out.items() if isinstance(out, dict) else [(None, out)]
        for key, t in leaves:
            if t is None or not t.is_floating_point():
                continue
            names.append(name if key is None else f"{name}[{key}]")
            flags.append(torch.isnan(t).any())
    if not flags:
        return
    hit = torch.stack(flags).cpu().tolist()
    bad = [n for n, h in zip(names, hit) if h]
    if bad:
        raise FloatingPointError(
            f"debug_checks: invalid value (nan) in the outputs of the "
            f"{program} program: {', '.join(bad)}")
