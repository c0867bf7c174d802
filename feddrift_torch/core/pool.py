"""The model pool: M models as one flat dict of ``[M, ...]`` tensors.

Counterpart of ``feddrift_tpu/core/pool.py::ModelPool``. Each leaf of
``params`` stacks the M models on a leading axis; ``slot(m)`` reads one
model out and ``set_slot`` writes one back. The module is functional
(``feddrift_torch.models``): ``apply`` runs one model's leaves on a
batch and ``apply_rows`` rows already gathered (the serving step's path),
each through the module's own ``apply_one`` / ``apply_rows``
(``models/base.py``). The example input is a sample batch ``[2,
*feature_shape]``: an image dataset's rows keep their ``H, W, C`` shape.
The edits a training algorithm makes (``reinit_slot``,
``distinct_reinit_slot``, ``copy_slot``, ``merge_slots``) rebuild the
dict, as the reference rebinds its pytree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class ModelPool:
    module: Any                         # functional module (init_params/forward)
    params: dict[str, torch.Tensor]     # leaves [M, ...]
    init_params: dict[str, torch.Tensor]  # one model: the deterministic reinit target
    num_models: int
    example_input: Any = None           # sample batch used for (re)initialisation

    @classmethod
    def create(cls, module, sample_input, num_models: int, seed: int = 42,
               identical: bool = True,
               device: str | torch.device = "cuda") -> "ModelPool":
        """Initialise the pool on ``device`` from a ``torch.Generator``
        seeded with ``seed``.

        ``identical=True`` is the reference start-up: every slot holds the
        same params. ``identical=False`` draws each slot afresh (IFCA's
        distinct init), so routing to another slot changes the answer.
        torch's generator is not JAX's, so the numbers differ from the
        reference's for the same seed; the distributions are the same.
        """
        gen = torch.Generator().manual_seed(seed)
        init_params = module.init_params(gen, device)
        if identical:
            params = {k: p[None].expand(num_models, *p.shape).clone()
                      for k, p in init_params.items()}
        else:
            draws = [module.init_params(gen, device)
                     for _ in range(num_models)]
            params = {k: torch.stack([d[k] for d in draws])
                      for k in init_params}
        return cls(module=module, params=params, init_params=init_params,
                   num_models=num_models, example_input=sample_input)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def apply(self, params: dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """One model's params (no row axis) on a batch ``x [B, ...]``."""
        return self.module.apply_one(params, x)

    def apply_rows(self, rows: dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
        """Per-row params (leaves ``[B, ...]``) on ``x [B, ...]``."""
        return self.module.apply_rows(rows, x)

    def slot(self, m: int) -> dict[str, torch.Tensor]:
        return {k: p[m] for k, p in self.params.items()}

    def set_slot(self, m: int, new_params: dict[str, torch.Tensor]) -> None:
        """Write one model into slot ``m``, in place (the reference builds
        a new array; nothing here holds on to the old pool tensors)."""
        with torch.no_grad():
            for k, p in self.params.items():
                p[m].copy_(new_params[k])

    # The pool edits a training algorithm makes. Each builds a NEW params
    # dict, as the reference rebinds its pytree: a cache keyed on the
    # identity of ``params`` (DriftAlgorithm.offer_acc_matrix) must miss
    # after any of them, and nobody holding the old dict sees it change.
    def _with_slot(self, m: int, values: dict[str, torch.Tensor]) -> None:
        new = {k: p.clone() for k, p in self.params.items()}
        with torch.no_grad():
            for k, p in new.items():
                p[m] = values[k]
        self.params = new

    def reinit_slot(self, m: int) -> None:
        """Deterministic reinit: the stored ``init_params`` (reference
        reinitialize, model/utils.py:20-24)."""
        self._with_slot(m, self.init_params)

    def distinct_reinit_slot(self, m: int, seed: int) -> None:
        """Fresh random params from ``seed`` (IFCA symmetry breaking)."""
        gen = torch.Generator().manual_seed(seed)
        self._with_slot(m, self.module.init_params(gen, self.device))

    def copy_slot(self, dst: int, src: int) -> None:
        """dst := src (LRU reuse starts from the drifted client's model)."""
        self._with_slot(dst, self.slot(src))

    def merge_slots(self, base: int, second: int, w1: float,
                    w2: float) -> None:
        """base := w1*base + w2*second; second := deterministic reinit
        (FedDrift merge, FedAvgEnsDataLoader.py:1059-1066)."""
        self._with_slot(base, {k: w1 * p[base] + w2 * p[second]
                               for k, p in self.params.items()})
        self.reinit_slot(second)
