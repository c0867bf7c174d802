"""The model pool: M models as one flat dict of ``[M, ...]`` tensors.

Counterpart of ``feddrift_tpu/core/pool.py::ModelPool``. Each leaf of
``params`` stacks the M models on a leading axis; ``slot(m)`` reads one
model out and ``set_slot`` writes one back. The module is functional
(``feddrift_torch.models.transformer``): it takes per-row parameters, so
``apply`` broadcasts one model's leaves over the batch rows and
``apply_rows`` takes rows already gathered (the serving step's path).
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
        B = x.shape[0]
        return self.module({k: p[None].expand(B, *p.shape)
                            for k, p in params.items()}, x)

    def apply_rows(self, rows: dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
        """Per-row params (leaves ``[B, ...]``) on ``x [B, ...]``."""
        return self.module(rows, x)

    def slot(self, m: int) -> dict[str, torch.Tensor]:
        return {k: p[m] for k, p in self.params.items()}

    def set_slot(self, m: int, new_params: dict[str, torch.Tensor]) -> None:
        """Write one model into slot ``m``, in place (the reference builds
        a new array; nothing here holds on to the old pool tensors)."""
        with torch.no_grad():
            for k, p in self.params.items():
                p[m].copy_(new_params[k])
