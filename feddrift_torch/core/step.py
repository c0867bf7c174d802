"""Forward-only serving step over the ``[M, ...]`` model pool.

Counterpart of ``feddrift_tpu/core/step.py::ForwardStep`` (:905-960). One
call answers a whole micro-batch whose rows may target DIFFERENT models of
the pool: each row's parameters are gathered out of the pool by its model
index and the batch runs as ONE forward over per-row weights. The
reference ``vmap``s a single-row apply over the gathered rows; here the row
axis is written out in the module (``torch.bmm`` per Dense layer, one
attention call on ``[B, H, L, D]``).

float32 matmuls must stay float32 on the card, as in the reference:
``torch.backends.cuda.matmul.allow_tf32`` is False by default and the
callers that time or check this step (``chip_smoke.py``) set it so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(eq=False)
class ForwardStep:
    apply_rows: Callable    # (per-row params [B, ...], x [B, ...]) -> logits

    @torch.no_grad()
    def forward(self, params: dict[str, torch.Tensor], x: torch.Tensor,
                model_idx: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, K]`` for ``x [B, ...]`` routed by ``model_idx [B]``
        into ``params [M, ...]``."""
        idx = model_idx.to(device=x.device, dtype=torch.long)
        rows = {k: p.index_select(0, idx) for k, p in params.items()}
        return self.apply_rows(rows, x)
