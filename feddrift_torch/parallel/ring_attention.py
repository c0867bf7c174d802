"""Blockwise (flash-style) attention as a plain torch loop.

Counterpart of ``feddrift_tpu/parallel/ring_attention.py::blockwise_attention``
(``lax.scan`` over key blocks with online softmax). It is the port's
``attention_impl="blockwise"`` and a second CPU reference for the flash
kernel. ``ring_attention`` (sequence sharded over devices) waits for the
multi-device slice.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, acc, m, l, q_off: int, k_off: int, causal: bool,
                scale: float, k_len: int | None = None):
    """One online-softmax accumulation step (reference ``_block_attn``)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    Lq, Lk = q.shape[2], k.shape[2]
    qpos = q_off + torch.arange(Lq, device=q.device)[:, None]
    kpos = k_off + torch.arange(Lk, device=q.device)[None, :]
    if causal:
        scores = scores.masked_fill(kpos > qpos, NEG_INF)
    if k_len is not None:
        scores = scores.masked_fill(kpos >= k_len, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                         p, v)
    return acc_new, m_new, l_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        block_size: int = 512) -> torch.Tensor:
    """Single-device attention ``[B, H, L, D]`` looping over key blocks."""
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    bs = min(block_size, L)
    acc = torch.zeros_like(q)
    m = torch.full((B, H, L), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, L), dtype=q.dtype, device=q.device)
    for k_off in range(0, L, bs):
        # the last block is short instead of padded; padded keys would be
        # masked to NEG_INF (exp -> 0) in the reference, which adds nothing
        acc, m, l = _block_attn(q, k[:, :, k_off:k_off + bs],
                                v[:, :, k_off:k_off + bs], acc, m, l,
                                q_off=0, k_off=k_off, causal=causal,
                                scale=scale, k_len=L)
    return acc / torch.clamp(l[..., None], min=1e-30)
