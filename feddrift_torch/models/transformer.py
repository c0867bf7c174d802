"""Decoder-only Transformer LM over per-row weights.

Counterpart of ``feddrift_tpu/models/transformer.py`` (flax). The modules
are functional, like flax's: they hold hyperparameters, and ``forward``
takes the parameters as a flat dict keyed by the flax tree path
(``"block_0/MultiHeadAttention_0/qkv/kernel"``), so a JAX pool converts
across by name (``feddrift_torch.convert``). Every leaf carries a leading
ROW axis: row ``b`` of the batch is computed with its own weights. That is
how one forward serves a micro-batch whose rows belong to different models
of the pool: the reference ``vmap``s the apply over gathered params, here
the batch axis is written out and the Dense layers are per-row products
``[B, L, in] @ [B, in, out]`` (``kernels/dense_rows.py``: a kernel whose
tiles do not depend on B on the card, so a row's answer does not depend on
its batch; ``torch.bmm`` on the CPU).

Numerics follow flax: Dense kernels are ``[in, out]``, LayerNorm eps is
1e-6, ``gelu`` is the tanh approximation, and an embedding id outside
``[-n, n)`` gives a NaN row while negative ids wrap (``jnp.take``'s fill
mode). Sequence parallelism (``seq_axis``/ring attention) and remat are
not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from feddrift_torch.kernels.dense_rows import dense_rows
from feddrift_torch.kernels.flash_attention import flash_attention
from feddrift_torch.models.base import Functional as _Functional
from feddrift_torch.models.base import Params
from feddrift_torch.parallel.ring_attention import blockwise_attention

ATTENTION_IMPLS = ("auto", "flash", "blockwise")
LN_EPS = 1e-6                       # flax LayerNorm default


def _scope(params: Params, prefix: str) -> Params:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def dense(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """Per-row Dense: x ``[B, L, in]`` with kernel ``[B, in, out]`` (and
    bias ``[B, out]`` when the layer has one, added in the kernel)."""
    return dense_rows(x, params[f"{name}/kernel"], params.get(f"{name}/bias"))


def layer_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    y = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return y * params[f"{name}/scale"][:, None, :] \
        + params[f"{name}/bias"][:, None, :]


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-row lookup: table ``[B, n, E]``, ids ``[B, L]`` -> ``[B, L, E]``,
    with ``jnp.take``'s treatment of ids outside ``[0, n)``."""
    n = table.shape[1]
    ids = ids.long()
    valid = (ids >= -n) & (ids < n)
    idx = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    out = table[rows, idx]
    return torch.where(valid[..., None], out,
                       torch.full((), float("nan"), dtype=out.dtype,
                                  device=out.device))


class MultiHeadAttention(_Functional):
    def __init__(self, d_model: int, num_heads: int, causal: bool = True,
                 attention_impl: str = "auto") -> None:
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be auto|flash|blockwise, "
                             f"got {attention_impl!r}")
        self.d_model, self.num_heads = d_model, num_heads
        self.causal, self.attention_impl = causal, attention_impl

    def param_specs(self):
        E = self.d_model
        return {"qkv/kernel": ((E, 3 * E), "lecun_normal"),
                "proj/kernel": ((E, E), "lecun_normal")}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        H = self.num_heads
        D = E // H
        # views of the one qkv projection; the kernel reads them strided
        # and returns a transpose view of [B, L, H, D], so the reshape of
        # its output back to [B, L, E] is a view as well
        q, k, v = (t.view(B, L, H, D).transpose(1, 2)
                   for t in dense(x, params, "qkv").split(E, dim=-1))
        impl = self.attention_impl
        if impl == "auto":
            impl = "flash" if x.is_cuda else "blockwise"
        if impl == "flash":
            out = flash_attention(q, k, v, self.causal)
        else:
            out = blockwise_attention(q, k, v, causal=self.causal)
        out = out.transpose(1, 2).reshape(B, L, E)
        return dense(out, params, "proj")


class Block(_Functional):
    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4,
                 attention_impl: str = "auto") -> None:
        super().__init__()
        self.d_model, self.mlp_ratio = d_model, mlp_ratio
        self.attn = MultiHeadAttention(d_model, num_heads,
                                       attention_impl=attention_impl)

    def param_specs(self):
        E, F_ = self.d_model, self.mlp_ratio * self.d_model
        specs = {f"MultiHeadAttention_0/{k}": v
                 for k, v in self.attn.param_specs().items()}
        for i in (0, 1):
            specs[f"LayerNorm_{i}/scale"] = ((E,), "ones")
            specs[f"LayerNorm_{i}/bias"] = ((E,), "zeros")
        specs.update({"Dense_0/kernel": ((E, F_), "lecun_normal"),
                      "Dense_0/bias": ((F_,), "zeros"),
                      "Dense_1/kernel": ((F_, E), "lecun_normal"),
                      "Dense_1/bias": ((E,), "zeros")})
        return specs

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(_scope(params, "MultiHeadAttention_0"),
                      layer_norm(x, params, "LayerNorm_0"))
        x = x + h
        y = layer_norm(x, params, "LayerNorm_1")
        y = F.gelu(dense(y, params, "Dense_0"), approximate="tanh")
        return x + dense(y, params, "Dense_1")


class TransformerLM(_Functional):
    """Next-token LM: tokens ``[B, L]`` -> last-position logits ``[B, V]``
    (the reference's ``last_only=True`` contract, shared with CharLSTM)."""

    def __init__(self, vocab_size: int = 90, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 4096,
                 attention_impl: str = "auto") -> None:
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.num_heads, self.max_len = num_heads, max_len
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, attention_impl=attention_impl)
            for _ in range(num_layers))

    def param_specs(self):
        V, E = self.vocab_size, self.d_model
        specs = {"tok_embed/embedding": ((V, E), "embed"),
                 "pos_embed/embedding": ((self.max_len, E), "embed")}
        for i, blk in enumerate(self.blocks):
            specs.update({f"block_{i}/{k}": v
                          for k, v in blk.param_specs().items()})
        specs.update({"LayerNorm_0/scale": ((E,), "ones"),
                      "LayerNorm_0/bias": ((E,), "zeros"),
                      "lm_head/kernel": ((E, V), "lecun_normal"),
                      "lm_head/bias": ((V,), "zeros")})
        return specs

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        x = embed(params["tok_embed/embedding"], tokens)
        pos = torch.arange(L, device=tokens.device).expand(B, L)
        x = x + embed(params["pos_embed/embedding"], pos)
        for i, blk in enumerate(self.blocks):
            x = blk(_scope(params, f"block_{i}"), x)
        # LayerNorm is per position, so normalising only the last one
        # equals the reference's LayerNorm-then-slice
        x = layer_norm(x[:, -1:], params, "LayerNorm_0")
        return dense(x, params, "lm_head")[:, 0]
