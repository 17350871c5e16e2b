"""Shared transformer building blocks (counterpart of
``llm_bci_tpu/models/layers.py``).

``TorchEncoderLayer`` / ``TorchEncoderStack`` compute what the JAX package's
flax re-implementation of ``nn.TransformerEncoder`` computes, which is not
what ``torch.nn.TransformerEncoderLayer`` computes: dropout falls on the
attention *context* before ``out_proj`` and again on the attention block's
output (torch's ``MultiheadAttention`` drops the probabilities instead), and
every LayerNorm has flax's epsilon, 1e-6 (torch's default is 1e-5). So the
port builds its own modules; torch's layer (and its eval fast path) is not
used. Attention is :func:`llm_bci_tpu_torch.ops.attention.dot_product_attention`,
the counterpart of the JAX package's default ``"xla"`` path. Dropout draws
from the ``generator`` passed in.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from llm_bci_tpu_torch.ops.attention import dot_product_attention, dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class MultiHeadSelfAttention(nn.Module):
    """Fused ``qkv`` projection, attention, dropout on the context, then
    ``out_proj``."""

    def __init__(self, hidden_size: int, n_heads: int, dropout: float = 0.0,
                 use_bias: bool = True):
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=use_bias)
        self.out_proj = nn.Linear(hidden_size, hidden_size, bias=use_bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, H = x.shape
        shape = (B, T, self.n_heads, H // self.n_heads)
        q, k, v = (t.reshape(shape) for t in self.qkv(x).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, mask=mask).reshape(B, T, H)
        out = dropout(out, self.dropout, self.training, generator)
        return self.out_proj(out)


class TorchEncoderLayer(nn.Module):
    """Post-LN block: ``x = LN(x + drop(attn(x))); x = LN(x + drop(ffn(x)))``,
    the FFN ``ffn_mult`` times wide with dropout after its activation."""

    def __init__(self, hidden_size: int, n_heads: int, act: Callable, dropout: float = 0.0,
                 ffn_mult: int = 4):
        super().__init__()
        self.act = act
        self.dropout = dropout
        self.attn = MultiHeadSelfAttention(hidden_size, n_heads, dropout)
        self.norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.linear1 = nn.Linear(hidden_size, ffn_mult * hidden_size)
        self.linear2 = nn.Linear(ffn_mult * hidden_size, hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout, self.training, generator)
        x = self.norm1(x + drop(self.attn(x, mask, generator)))
        h = self.linear2(drop(self.act(self.linear1(x))))
        return self.norm2(x + drop(h))


class TorchEncoderStack(nn.Module):
    """``n_layers`` post-LN layers and a final LayerNorm."""

    def __init__(self, hidden_size: int, n_heads: int, n_layers: int, act: Callable,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchEncoderLayer(hidden_size, n_heads, act, dropout) for _ in range(n_layers)
        )
        self.norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask, generator)
        return self.norm(x)


class MLPStack(nn.Module):
    """torchvision-style MLP: Linear -> act -> dropout for each hidden layer,
    the last Linear followed by dropout only."""

    def __init__(self, in_features: int, hidden_channels: Sequence[int], act: Callable,
                 dropout: float = 0.0, use_bias: bool = True):
        super().__init__()
        widths = [in_features, *hidden_channels]
        self.dense = nn.ModuleList(
            nn.Linear(a, b, bias=use_bias) for a, b in zip(widths[:-1], widths[1:])
        )
        self.act = act
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i < len(self.dense) - 1:
                x = self.act(x)
            x = dropout(x, self.dropout, self.training, generator)
        return x
