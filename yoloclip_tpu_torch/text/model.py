"""CLIP ViT-B/32 text transformer. Counterpart of `yoloclip_tpu/text/model.py`.

Token + positional embeddings, pre-LN residual attention blocks with
QuickGELU MLPs under the causal `triu(-inf, k=1)` mask, final LayerNorm,
features gathered at the EOT position (the highest token id of each row),
then the text projection. Full width: 12 layers, width 512, 8 heads, 77
positions, 49408 tokens, 512-d output, about 63M parameters.

Module and parameter names are the OpenAI checkpoint's
(`token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection`),
so an OpenAI text-tower state dict loads with strict=True. The products are
plain `F.linear`/`torch.matmul`, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.models.layers import MultiHeadAttention


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed in fp32 and cast back to the input's
    dtype, as flax's LayerNorm with fp32 statistics does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiHeadAttention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ('c_fc', nn.Linear(width, 4 * width)),
            ('gelu', QuickGELU()),
            ('c_proj', nn.Linear(4 * width, width))]))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, attn_mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor
                ) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, attn_mask)
        return x


class CLIPTextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 output_dim: int = 512):
        super().__init__()
        self.vocab_size, self.context_length = vocab_size, context_length
        self.width, self.layers, self.heads = width, layers, heads
        self.output_dim = output_dim
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(
            width ** -0.5 * torch.randn(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, context_length) int -> (B, output_dim) fp32 features,
        unnormalised (callers L2-normalise), computed in the dtype of the
        module's parameters."""
        dt = self.text_projection.dtype
        x = self.token_embedding(tokens) + self.positional_embedding
        L = self.context_length
        causal = torch.full((L, L), float('-inf'), device=x.device).triu(1)
        x = self.ln_final(self.transformer(x.to(dt), causal))
        eot = tokens.argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        return (feats @ self.text_projection).float()


def init_text_weights(model: CLIPTextTransformer,
                      generator: torch.Generator) -> None:
    """Random init from an explicit generator, with the JAX tower's scales:
    token embedding N(0, 0.02), positions N(0, 0.01), projection
    N(0, width^-0.5), lecun-normal MLP weights, xavier-uniform attention
    projections, zero biases, identity LayerNorms."""
    with torch.no_grad():
        model.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        model.positional_embedding.normal_(0.0, 0.01, generator=generator)
        model.text_projection.normal_(0.0, model.width ** -0.5,
                                      generator=generator)
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                for w in (m.in_proj_weight, m.out_proj.weight):
                    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.uniform_(-bound, bound, generator=generator)
                m.in_proj_bias.zero_()
                m.out_proj.bias.zero_()
            elif isinstance(m, ResidualAttentionBlock):
                for lin in (m.mlp.c_fc, m.mlp.c_proj):
                    lin.weight.normal_(0.0, lin.in_features ** -0.5,
                                       generator=generator)
                    lin.bias.zero_()
