"""CLIP text encoder (counterpart of the JAX package's
``models/sd/text_encoder.py``): SD-2.1's conditioning, the OpenCLIP-H text
tower (width 1024, 23 layers, 16 heads, GELU, causal mask, final
LayerNorm). DIFT feeds its last hidden state to the UNet's
cross-attention.

The causal mask is ``triu(-1e9)`` added to the float32 scores; GELU
follows the JAX package's rule (erf in float32, tanh in bfloat16).
Parameter names are the flax module names
(``convert.from_jax.sd_text_state_dict``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from midvision_probe_torch.models.sd.unet import attend
from midvision_probe_torch.ops.activations import gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    max_positions: int = 77
    layernorm_eps: float = 1e-5
    act: str = "gelu"


class _TextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        C, eps = cfg.hidden_size, cfg.layernorm_eps
        self.layer_norm1 = nn.LayerNorm(C, eps=eps)
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)
        self.layer_norm2 = nn.LayerNorm(C, eps=eps)
        self.fc1 = nn.Linear(C, C * 4)
        self.fc2 = nn.Linear(C * 4, C)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.cfg.num_heads
        h = self.layer_norm1(x)
        q, k, v = (p(h).reshape(B, N, H, C // H).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        o = attend(q, k, v, (C // H) ** -0.5, causal_mask)
        x = x + self.out_proj(o.transpose(1, 2).reshape(B, N, C))
        h = self.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.cfg.act == "quickgelu" else gelu(h)
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(c.max_positions, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"layers_{i}", _TextBlock(c))
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layernorm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, hidden) last hidden state."""
        N = input_ids.shape[1]
        x = self.token_embedding(input_ids.long()) + self.position_embedding[None, :N]
        causal = torch.triu(torch.full((N, N), -1e9, dtype=torch.float32,
                                       device=input_ids.device), diagonal=1)
        for i in range(self.cfg.num_layers):
            x = self._modules[f"layers_{i}"](x, causal)
        return self.final_layer_norm(x)
