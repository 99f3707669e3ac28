"""ViT-B/16 visual encoder for ALBEF.

Counterpart of ``feddat_tpu/models/vit.py``: raw-u8 pixels CLIP-normalised on
the device, a 16x16 patch conv on the NHWC image, a zero-initialised CLS token
and position table, ``vision_layers`` pre-LN blocks (``PreLNLayer``, eps
1e-6, the DAT adapter slot after the MLP residual) as a ModuleList
``blocks.<i>`` (flax stacks them with ``nn.scan`` under ``blocks/block``),
and a final LayerNorm.  ``cfg.remat`` recomputes each block in the backward
with ``cfg.remat_policy`` (no structural policies), except on ``"layer"``.
"""

from __future__ import annotations

import torch
from torch import nn

from feddat_tpu_torch.configs.core import AlbefModelConfig
from feddat_tpu_torch.data.images import normalize_u8
from feddat_tpu_torch.models import DTYPES
from feddat_tpu_torch.models.layers import LayerNorm, PreLNLayer, check_attn_impl, patch_conv2d
from feddat_tpu_torch.ops.remat_policy import remat_call


class VisionTransformer(nn.Module):
    def __init__(self, cfg: AlbefModelConfig, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        c = cfg
        self.cfg = c
        self.dtype = dtype
        self.attn_impl = check_attn_impl(attn_impl)
        n = (c.image_res // c.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, c.vision_width, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.vision_width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, c.vision_width))
        self.blocks = nn.ModuleList(
            PreLNLayer(
                c.vision_width, c.vision_heads, int(c.vision_width * c.vision_mlp_ratio), c.adapter,
                dropout_rate=0.0, attention_dropout=0.0, layer_norm_eps=c.vision_layer_norm_eps,
                lora=c.lora, dtype=dtype, attn_impl=attn_impl,
                logits_dtype=DTYPES[c.attention_logits_dtype], fuse_ln=c.fuse_ln,
            )
            for _ in range(c.vision_layers)
        )
        self.final_norm = LayerNorm(c.vision_width, c.vision_layer_norm_eps, dtype)

    def forward(self, pixel_values: torch.Tensor, adapter_mode: str = "none",
                deterministic: bool = True) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (u8, or fp32 normalised) -> token states [B, 1+N, D]."""
        c = self.cfg
        b = pixel_values.shape[0]
        if pixel_values.dtype == torch.uint8:
            # raw-u8 path: CLIP normalisation on the device (no canvas pad to mask)
            pixel_values = normalize_u8(pixel_values, "clip")
        conv = self.patch_embed
        x = patch_conv2d(pixel_values.to(self.dtype).permute(0, 3, 1, 2), conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), c.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, D], row-major grid
        cls = self.cls_token.to(self.dtype).expand(b, 1, c.vision_width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            # remat per block (vit.py:72-91), except on "layer": the
            # whole-layer kernel's backward keeps its own residuals
            x = remat_call(block, c.remat and self.attn_impl != "layer", c.remat_policy, False,
                           x, None, adapter_mode, deterministic)
        return self.final_norm(x)
