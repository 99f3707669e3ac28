"""ViLT-B/32 vision-language encoder + continual-learner heads.

Counterpart of ``feddat_tpu/models/vilt.py``:

* text embeddings = word + position + type, LayerNorm, dropout;
* patch embeddings = 32x32 conv on an NHWC canvas, CLS token, learned
  positions (a canvas smaller than the configured one takes the top-left
  sub-grid of the position table, vilt.py:142-150);
* with prompt tuning, reparameterized prompts spliced after each stream's
  CLS (``models/prompts.py``, vilt.py:235-246);
* modality-type embeddings (0 text, 1 image, 2 second image);
* ``num_layers`` pre-LN layers with the DAT adapter slot, as a ModuleList
  ``layers.<i>`` (flax stacks them with ``nn.scan`` under ``layers/layer``);
* final LayerNorm + tanh pooler on CLS; per-task heads ``task_<key>``.

Batches are dicts of tensors: ``input_ids``/``attention_mask`` [B, L],
``pixel_values`` [B, H, W, 3] (fp32 normalised, or raw uint8 normalised
here), ``pixel_mask`` [B, H, W] or the compact [B, 2] (valid h, valid w).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F

from feddat_tpu_torch.configs.core import ViltModelConfig
from feddat_tpu_torch.data.images import normalize_u8
from feddat_tpu_torch.models.adapters import dense
from feddat_tpu_torch.models.layers import (
    LayerNorm, PreLNLayer, check_attn_impl, dropout, patch_conv2d,
)
from feddat_tpu_torch.models.prompts import ReparamPrompt, splice_after_cls
from feddat_tpu_torch.ops.attention import mask_to_bias
from feddat_tpu_torch.ops.remat_policy import remat_call

_LOGITS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TaskHeadSpec:
    """What the reference reads from each task config to build a head."""

    num_labels: int
    num_images: int = 1
    model_type: str = "classification"
    num_choices: int = 1


def embed(ids: torch.Tensor, table: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Embed(dtype=...)``: the looked-up rows in ``dtype``."""
    return F.embedding(ids.long(), table.weight).to(dtype)


class ClassificationHead(nn.Module):
    """``Linear(d*num_images -> 2d) -> LayerNorm(eps 1e-5) -> GELU -> Linear(-> num_labels)``."""

    def __init__(self, in_features: int, encoder_dim: int, num_labels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.clf_fc0 = nn.Linear(in_features, encoder_dim * 2)
        self.clf_norm0 = LayerNorm(encoder_dim * 2, 1e-5, dtype)
        self.clf_fc1 = nn.Linear(encoder_dim * 2, num_labels)

    def forward(self, pooled: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = self.clf_norm0(dense(pooled, self.clf_fc0, self.dtype))
        return dense(F.gelu(h), self.clf_fc1, self.dtype)


class MultiChoiceHead(nn.Module):
    """``Dropout(0.1) -> Linear(d -> 1)``."""

    def __init__(self, encoder_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.clf_fc0 = nn.Linear(encoder_dim, 1)

    def forward(self, pooled: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return dense(dropout(pooled, 0.1, deterministic), self.clf_fc0, self.dtype)


class ViltTextEmbeddings(nn.Module):
    def __init__(self, c: ViltModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c = c
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_text_len, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, input_ids, token_type_ids, deterministic=True, inputs_embeds=None):
        """``inputs_embeds`` (ViLT-BERT): the word states come from the frozen
        BERT in place of the word table; positions, types and LN still apply
        (vilt.py:87-104)."""
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        words = (embed(input_ids, self.word_embeddings, self.dtype) if inputs_embeds is None
                 else inputs_embeds.to(self.dtype))
        x = (
            words
            + embed(positions, self.position_embeddings, self.dtype)
            + embed(token_type_ids, self.token_type_embeddings, self.dtype)
        )
        return dropout(self.norm(x), self.c.hidden_dropout, deterministic)


class ViltVisualEmbeddings(nn.Module):
    def __init__(self, c: ViltModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c = c
        self.dtype = dtype
        self.patch_projection = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, c.num_patches + 1, c.hidden_size))

    def forward(self, pixel_values, deterministic=True):
        c = self.c
        b, H, W, _ = pixel_values.shape
        if H % c.patch_size or W % c.patch_size:
            raise ValueError(f"canvas {(H, W)} is not a multiple of the patch size {c.patch_size}")
        conv = self.patch_projection
        patches = patch_conv2d(
            pixel_values.to(self.dtype).permute(0, 3, 1, 2),
            conv.weight.to(self.dtype), conv.bias.to(self.dtype), c.patch_size,
        )
        patches = patches.flatten(2).transpose(1, 2)  # [B, gh*gw, d], row-major grid
        pos = self.position_embeddings
        gh, gw = H // c.patch_size, W // c.patch_size
        ph, pw = c.image_size[0] // c.patch_size, c.image_size[1] // c.patch_size
        if (gh, gw) != (ph, pw):
            grid = pos[:, 1:].reshape(1, ph, pw, c.hidden_size)[:, :gh, :gw]
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, c.hidden_size)], dim=1)
        cls = self.cls_token.to(self.dtype).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, patches], dim=1) + pos.to(self.dtype)
        return dropout(x, c.hidden_dropout, deterministic)


class ViltEncoder(nn.Module):
    """The two-stream-concat ViLT transformer -> (sequence_output, pooled)."""

    def __init__(self, config: ViltModelConfig, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.attn_impl = check_attn_impl(attn_impl)
        self.text_embeddings = ViltTextEmbeddings(c, dtype)
        self.visual_embeddings = ViltVisualEmbeddings(c, dtype)
        if c.prompt.enabled:
            self.prompt_text = ReparamPrompt(c.prompt, c.hidden_size, dtype)
            self.prompt_vis = ReparamPrompt(c.prompt, c.hidden_size, dtype)
        self.modality_type_embeddings = nn.Embedding(c.modality_type_vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(
            PreLNLayer(
                c.hidden_size, c.num_heads, c.intermediate_size, c.adapter,
                dropout_rate=c.hidden_dropout, attention_dropout=c.attention_dropout,
                layer_norm_eps=c.layer_norm_eps, lora=c.lora, dtype=dtype,
                attn_impl=attn_impl, logits_dtype=_LOGITS_DTYPES[c.attention_logits_dtype],
                fuse_ln=c.fuse_ln, remat_attention=c.remat and c.remat_policy == "attention",
                remat_ln=c.remat and c.remat_policy == "min_save",
            )
            for _ in range(c.num_layers)
        )
        self.final_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.pooler = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, input_ids, attention_mask, token_type_ids=None, pixel_values=None,
                pixel_mask=None, image_token_type_idx: int = 1, adapter_mode: str = "none",
                deterministic: bool = True, adapter_weights=None, inputs_embeds=None):
        c = self.config
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        H, W = pixel_values.shape[1], pixel_values.shape[2]
        if pixel_mask is not None and pixel_mask.dim() == 2 and pixel_mask.shape[-1] == 2:
            # compact [B, 2] (valid_h, valid_w): rebuild the top-left rectangle
            ih = torch.arange(H, device=pixel_mask.device)[None, :, None]
            iw = torch.arange(W, device=pixel_mask.device)[None, None, :]
            pixel_mask = ((ih < pixel_mask[:, 0, None, None])
                          & (iw < pixel_mask[:, 1, None, None])).to(torch.int32)
        if pixel_values.dtype == torch.uint8:
            # raw-u8 path: normalise on the device; the canvas zero-pad is
            # reproduced by masking (u8 zeros would normalise to -1)
            x = normalize_u8(pixel_values, "vilt")
            if pixel_mask is not None:
                x = x * pixel_mask[..., None].to(x.dtype)
            pixel_values = x

        text = self.text_embeddings(input_ids, token_type_ids, deterministic, inputs_embeds)
        image = self.visual_embeddings(pixel_values, deterministic)

        b = image.shape[0]
        if pixel_mask is None:
            image_mask = torch.ones((b, image.shape[1]), dtype=attention_mask.dtype,
                                    device=image.device)
        else:
            ph, pw = pixel_mask.shape[1] // c.patch_size, pixel_mask.shape[2] // c.patch_size
            pm = pixel_mask.reshape(b, ph, c.patch_size, pw, c.patch_size).amax(dim=(2, 4))
            image_mask = torch.cat(
                [torch.ones((b, 1), dtype=attention_mask.dtype, device=image.device),
                 pm.reshape(b, -1).to(attention_mask.dtype)], dim=1)

        if c.prompt.enabled:
            text, attention_mask = splice_after_cls(text, attention_mask, self.prompt_text())
            image, image_mask = splice_after_cls(image, image_mask, self.prompt_vis())
            # only its shape feeds the modality-type lookup below
            input_ids = torch.zeros(text.shape[:2], dtype=input_ids.dtype, device=text.device)

        text = text + embed(torch.zeros_like(input_ids), self.modality_type_embeddings, self.dtype)
        img_type = torch.full(image.shape[:2], image_token_type_idx, dtype=torch.long,
                              device=image.device)
        image = image + embed(img_type, self.modality_type_embeddings, self.dtype)

        x = torch.cat([text, image], dim=1)
        bias = mask_to_bias(torch.cat([attention_mask, image_mask], dim=1), torch.float32)
        for layer in self.layers:
            x = self._layer(layer, x, bias, adapter_mode, deterministic, adapter_weights)
        x = self.final_norm(x)
        pooled = torch.tanh(dense(x[:, 0], self.pooler, self.dtype))
        return x, pooled

    def _layer(self, layer: PreLNLayer, x, bias, adapter_mode, deterministic, adapter_weights):
        """One layer, recomputed in the backward under ``remat`` (vilt.py:283-312)
        unless the whole-layer kernel takes this call: its backward keeps its
        own residuals, so remat would only discard them.  Eligibility is per
        call, as in JAX: a call that falls back keeps the configured remat."""
        whole = layer.takes_layer_kernel(x, bias, adapter_mode, deterministic, adapter_weights)
        return remat_call(layer, self.config.remat and not whole, self.config.remat_policy, True,
                          x, bias, adapter_mode, deterministic, adapter_weights, whole_layer=whole)


class ViltContinualLearner(nn.Module):
    """ViLT encoder + per-task heads; forward dispatches single-image,
    multi-image (NLVR2) and multi-choice (VCR) like the reference."""

    def __init__(self, config: ViltModelConfig, task_heads: Dict[str, TaskHeadSpec],
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.task_heads = dict(task_heads)
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.vilt = ViltEncoder(config, dtype, attn_impl)
        d = config.hidden_size
        for key, spec in self.task_heads.items():
            if spec.model_type == "classification":
                head = ClassificationHead(d * spec.num_images, d, spec.num_labels, dtype)
            else:
                head = MultiChoiceHead(d, dtype)
            self.add_module(f"task_{key}", head)

    def head(self, task_key: str) -> nn.Module:
        return getattr(self, f"task_{task_key}")

    def forward(self, task_key: str, batch: Dict[str, torch.Tensor],
                adapter_mode: str = "none", deterministic: bool = True):
        spec = self.task_heads[task_key]
        if spec.model_type == "multi-choice":
            return self.forward_multi_choice(task_key, batch, adapter_mode, deterministic)
        if spec.num_images == 1:
            return self.forward_single_image(task_key, batch, adapter_mode, deterministic)
        return self.forward_multi_images(task_key, batch, adapter_mode, deterministic)

    def encode_single_image(self, task_key, batch, adapter_mode="none", deterministic=True):
        """Encoder-only forward -> pooled [B, d] (vilt.py:414-429; the fused
        DAT step shares one ensemble encoder pass between its stages)."""
        _, pooled = self.vilt(
            batch["input_ids"], batch["attention_mask"], batch.get("token_type_ids"),
            batch["pixel_values"], batch.get("pixel_mask"), adapter_mode=adapter_mode,
            deterministic=deterministic, adapter_weights=batch.get("adapter_weights"),
        )
        return pooled

    def apply_head(self, task_key, pooled):
        """Head-only forward (vilt.py:431-433)."""
        return self.head(task_key)(pooled)

    def forward_single_image(self, task_key, batch, adapter_mode="none", deterministic=True):
        _, pooled = self.vilt(
            batch["input_ids"], batch["attention_mask"], batch.get("token_type_ids"),
            batch["pixel_values"], batch.get("pixel_mask"), adapter_mode=adapter_mode,
            deterministic=deterministic,
        )
        return pooled, self.head(task_key)(pooled)

    def forward_multi_images(self, task_key, batch, adapter_mode="none", deterministic=True):
        """``pixel_values`` [B, num_images, H, W, C]: one pass per image with
        ``image_token_type_idx = i + 1``, pooled outputs concatenated."""
        spec = self.task_heads[task_key]
        mask = batch.get("pixel_mask")
        pooled = torch.cat([
            self.vilt(
                batch["input_ids"], batch["attention_mask"], batch.get("token_type_ids"),
                batch["pixel_values"][:, i], None if mask is None else mask[:, i],
                image_token_type_idx=i + 1, adapter_mode=adapter_mode,
                deterministic=deterministic,
            )[1]
            for i in range(spec.num_images)
        ], dim=-1)
        return pooled, self.head(task_key)(pooled)

    def forward_multi_choice(self, task_key, batch, adapter_mode="none", deterministic=True):
        """``input_ids`` [B, C, L]: one pass per text choice against the same image."""
        spec = self.task_heads[task_key]
        tt = batch.get("token_type_ids")
        pooled = torch.stack([
            self.vilt(
                batch["input_ids"][:, i], batch["attention_mask"][:, i],
                None if tt is None else tt[:, i], batch["pixel_values"],
                batch.get("pixel_mask"), adapter_mode=adapter_mode,
                deterministic=deterministic,
            )[1]
            for i in range(spec.num_choices)
        ], dim=1)
        logits = self.head(task_key)(pooled, deterministic=deterministic)
        return pooled, logits.squeeze(-1)


def init_vilt_params(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every parameter in place, as the JAX package does: normal
    kernels and embeddings (std 0.02, ``initializer_range`` where JAX uses
    it), zero biases, unit LayerNorm scales, zero CLS token and position
    table, LoRA A uniform(±1/sqrt(fan_in)) and LoRA B zero, and the prompt
    MLPs' torch defaults (embedding N(0, 1), Linear weights and biases
    uniform(±1/sqrt(fan_in)), prompts.py:33-44).  Draws on the CPU
    from a ``torch.Generator`` seeded with ``seed`` in parameter order, so a
    seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    init_range = getattr(getattr(model, "config", None), "initializer_range", 0.02)
    embed_prefixes = ("vilt.text_embeddings", "vilt.visual_embeddings",
                      "vilt.modality_type_embeddings", "vilt.pooler")
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            for p_name, p in mod.named_parameters(recurse=False):
                full = f"{mod_name}.{p_name}" if mod_name else p_name
                if ".prompt_" in f".{mod_name}":
                    if isinstance(mod, nn.Embedding):
                        val = torch.randn(p.shape, generator=gen)
                    else:
                        bound = mod.in_features ** -0.5
                        val = torch.rand(p.shape, generator=gen) * (2 * bound) - bound
                elif isinstance(mod, LayerNorm):
                    val = torch.ones(p.shape) if p_name == "weight" else torch.zeros(p.shape)
                elif p_name == "bias" or p_name in ("cls_token", "position_embeddings", "pos_embed"):
                    val = torch.zeros(p.shape)
                elif mod_name.endswith("lora_b"):
                    val = torch.zeros(p.shape)
                elif mod_name.endswith("lora_a"):
                    bound = p.shape[1] ** -0.5
                    val = torch.rand(p.shape, generator=gen) * (2 * bound) - bound
                else:
                    std = init_range if full.startswith(embed_prefixes) else 0.02
                    val = torch.randn(p.shape, generator=gen) * std
                p.copy_(val)
    return model
