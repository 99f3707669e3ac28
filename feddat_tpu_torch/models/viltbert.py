"""ViLT-BERT: ViLT whose text stream is embedded by a frozen BERT
(counterpart of ``feddat_tpu/models/viltbert.py``).

The reference (``src/modeling/viltbert.py:31-585``) runs a standard 12-layer
BERT over the text with gradients stopped (``get_bert_outputs`` under
``no_grad``, ``viltbert.py:115-120``); its last hidden states feed the ViLT
encoder as ``inputs_embeds`` (``viltbert.py:122-138``), so the ViLT text
embeddings keep positions, types and LayerNorm but have no word table.
Adapters attach to the ViLT half only.

The BERT is frozen twice over, as in JAX: its parameters carry the roles
their names give (``text_bert.*``: backbone, norm and bias, never an adapter
or head role, so no DAT or adapter step trains them), and it runs under
``torch.no_grad()``, the counterpart of ``stop_gradient``, so even FULL mode
gives it an exactly zero gradient.  Its dropout (0.1, live when the forward
is not deterministic) draws from the dropout generator of the call
(``utils/seeding.py``).  It runs on the composable attention route
(``attn_impl="auto"``) whatever the ViLT half's route, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from feddat_tpu_torch.configs.core import AlbefBertConfig, ViltModelConfig
from feddat_tpu_torch.models.vilt import ViltContinualLearner
from feddat_tpu_torch.models.xbert import XBertModel


def _text_bert_config(cfg: ViltModelConfig) -> AlbefBertConfig:
    """Pure-text BERT (``fusion_layer == num_layers``: no cross-attention).
    Dropout is bert-base-uncased's 0.1, not ViLT's 0.0: the reference builds
    this half with ``BertModel.from_pretrained('bert-base-uncased')``
    (``viltbert.py:509``), and ``torch.no_grad()`` does not turn dropout off."""
    return AlbefBertConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=max(cfg.max_text_len, 512),
        hidden_dropout=0.1,
        attention_dropout=0.1,
        layer_norm_eps=cfg.layer_norm_eps,
        fusion_layer=cfg.num_layers,
    )


def _squash(x, rank):
    """A multi-choice [B, C, L] or multi-image [B, N, H, W, C] input -> its
    first slice (``init_all``)."""
    if x is None:
        return None
    return x[:, 0] if x.dim() > rank else x


class ViltBertContinualLearner(ViltContinualLearner):
    """``ViltContinualLearner``'s heads and dispatch; the text states come
    from ``text_bert``."""

    def __init__(self, config: ViltModelConfig, task_heads, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__(config, task_heads, dtype, attn_impl)
        # the word states come from the BERT: JAX's tree has no word table
        del self.vilt.text_embeddings.word_embeddings
        self.text_bert = XBertModel(_text_bert_config(config), dtype=dtype)

    def _bert_embeds(self, input_ids, attention_mask, deterministic):
        """The frozen BERT's text states (``viltbert.py:115-120``)."""
        with torch.no_grad():
            return self.text_bert(input_ids, attention_mask, mode="multi_modal",
                                  deterministic=deterministic)

    def _encode(self, ids, mask, token_type_ids, pixel_values, pixel_mask, adapter_mode,
                deterministic, adapter_weights=None):
        """One image, one text: the BERT's states into ViLT -> pooled."""
        embeds = self._bert_embeds(ids, mask, deterministic)
        return self.vilt(ids, mask, token_type_ids, pixel_values, pixel_mask,
                         adapter_mode=adapter_mode, deterministic=deterministic,
                         adapter_weights=adapter_weights, inputs_embeds=embeds)[1]

    def encode_single_image(self, task_key, batch, adapter_mode="none", deterministic=True):
        """Encoder-only forward (the fused and joint DAT steps), the text
        through the frozen BERT as in the full forward."""
        return self._encode(batch["input_ids"], batch["attention_mask"],
                            batch.get("token_type_ids"), batch["pixel_values"],
                            batch.get("pixel_mask"), adapter_mode, deterministic,
                            adapter_weights=batch.get("adapter_weights"))

    def forward_single_image(self, task_key, batch, adapter_mode="none", deterministic=True):
        pooled = self._encode(batch["input_ids"], batch["attention_mask"],
                              batch.get("token_type_ids"), batch["pixel_values"],
                              batch.get("pixel_mask"), adapter_mode, deterministic)
        return pooled, self.head(task_key)(pooled)

    def forward_multi_images(self, task_key, batch, adapter_mode="none", deterministic=True):
        """One BERT pass for the text, then one ViLT pass per image with
        ``image_token_type_idx = i + 1``, pooled outputs concatenated."""
        spec = self.task_heads[task_key]
        mask = batch.get("pixel_mask")
        embeds = self._bert_embeds(batch["input_ids"], batch["attention_mask"], deterministic)
        pooled = torch.cat([
            self.vilt(
                batch["input_ids"], batch["attention_mask"], batch.get("token_type_ids"),
                batch["pixel_values"][:, i], None if mask is None else mask[:, i],
                image_token_type_idx=i + 1, adapter_mode=adapter_mode,
                deterministic=deterministic, inputs_embeds=embeds,
            )[1]
            for i in range(spec.num_images)
        ], dim=-1)
        return pooled, self.head(task_key)(pooled)

    def forward_multi_choice(self, task_key, batch, adapter_mode="none", deterministic=True):
        """One BERT pass and one ViLT pass per text choice against the same image."""
        spec = self.task_heads[task_key]
        tt = batch.get("token_type_ids")
        pooled = torch.stack([
            self._encode(batch["input_ids"][:, i], batch["attention_mask"][:, i],
                         None if tt is None else tt[:, i], batch["pixel_values"],
                         batch.get("pixel_mask"), adapter_mode, deterministic)
            for i in range(spec.num_choices)
        ], dim=1)
        logits = self.head(task_key)(pooled, deterministic=deterministic)
        return pooled, logits.squeeze(-1)

    def init_all(self, batch: Dict[str, Any], adapter_mode: str = "init_all"):
        """JAX's initialisation forward (viltbert.py:134-163): the encoder on
        the first slice of a multi-choice or multi-image batch, then every
        task head -> the sum of their logits."""
        ids = _squash(batch["input_ids"], 2)
        mask = _squash(batch["attention_mask"], 2)
        pooled = self._encode(ids, mask, _squash(batch.get("token_type_ids"), 2),
                              _squash(batch["pixel_values"], 4), _squash(batch.get("pixel_mask"), 3),
                              adapter_mode, True)
        out = 0.0
        for key, spec in self.task_heads.items():
            if spec.model_type == "multi-choice":
                logits = self.head(key)(pooled[:, None, :])
            else:
                logits = self.head(key)(torch.cat([pooled] * spec.num_images, dim=-1))
            out = out + logits.sum()
        return out
