"""ALBEF: ViT-B/16 visual encoder + fusion-BERT question encoder + 6-layer LM
answer decoder, and its two-stage answer ranking.

Counterpart of ``feddat_tpu/models/albef.py``: ``shifted_lm_loss``,
``AlbefModel`` with the training forward (``forward`` is JAX's ``__call__``:
the weighted LM loss over a dense ``[B, A]`` answer bank, normalised by B),
``encode_train``, ``apply_cls`` and ``forward_train_logits`` (the fused DAT
step's and the momentum twin's pieces), ``encode_question``,
``decode_logits`` and ``rank_answer``, with the visual prompt (``prompt_vis``)
under prompt tuning; ``momentum_update`` on state dicts
(and ``momentum_update_`` in place, for the twin a compiled step keeps);
and a seeded initialisation.  With ``deterministic=False`` the BERT towers'
dropout draws its masks from the current dropout generator
(``utils/seeding.py``); the ViT has no dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from feddat_tpu_torch.configs.core import AlbefBertConfig, AlbefModelConfig
from feddat_tpu_torch.models import DTYPES
from feddat_tpu_torch.models.prompts import ReparamPrompt, splice_after_cls
from feddat_tpu_torch.models.vilt import init_vilt_params
from feddat_tpu_torch.models.vit import VisionTransformer
from feddat_tpu_torch.models.xbert import XBertLMHead, XBertModel


def decoder_config(cfg: AlbefModelConfig) -> AlbefBertConfig:
    """The decoder's BERT: ``fusion_layer=0``, ``decoder_layers`` layers."""
    return dataclasses.replace(cfg.bert, fusion_layer=0, num_layers=cfg.decoder_layers)


def shifted_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                    soft_labels: Optional[torch.Tensor] = None, alpha: float = 0.0) -> torch.Tensor:
    """Per-sequence next-token loss: logits [N, L, V], labels [N, L] with -100
    ignored -> [N], the sum of the token losses.  Without ``soft_labels`` the
    CE is ``logsumexp - target logit``; with them [N, L-1, V] it is
    ``(1-alpha)·CE + alpha·(-Σ log_softmax·soft)`` per token."""
    shifted = logits[:, :-1, :]
    tgt = labels[:, 1:]
    valid = tgt != -100
    safe_tgt = torch.where(valid, tgt, 0).long()
    if soft_labels is None:
        lse = torch.logsumexp(shifted.float(), dim=-1)
        tgt_logit = torch.gather(shifted, -1, safe_tgt[..., None])[..., 0].float()
        return torch.where(valid, lse - tgt_logit, 0.0).sum(-1)
    logp = torch.log_softmax(shifted.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_tgt[..., None])[..., 0]
    ce = torch.where(valid, nll, 0.0).sum(-1)
    distill = torch.where(valid, -(logp * soft_labels).sum(-1), 0.0).sum(-1)
    return (1.0 - alpha) * ce + alpha * distill


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal values (``torch.topk`` promises no order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class AlbefModel(nn.Module):
    """The composite model; every public method takes ``adapter_mode`` and
    hands it to every adapter site.  ``vision_attn_impl`` routes the ViT alone
    (None: ``attn_impl``)."""

    def __init__(self, cfg: AlbefModelConfig, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", vision_attn_impl: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        logits_dtype = DTYPES[cfg.attention_logits_dtype]
        # the BERT towers' remat: text_remat (default cfg.remat) with
        # text_remat_policy (albef.py:99-117); the ViT's is cfg.remat_policy
        text_remat = cfg.remat if cfg.text_remat is None else cfg.text_remat
        self.visual_encoder = VisionTransformer(cfg, dtype, vision_attn_impl or attn_impl)
        self.text_encoder = XBertModel(cfg.bert, cfg.adapter, cfg.lora, dtype, attn_impl,
                                       logits_dtype=logits_dtype, remat=text_remat,
                                       remat_policy=cfg.text_remat_policy)
        self.text_decoder = XBertLMHead(decoder_config(cfg), cfg.adapter, cfg.lora, dtype,
                                        attn_impl, logits_dtype, text_remat, cfg.text_remat_policy)
        if cfg.prompt.enabled:
            # visual prompt tuning (albef.py:131-140): spliced after the ViT's CLS
            self.prompt_vis = ReparamPrompt(cfg.prompt, cfg.vision_width, dtype)

    def encode_question(self, pixel_values, question_ids, question_mask, adapter_mode="none",
                        deterministic=True):
        """image -> ViT (the visual prompt spliced after its CLS token, with
        prompt tuning); question x image -> fusion encoder -> question token
        states [B, Lq, D] (every image token attended)."""
        image_embeds = self.visual_encoder(pixel_values, adapter_mode, deterministic)
        if self.cfg.prompt.enabled:
            ones = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=image_embeds.device)
            image_embeds, _ = splice_after_cls(image_embeds, ones, self.prompt_vis())
        return self.text_encoder(question_ids, question_mask, encoder_hidden_states=image_embeds,
                                 mode="multi_modal", adapter_mode=adapter_mode,
                                 deterministic=deterministic)

    def decode_logits(self, answer_ids, answer_mask, question_states, question_atts,
                      adapter_mode="none", deterministic=True, cross_group=1, pack_group=1):
        """Decoder token logits.  ``cross_group=k``: answer rows come k per
        question ([B·k, La]) against [B, Lq, D] question states, grouped in the
        cross-attention instead of repeated; ``pack_group=g`` packs g rows per
        self-attention row (block-diagonal bias, exact)."""
        return self.text_decoder(answer_ids, answer_mask, question_states, question_atts,
                                 adapter_mode, deterministic, cross_group, pack_group)

    def forward(self, batch: Dict[str, Any], adapter_mode: str = "none", deterministic: bool = False,
                soft_logits: Optional[torch.Tensor] = None, alpha: float = 0.0,
                pad_token_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward -> (Σ answer_weights · sequence loss / B, shifted
        logits [B·A, La−1, V]).  Batch: pixel_values [B, H, W, 3],
        question_ids/mask [B, Lq], answer_ids/mask [B, A, La], answer_weights
        [B, A] (0 = a padded slot).  The A answers of a question share its
        states in the decoder's cross-attention (``cross_group=A``)."""
        q_states = self.encode_question(batch["pixel_values"], batch["question_ids"],
                                        batch["question_mask"], adapter_mode, deterministic)
        b, a, la = batch["answer_ids"].shape
        ans_ids = batch["answer_ids"].reshape(b * a, la)
        logits = self.decode_logits(ans_ids, batch["answer_mask"].reshape(b * a, la), q_states,
                                    batch["question_mask"], adapter_mode, deterministic, cross_group=a)
        targets = torch.where(ans_ids == pad_token_id, -100, ans_ids)
        soft = None if soft_logits is None else torch.softmax(soft_logits.float(), dim=-1)
        seq_loss = shifted_lm_loss(logits, targets, soft, alpha)
        loss = (batch["answer_weights"].reshape(b * a) * seq_loss).sum() / b
        return loss, logits[:, :-1, :]

    def encode_train(self, batch: Dict[str, Any], adapter_mode: str = "none",
                     deterministic: bool = True) -> torch.Tensor:
        """Everything up to the LM prediction head -> decoder hidden states
        [B·A, La, D]: the fused DAT step's encoder pass (between its stages ①
        and ③ only the ``cls`` head changes)."""
        q_states = self.encode_question(batch["pixel_values"], batch["question_ids"],
                                        batch["question_mask"], adapter_mode, deterministic)
        b, a, la = batch["answer_ids"].shape
        return self.text_decoder.bert_hidden(
            batch["answer_ids"].reshape(b * a, la), batch["answer_mask"].reshape(b * a, la),
            q_states, batch["question_mask"], adapter_mode, deterministic, cross_group=a)

    def apply_cls(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM prediction head alone -> shifted logits [B·A, La−1, V]."""
        return self.text_decoder.cls_logits(hidden)[:, :-1, :]

    def forward_train_logits(self, batch: Dict[str, Any], adapter_mode: str = "none",
                             deterministic: bool = True) -> torch.Tensor:
        """The momentum twin's forward: shifted logits only."""
        return self.apply_cls(self.encode_train(batch, adapter_mode, deterministic))

    def rank_answer(self, batch: Dict[str, Any], answer_ids: torch.Tensor,
                    answer_mask: torch.Tensor, k: int = 64, adapter_mode: str = "none",
                    pad_token_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-stage top-k answer ranking over a CLS-prefixed answer bank
        [num_answers, La] -> (answer ids [B, k], probabilities [B, k]),
        descending.  Stage 1 decodes BOS alone and keeps the k answers with the
        most probable first token; stage 2 decodes those k in full and
        re-ranks by first-token log-probability minus the sequence loss."""
        q_states = self.encode_question(batch["pixel_values"], batch["question_ids"],
                                        batch["question_mask"], adapter_mode, deterministic=True)
        qmask = batch["question_mask"]
        b = q_states.shape[0]
        start_ids = answer_ids[0, 0].expand(b, 1)
        start_mask = torch.ones((b, 1), dtype=torch.int32, device=answer_ids.device)
        start_logits = self.decode_logits(start_ids, start_mask, q_states, qmask, adapter_mode)[:, 0]
        probs = torch.softmax(start_logits.float(), dim=-1)
        prob_first = probs[:, answer_ids[:, 1].long()]  # [B, num_answers]
        topk_probs, topk_ids = stable_top_k(prob_first, k)

        cand_ids = answer_ids[topk_ids.reshape(-1)]  # [B·k, La]
        cand_mask = answer_mask[topk_ids.reshape(-1)]
        g = self.cfg.eval_pack_group
        if g <= 1 or k % g:
            g = 1
        logits = self.decode_logits(cand_ids, cand_mask, q_states, qmask, adapter_mode, True,
                                    cross_group=k, pack_group=g)
        targets = torch.where(cand_ids == pad_token_id, -100, cand_ids)
        seq_loss = shifted_lm_loss(logits, targets)  # [B·k]
        log_probs = (torch.log(topk_probs.reshape(-1)) - seq_loss).reshape(b, k)
        final_probs, rerank_id = stable_top_k(torch.softmax(log_probs, dim=-1), k)
        return torch.gather(topk_ids, 1, rerank_id), final_probs


def momentum_update(params: Dict[str, torch.Tensor], momentum_params: Dict[str, torch.Tensor],
                    momentum: float = 0.995) -> Dict[str, torch.Tensor]:
    """The EMA twin update ``m·momentum + p·(1 − momentum)`` per name, as a
    new dict (``albef_model.py:165-169``)."""
    return momentum_update_(params, {k: m.clone() for k, m in momentum_params.items()}, momentum)


def momentum_update_(params: Dict[str, torch.Tensor], momentum_params: Dict[str, torch.Tensor],
                     momentum: float = 0.995) -> Dict[str, torch.Tensor]:
    """:func:`momentum_update` written into ``momentum_params``' tensors in
    place, with JAX's rounding (the two products rounded, then their sum),
    by multi-tensor ops; returns ``momentum_params``."""
    ms = list(momentum_params.values())
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, torch._foreach_mul([params[k] for k in momentum_params], 1.0 - momentum))
    return momentum_params


def init_albef_params(model: AlbefModel, seed: int) -> AlbefModel:
    """Initialise every parameter in place with the JAX package's
    initialisers, drawn on the CPU from ``seed`` in parameter order: kernels,
    the patch conv and embeddings N(0, 0.02) (ALBEF's ``initializer_range``),
    zero biases, CLS token and position table, unit LayerNorm scales, LoRA A
    uniform(±1/sqrt(fan_in)) and B zero — the scheme of
    :func:`~feddat_tpu_torch.models.vilt.init_vilt_params`."""
    return init_vilt_params(model, seed)
