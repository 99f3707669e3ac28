"""Fusion BERT ("xBERT"): ALBEF's question encoder and answer decoder.

Counterpart of ``feddat_tpu/models/xbert.py``: the parts that ALBEF's
training forward and ``rank_answer`` run, and ``XBertMaskedLM``, the
masked-LM head of the reference's pretraining.  Hidden dropout (embeddings, after each attention and
the FFN output) and attention dropout are live when ``deterministic`` is
False, their masks drawn from the current dropout generator
(``utils/seeding.py``):

* ``XBertEmbeddings``: word + position + token-type (type 0), LayerNorm, dropout;
* ``XBertLayer``: post-LN BERT layer (its attention and FFN on this rank's
  heads and columns under tensor parallelism, ``parallel/tp.py``); layers
  ``>= fusion_layer`` also
  cross-attend to encoder states (``encoder_width`` wide).  ``cross_group=k``
  regroups ``[B·k, L, D]`` query rows as ``[B, k·L, D]`` so the k rows of one
  question share its key/value set (a pure view, no repeated states).  The
  adapter sits in the FFN output with the LayerNorm sandwich, the same
  ``output_norm`` applied twice::

      r = dense(ffn);  z = LN(r + h);  a = r + adapter.delta(z);  out = LN(a + h)

* ``XBertEncoder``: the text-only layers then the fusion layers, as the
  ModuleLists ``text_layers.<i>`` and ``fusion_layers.<i>`` (flax scans them
  under ``text_layers/layer`` and ``fusion_layers/layer``); ``mode`` picks
  which run; ``remat`` recomputes each layer in the backward with
  ``remat_policy`` (no structural policies; ``"names"`` keeps the fusion
  layers' image K/V projections among the rest);
* ``XBertModel``: embeddings + encoder, with ``pack_group=g`` packing g
  sequences per self-attention row behind a block-diagonal bias (exact);
* ``XBertLMHead``: the causal decoder with ``BertPredictionHead``, whose
  vocabulary projection is the decoder's own word-embedding tensor (tied);
* ``XBertMaskedLM``: the bidirectional encoder with the same tied head, and
  the masked-LM loss with the soft-label mix.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from feddat_tpu_torch.configs.core import AdapterSpec, AlbefBertConfig, LoraSpec
from feddat_tpu_torch.models.adapters import AdapterCell, dense
from feddat_tpu_torch.models.layers import LayerNorm, MultiHeadAttention, dropout, ffn
from feddat_tpu_torch.models.vilt import embed
from feddat_tpu_torch.ops.attention import causal_bias, mask_to_bias, packed_self_bias
from feddat_tpu_torch.ops.remat_policy import remat_call


class XBertEmbeddings(nn.Module):
    def __init__(self, cfg: AlbefBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, input_ids, deterministic=True):
        token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = embed(input_ids, self.word_embeddings, self.dtype)
        x = x + embed(positions, self.position_embeddings, self.dtype)
        x = x + embed(token_type_ids, self.token_type_embeddings, self.dtype)
        return dropout(self.norm(x), self.cfg.hidden_dropout, deterministic)


class XBertLayer(nn.Module):
    """One post-LN BERT layer, optional cross-attention, adapter LN sandwich."""

    def __init__(self, cfg: AlbefBertConfig, has_cross: bool, adapter: AdapterSpec,
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", logits_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.has_cross = has_cross
        self.dtype = dtype
        self.adapter_spec = adapter
        self.attention = MultiHeadAttention(c.hidden_size, c.num_heads, c.attention_dropout, lora,
                                            dtype, attn_impl, logits_dtype)
        self.attention_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        if has_cross:
            # no LoRA on cross-attention: the reference attaches it to
            # self-attention q/v only (xbert.py:103-105)
            self.crossattention = MultiHeadAttention(
                c.hidden_size, c.num_heads, c.attention_dropout, LoraSpec(), dtype, attn_impl,
                logits_dtype, kv_features=c.encoder_width)
            self.crossattention_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        if adapter.enabled:
            self.adapter = AdapterCell(adapter, c.hidden_size, dtype)

    def forward(self, x, self_bias, enc_states=None, enc_bias=None, adapter_mode: str = "none",
                deterministic: bool = True, cross_group: int = 1):
        rate = self.cfg.hidden_dropout
        attn = self.attention(x, bias=self_bias, deterministic=deterministic)
        h = self.attention_norm(dropout(attn, rate, deterministic) + x)
        if self.has_cross:
            bk, la, dm = h.shape
            # rank_answer's layout: the k candidate rows of one question share
            # its encoder states, as one [B, k·La, D] query block
            hg = h.reshape(bk // cross_group, cross_group * la, dm)
            cross = self.crossattention(hg, bias=enc_bias, deterministic=deterministic, kv=enc_states)
            h = self.crossattention_norm(dropout(cross.reshape(bk, la, dm), rate, deterministic) + h)
        o = dropout(ffn(h, self.intermediate, self.output, self.dtype), rate, deterministic)
        if self.adapter_spec.enabled:
            z = self.output_norm(o + h)
            return self.output_norm(o + self.adapter.delta(z, adapter_mode) + h)
        return self.output_norm(o + h)


class XBertEncoder(nn.Module):
    """``fusion_layer`` text-only layers, then the cross-attending rest."""

    def __init__(self, cfg: AlbefBertConfig, adapter: AdapterSpec, lora: LoraSpec = LoraSpec(),
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 logits_dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        c = cfg
        self.remat = remat
        self.remat_policy = remat_policy

        def stack(has_cross, n):
            return nn.ModuleList(XBertLayer(c, has_cross, adapter, lora, dtype, attn_impl, logits_dtype)
                                 for _ in range(n))

        self.text_layers = stack(False, c.fusion_layer)
        self.fusion_layers = stack(True, c.num_layers - c.fusion_layer)

    def forward(self, x, self_bias, enc_states=None, enc_bias=None, mode: str = "multi_modal",
                adapter_mode: str = "none", deterministic: bool = True, cross_group: int = 1):
        def run(layer, x, enc, eb):
            return remat_call(layer, self.remat, self.remat_policy, False,
                              x, self_bias, enc, eb, adapter_mode, deterministic, cross_group)

        if mode in ("text", "multi_modal"):
            for layer in self.text_layers:
                x = run(layer, x, None, None)
        if mode in ("fusion", "multi_modal"):
            for layer in self.fusion_layers:
                x = run(layer, x, enc_states, enc_bias)
        return x


class XBertModel(nn.Module):
    """Embeddings + encoder (BERT without the pooler)."""

    def __init__(self, cfg: AlbefBertConfig, adapter: AdapterSpec = AdapterSpec(),
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", is_decoder: bool = False,
                 logits_dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = "full"):
        super().__init__()
        self.is_decoder = is_decoder
        self.embeddings = XBertEmbeddings(cfg, dtype)
        self.encoder = XBertEncoder(cfg, adapter, lora, dtype, attn_impl, logits_dtype, remat,
                                    remat_policy)

    def forward(self, input_ids, attention_mask, encoder_hidden_states=None,
                encoder_attention_mask=None, mode: str = "multi_modal", adapter_mode: str = "none",
                deterministic: bool = True, cross_group: int = 1, pack_group: int = 1):
        x = self.embeddings(input_ids, deterministic)
        unpacked_shape = x.shape
        if pack_group > 1:
            # pack after the embeddings (positions are per sequence); the
            # packed reshape is a view of the same candidate order, so the
            # cross-attention grouping shrinks by the packing factor
            n, L, D = x.shape
            if n % pack_group or cross_group % pack_group:
                raise ValueError(f"pack_group={pack_group} must divide rows {n} and "
                                 f"cross_group={cross_group}")
            x = x.reshape(n // pack_group, pack_group * L, D)
            self_bias = packed_self_bias(attention_mask, pack_group, self.is_decoder)
            cross_group //= pack_group
        else:
            self_bias = mask_to_bias(attention_mask)
            if self.is_decoder:
                self_bias = self_bias + causal_bias(x.shape[1], device=x.device)
        enc_bias = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = torch.ones(encoder_hidden_states.shape[:2], dtype=torch.int32,
                                                    device=encoder_hidden_states.device)
            enc_bias = mask_to_bias(encoder_attention_mask)
        out = self.encoder(x, self_bias, encoder_hidden_states, enc_bias, mode, adapter_mode,
                           deterministic, cross_group)
        return out.reshape(unpacked_shape)


class _TiedDecoderBias(nn.Module):
    """The bias of the tied vocabulary projection (``cls.decoder.bias``)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab_size))


class BertPredictionHead(nn.Module):
    """transform (dense, exact GELU, LayerNorm) and the vocabulary projection
    by the word-embedding tensor it is handed (tied, xbert.py:355-379)."""

    def __init__(self, cfg: AlbefBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.transform_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.decoder = _TiedDecoderBias(cfg.vocab_size)

    def forward(self, hidden: torch.Tensor, tied_embedding: torch.Tensor) -> torch.Tensor:
        h = self.transform_norm(F.gelu(dense(hidden, self.transform_dense, self.dtype)))
        # product and bias rounded apart, as flax's `h @ W.T + b` does
        return h @ tied_embedding.to(self.dtype).t() + self.decoder.bias.to(self.dtype)


class XBertLMHead(nn.Module):
    """The answer decoder (``fusion_layer=0``: cross-attention in every layer)
    with causal self-attention and the tied prediction head -> token logits."""

    def __init__(self, cfg: AlbefBertConfig, adapter: AdapterSpec = AdapterSpec(),
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", logits_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.bert = XBertModel(cfg, adapter, lora, dtype, attn_impl, is_decoder=True,
                               logits_dtype=logits_dtype, remat=remat, remat_policy=remat_policy)
        self.cls = BertPredictionHead(cfg, dtype)

    def bert_hidden(self, input_ids, attention_mask, encoder_hidden_states,
                    encoder_attention_mask=None, adapter_mode: str = "none",
                    deterministic: bool = True, cross_group: int = 1, pack_group: int = 1):
        """The decoder transformer alone -> final hidden states."""
        return self.bert(input_ids, attention_mask, encoder_hidden_states=encoder_hidden_states,
                         encoder_attention_mask=encoder_attention_mask, mode="multi_modal",
                         adapter_mode=adapter_mode, deterministic=deterministic,
                         cross_group=cross_group, pack_group=pack_group)

    def cls_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.cls(hidden, self.bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, attention_mask, encoder_hidden_states,
                encoder_attention_mask: Optional[torch.Tensor] = None, adapter_mode: str = "none",
                deterministic: bool = True, cross_group: int = 1, pack_group: int = 1):
        return self.cls_logits(self.bert_hidden(
            input_ids, attention_mask, encoder_hidden_states, encoder_attention_mask, adapter_mode,
            deterministic, cross_group, pack_group))


class XBertMaskedLM(nn.Module):
    """Masked-LM head over the (optionally multimodal) encoder: the
    reference's ``BertForMaskedLM`` with the soft-label distillation mix
    (``xbert.py:1360-1428``; JAX ``models/xbert.py:467-525``).  Without
    ``labels`` -> token logits [B, L, V]; with them -> (loss, logits), the
    loss the mean token CE over positions whose label is not -100, mixed as
    ``(1 - alpha)·CE + alpha·soft-CE`` when ``soft_labels`` [B, L, V] are
    given.  Without ``encoder_hidden_states`` the fusion layers'
    cross-attention attends to the text itself, as in JAX."""

    def __init__(self, cfg: AlbefBertConfig, adapter: AdapterSpec = AdapterSpec(),
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto"):
        super().__init__()
        self.bert = XBertModel(cfg, adapter, lora, dtype, attn_impl)
        self.cls = BertPredictionHead(cfg, dtype)

    def forward(self, input_ids, attention_mask, labels=None, encoder_hidden_states=None,
                encoder_attention_mask=None, soft_labels=None, alpha=0.0,
                mode: str = "multi_modal", adapter_mode: str = "none", deterministic: bool = True,
                cross_group: int = 1):
        hidden = self.bert(input_ids, attention_mask, encoder_hidden_states=encoder_hidden_states,
                           encoder_attention_mask=encoder_attention_mask, mode=mode,
                           adapter_mode=adapter_mode, deterministic=deterministic,
                           cross_group=cross_group)
        logits = self.cls(hidden, self.bert.embeddings.word_embeddings.weight)
        if labels is None:
            return logits
        valid = labels != -100
        safe = torch.where(valid, labels, 0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = torch.where(valid, -torch.gather(logp, -1, safe[..., None])[..., 0], 0.0)
        count = valid.sum().clamp_min(1)
        loss = nll.sum() / count
        if soft_labels is not None:
            distill = torch.where(valid, -(logp * soft_labels).sum(-1), 0.0).sum() / count
            loss = (1.0 - alpha) * loss + alpha * distill
        return loss, logits
