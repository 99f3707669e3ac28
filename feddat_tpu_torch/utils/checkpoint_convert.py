"""Pretrained-checkpoint conversion (counterpart of
``feddat_tpu/utils/checkpoint_convert.py``): published torch state dicts ->
parameter trees in the JAX package's layout (nested dicts of numpy arrays),
which ``utils/param_bridge.py`` carries onto the port's modules;
:func:`merge_pretrained` does that and overlays them on a model's state_dict.

Covers the reference's load paths without copying them:
  * HF ``ViltModel`` weights -> the ViLT encoder (``vilt.*``)
    (reference loads via ``ViltModel.from_pretrained``, ``vilt.py:387-418``);
  * modality-type embedding expansion 2 -> 3 rows (``vilt.py:102-113``);
  * ALBEF ``.pth`` surgery: ViT pos-embed bicubic interpolation, ``bert.*``
    key renames, text-encoder layers >= fusion_layer split into the 6-layer
    decoder (``albef.py:204-241``, ``vit.py:193-217``);
  * HF ``BertModel`` weights -> the xBERT towers.

Layer-stacking: the JAX layout stacks a tower's per-layer tensors along a
new leading axis (its ``nn.scan``); the bridge unstacks them again.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from feddat_tpu_torch.utils.param_bridge import vilt_from_flax


def _t(w) -> np.ndarray:
    """torch tensor/array -> numpy.  Half-precision checkpoints are upcast
    first: torch ``.numpy()`` raises on bfloat16, and params are fp32."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
        if w.dtype in (torch.bfloat16, torch.float16):
            w = w.float()
        w = w.numpy()
    return np.asarray(w)


def _linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear -> flax Dense {kernel [in,out], bias [out]}."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _embed(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"embedding": _t(sd[key])}


def _stack(dicts) -> Dict[str, Any]:
    """List of per-layer subtrees -> one subtree with a leading layer axis."""
    first = dicts[0]
    return {k: (_stack([d[k] for d in dicts]) if isinstance(v, Mapping)
                else np.stack([d[k] for d in dicts], axis=0))
            for k, v in first.items()}


def interpolate_pos_embed(pos: np.ndarray, num_patches_new) -> np.ndarray:
    """Bicubic grid resize of [1, 1+N, D] ViT position embeddings
    (behavior of reference ``vit.py:193-217``).

    ``num_patches_new``: an int (square target grid, ALBEF-style) or an
    ``(gh, gw)`` tuple for non-square canvases (ViLT's 384x640 canvas is a
    12x20 patch grid).  The source checkpoint grid is square (both ViLT and
    ALBEF pretrain at square resolutions).
    """
    if isinstance(num_patches_new, (tuple, list)):
        gh_new, gw_new = int(num_patches_new[0]), int(num_patches_new[1])
    else:
        g = int(round(int(num_patches_new) ** 0.5))
        assert g * g == int(num_patches_new), (
            f"square grid expected for int target ({num_patches_new}); "
            "pass an (gh, gw) tuple for non-square canvases"
        )
        gh_new = gw_new = g
    n_old = pos.shape[1] - 1
    if n_old == gh_new * gw_new:
        # already at the target patch count (square or not): no-op
        return pos
    d = pos.shape[2]
    g_old = int(round(n_old**0.5))
    assert g_old * g_old == n_old, f"non-square source grid ({n_old} patches)"
    extra, grid = pos[:, :1], pos[:, 1:]
    grid = torch.tensor(grid).reshape(1, g_old, g_old, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh_new, gw_new), mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh_new * gw_new, d).numpy()
    return np.concatenate([extra, grid], axis=1)


def _mha_params(sd, q, k, v, o) -> Dict[str, Any]:
    """query/value are LoraDense (nested 'dense'); key/out are plain Dense."""
    return {
        "query": {"dense": _linear(sd, q)},
        "key": _linear(sd, k),
        "value": {"dense": _linear(sd, v)},
        "out": _linear(sd, o),
    }


# -- ViLT -------------------------------------------------------------------
def convert_hf_vilt(
    sd: Mapping[str, Any],
    num_layers: int = 12,
    num_patches_new: Optional[int] = None,
    modality_type_vocab_size: int = 3,
) -> Dict[str, Any]:
    """HF ``ViltModel.state_dict()`` -> params for ``ViltEncoder``."""
    p: Dict[str, Any] = {}
    te = "embeddings.text_embeddings"
    p["text_embeddings"] = {
        "word_embeddings": _embed(sd, f"{te}.word_embeddings.weight"),
        "position_embeddings": _embed(sd, f"{te}.position_embeddings.weight"),
        "token_type_embeddings": _embed(sd, f"{te}.token_type_embeddings.weight"),
        "norm": _layernorm(sd, f"{te}.LayerNorm"),
    }
    pos = _t(sd["embeddings.position_embeddings"])
    if num_patches_new is not None:
        pos = interpolate_pos_embed(pos, num_patches_new)
    p["visual_embeddings"] = {
        "cls_token": _t(sd["embeddings.cls_token"]),
        "position_embeddings": pos,
        # torch conv OIHW -> flax HWIO
        "patch_projection": {
            "kernel": _t(sd["embeddings.patch_embeddings.projection.weight"]).transpose(2, 3, 1, 0),
            "bias": _t(sd["embeddings.patch_embeddings.projection.bias"]),
        },
    }
    # modality-type embeddings, expanded 2 -> 3 (third row = copy of image row)
    mt = _t(sd["embeddings.token_type_embeddings.weight"])
    if mt.shape[0] < modality_type_vocab_size:
        mt = np.concatenate(
            [mt] + [mt[-1:]] * (modality_type_vocab_size - mt.shape[0]), axis=0
        )
    p["modality_type_embeddings"] = {"embedding": mt}

    layers = []
    for i in range(num_layers):
        b = f"encoder.layer.{i}"
        layers.append(
            {
                "norm_before": _layernorm(sd, f"{b}.layernorm_before"),
                "norm_after": _layernorm(sd, f"{b}.layernorm_after"),
                "attention": _mha_params(
                    sd,
                    f"{b}.attention.attention.query",
                    f"{b}.attention.attention.key",
                    f"{b}.attention.attention.value",
                    f"{b}.attention.output.dense",
                ),
                "mlp": {
                    "intermediate": _linear(sd, f"{b}.intermediate.dense"),
                    "output": _linear(sd, f"{b}.output.dense"),
                },
            }
        )
    p["layers"] = {"layer": _stack(layers)}
    p["final_norm"] = _layernorm(sd, "layernorm")
    p["pooler"] = _linear(sd, "pooler.dense")
    return p


# -- BERT / xBERT -----------------------------------------------------------
def _xbert_layer(sd, b: str, has_cross: bool) -> Dict[str, Any]:
    layer = {
        "attention": _mha_params(
            sd,
            f"{b}.attention.self.query",
            f"{b}.attention.self.key",
            f"{b}.attention.self.value",
            f"{b}.attention.output.dense",
        ),
        "attention_norm": _layernorm(sd, f"{b}.attention.output.LayerNorm"),
        "intermediate": _linear(sd, f"{b}.intermediate.dense"),
        "output": _linear(sd, f"{b}.output.dense"),
        "output_norm": _layernorm(sd, f"{b}.output.LayerNorm"),
    }
    if has_cross:
        layer["crossattention"] = _mha_params(
            sd,
            f"{b}.crossattention.self.query",
            f"{b}.crossattention.self.key",
            f"{b}.crossattention.self.value",
            f"{b}.crossattention.output.dense",
        )
        layer["crossattention_norm"] = _layernorm(sd, f"{b}.crossattention.output.LayerNorm")
    return layer


def convert_bert_to_xbert(
    sd: Mapping[str, Any],
    num_layers: int = 12,
    fusion_layer: int = 6,
    prefix: str = "",
) -> Dict[str, Any]:
    """BERT-style state dict -> ``XBertModel`` params.

    Missing cross-attention weights (plain BERT checkpoints) are initialized
    from the layer's self-attention; ALBEF's published checkpoints carry
    trained cross weights, which are taken verbatim.
    """

    def g(k):
        return f"{prefix}{k}"

    e = g("embeddings")
    p: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": _embed(sd, f"{e}.word_embeddings.weight"),
            "position_embeddings": _embed(sd, f"{e}.position_embeddings.weight"),
            "token_type_embeddings": _embed(sd, f"{e}.token_type_embeddings.weight"),
            "norm": _layernorm(sd, f"{e}.LayerNorm"),
        }
    }
    text_layers, fusion_layers = [], []
    for i in range(num_layers):
        b = g(f"encoder.layer.{i}")
        has_cross = i >= fusion_layer
        if has_cross and f"{b}.crossattention.self.query.weight" not in sd:
            sd = dict(sd)
            for part in ("query", "key", "value"):
                sd[f"{b}.crossattention.self.{part}.weight"] = sd[f"{b}.attention.self.{part}.weight"]
                sd[f"{b}.crossattention.self.{part}.bias"] = sd[f"{b}.attention.self.{part}.bias"]
            sd[f"{b}.crossattention.output.dense.weight"] = sd[f"{b}.attention.output.dense.weight"]
            sd[f"{b}.crossattention.output.dense.bias"] = sd[f"{b}.attention.output.dense.bias"]
            sd[f"{b}.crossattention.output.LayerNorm.weight"] = sd[f"{b}.attention.output.LayerNorm.weight"]
            sd[f"{b}.crossattention.output.LayerNorm.bias"] = sd[f"{b}.attention.output.LayerNorm.bias"]
        layer = _xbert_layer(sd, b, has_cross)
        (fusion_layers if has_cross else text_layers).append(layer)
    enc = {}
    if text_layers:
        enc["text_layers"] = {"layer": _stack(text_layers)}
    if fusion_layers:
        enc["fusion_layers"] = {"layer": _stack(fusion_layers)}
    p["encoder"] = enc
    return p


def convert_bert_lm_head(sd: Mapping[str, Any], prefix: str = "cls.predictions") -> Dict[str, Any]:
    """BERT MLM prediction head -> ``BertPredictionHead`` params.

    The vocab-projection kernel is NOT converted: the flax head ties it to
    the word embeddings like the reference (``decoder.weight`` in torch
    checkpoints is the same tensor as ``embeddings.word_embeddings.weight``
    — HF ``tie_weights``, xbert.py:1197-1202); only the bias is a distinct
    parameter."""
    if f"{prefix}.decoder.bias" in sd:
        bias = _t(sd[f"{prefix}.decoder.bias"])
    else:
        bias = _t(sd[f"{prefix}.bias"])
    return {
        "transform_dense": _linear(sd, f"{prefix}.transform.dense"),
        "transform_norm": _layernorm(sd, f"{prefix}.transform.LayerNorm"),
        "decoder": {"bias": bias},
    }


# -- ALBEF ------------------------------------------------------------------
def convert_vit_timm(sd: Mapping[str, Any], num_layers: int = 12, prefix: str = "", num_patches_new: Optional[int] = None) -> Dict[str, Any]:
    """timm-style ViT state dict -> ``VisionTransformer`` params."""

    def g(k):
        return f"{prefix}{k}"

    pos = _t(sd[g("pos_embed")])
    if num_patches_new is not None:
        pos = interpolate_pos_embed(pos, num_patches_new)
    p: Dict[str, Any] = {
        "cls_token": _t(sd[g("cls_token")]),
        "pos_embed": pos,
        "patch_embed": {
            "kernel": _t(sd[g("patch_embed.proj.weight")]).transpose(2, 3, 1, 0),
            "bias": _t(sd[g("patch_embed.proj.bias")]),
        },
        "final_norm": _layernorm(sd, g("norm")),
    }
    blocks = []
    for i in range(num_layers):
        b = g(f"blocks.{i}")
        qkv_w = _t(sd[f"{b}.attn.qkv.weight"])  # [3D, D]
        qkv_b = _t(sd[f"{b}.attn.qkv.bias"])
        d = qkv_w.shape[1]
        qw, kw, vw = qkv_w[:d], qkv_w[d : 2 * d], qkv_w[2 * d :]
        qb, kb, vb = qkv_b[:d], qkv_b[d : 2 * d], qkv_b[2 * d :]
        blocks.append(
            {
                "norm_before": _layernorm(sd, f"{b}.norm1"),
                "norm_after": _layernorm(sd, f"{b}.norm2"),
                "attention": {
                    "query": {"dense": {"kernel": qw.T, "bias": qb}},
                    "key": {"kernel": kw.T, "bias": kb},
                    "value": {"dense": {"kernel": vw.T, "bias": vb}},
                    "out": _linear(sd, f"{b}.attn.proj"),
                },
                "mlp": {
                    "intermediate": _linear(sd, f"{b}.mlp.fc1"),
                    "output": _linear(sd, f"{b}.mlp.fc2"),
                },
            }
        )
    p["blocks"] = {"block": _stack(blocks)}
    return p


def convert_albef_checkpoint(
    sd: Mapping[str, Any],
    num_patches_new: int,
    fusion_layer: int = 6,
    num_text_layers: int = 12,
    decoder_layers: int = 6,
    vision_layers: int = 12,
) -> Dict[str, Any]:
    """ALBEF ``.pth`` -> ``AlbefModel`` params, with the reference's key
    surgery (``albef.py:204-241``): ``bert.`` strip, ViT pos-embed
    interpolation, and the encoder->decoder layer split — text-encoder
    layers ``>= fusion_layer`` become decoder layers ``i - fusion_layer``
    IF the checkpoint lacks a trained decoder.
    """
    sd = { (k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items() }
    # strip 'bert.' inside text_encoder/text_decoder keys
    sd = {k.replace(".bert.", "."): v for k, v in sd.items()}

    has_decoder = any(k.startswith("text_decoder.") for k in sd)
    if not has_decoder:
        extra = {}
        for k, v in list(sd.items()):
            if k.startswith("text_encoder.encoder.layer."):
                parts = k.split(".")
                idx = int(parts[3])
                if idx >= fusion_layer:
                    parts[3] = str(idx - fusion_layer)
                    extra["text_decoder." + ".".join(parts[1:])] = v
            elif k.startswith(("text_encoder.embeddings.", "text_encoder.cls.")):
                # non-layer text_encoder keys (embeddings AND the MLM
                # prediction head ``cls.predictions.*`` of the pretrain
                # checkpoint's BertForMaskedLM) move to the decoder — the
                # reference surgery copies every non-layer text_encoder key
                # to text_decoder (``albef.py:224-239``); without ``cls.*``
                # the decoder's LM head would stay randomly initialized.
                extra["text_decoder." + k[len("text_encoder."):]] = v
        sd.update(extra)

    visual = convert_vit_timm(
        {k[len("visual_encoder."):]: v for k, v in sd.items() if k.startswith("visual_encoder.")},
        num_layers=vision_layers,
        num_patches_new=num_patches_new,
    )
    text_sd = {k[len("text_encoder."):]: v for k, v in sd.items() if k.startswith("text_encoder.")}
    text = convert_bert_to_xbert(text_sd, num_layers=num_text_layers, fusion_layer=fusion_layer)
    dec_sd = {k[len("text_decoder."):]: v for k, v in sd.items() if k.startswith("text_decoder.")}
    decoder_bert = convert_bert_to_xbert(dec_sd, num_layers=decoder_layers, fusion_layer=0)
    decoder = {"bert": decoder_bert}
    if "cls.predictions.transform.dense.weight" in dec_sd:
        decoder["cls"] = convert_bert_lm_head(dec_sd)
    return {
        "visual_encoder": visual,
        "text_encoder": text,
        "text_decoder": decoder,
    }


def merge_pretrained(params: Mapping[str, torch.Tensor], pretrained: Mapping[str, Any],
                     strict: bool = False,
                     bridge: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]] = vilt_from_flax
                     ) -> Dict[str, torch.Tensor]:
    """Overlay converted pretrained weights onto a model's state_dict
    (adapters and heads keep their fresh init) -> a new state_dict.
    ``pretrained`` is a tree as the converters return it, rooted at the
    model (e.g. ``{"vilt": convert_hf_vilt(sd)}``; ``albef_from_flax`` as
    ``bridge`` for :func:`convert_albef_checkpoint`'s tree), or a state_dict.
    With ``strict`` a pretrained name the model lacks raises."""
    if any(isinstance(v, Mapping) for v in pretrained.values()):
        pretrained = bridge(pretrained)
    out = dict(params)
    for k, v in pretrained.items():
        if k not in out:
            if strict:
                raise KeyError(f"pretrained name {k} not in the model's state_dict")
            continue
        v = torch.as_tensor(v)
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(out[k].shape)} vs {tuple(v.shape)}")
        out[k] = v.to(dtype=out[k].dtype, device=out[k].device)
    return out
