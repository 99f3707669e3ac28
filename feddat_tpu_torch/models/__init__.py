"""Model registry (counterpart of ``feddat_tpu/models/__init__.py``).

``create_model`` builds the ViLT continual learner or ALBEF on the resolved
device with the same frozen-backbone guards as the JAX registry, and
initialises it from ``seed`` (torch modules always carry parameters; the JAX
package initialises separately with ``init_vilt_params``/``init_albef_params``).
``viltbert`` is ViLT with a frozen BERT in front of its text stream
(``models/viltbert.py``), on the routes ``vilt`` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from feddat_tpu_torch.configs.core import (
    AlbefModelConfig,
    LoraSpec,
    PEFTMode,
    PromptSpec,
    ViltModelConfig,
    adapter_spec_for_mode,
)
from feddat_tpu_torch.device import DeviceLike, resolve_device

ALLOWED_CL_ENCODERS = ["vilt", "viltbert", "albef_distill", "albef_no_distill"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def create_model(
    encoder_name: str,
    task_heads: Dict[str, "TaskHeadSpec"],
    peft_mode: PEFTMode,
    adapter_reduction_factor: int = 16,
    dtype: str = "float32",
    image_size: Optional[Tuple[int, int]] = None,
    lora_enabled: Optional[bool] = None,
    prompt_enabled: Optional[bool] = None,
    remat: bool = False,
    remat_policy: str = "full",
    attn_impl: str = "auto",
    attention_logits_dtype: str = "float32",
    text_remat_policy: str = "full",
    adapter_fused: bool = False,
    device: DeviceLike = None,
    seed: Optional[int] = 0,
):
    """-> (model, model_config), the model on ``device`` (default CUDA) with
    weights initialised from ``seed``; ``seed=None`` leaves them
    uninitialised, for a caller that loads a state dict into the model.  ``remat``, ``remat_policy`` and
    ``text_remat_policy`` (ALBEF's BERT towers) recompute layers in the
    backward (``ops/remat_policy.py``); they change memory, not the numbers.
    ``adapter_fused`` sets ``AdapterSpec.fused`` (the DAT ensemble through
    the fused CUDA epilogue).
    ``task_heads`` and ``image_size`` are ignored by ALBEF (its head is the LM
    decoder, its image 384 px)."""
    dev = resolve_device(device)
    # The attention-block kernel has a frozen-projection contract: modes
    # that train the projections would get no gradient through it.
    if attn_impl in ("block", "layer") and peft_mode in (
        PEFTMode.FULL, PEFTMode.BIAS, PEFTMode.LORA, PEFTMode.FREEZE_BOTTOM_K
    ):
        raise ValueError(
            f"attn_impl={attn_impl!r} assumes frozen attention projections; "
            f"peft_mode={peft_mode.value!r} trains them (their gradients would "
            "silently be zero).  Use attn_impl='auto' for this mode."
        )
    if attn_impl == "layer" and peft_mode == PEFTMode.NORM:
        raise ValueError(
            "attn_impl='layer' fuses the (frozen) LayerNorms into the kernel; "
            "peft_mode='norm' trains them.  Use attn_impl='auto' or 'block'."
        )
    adapter = dataclasses.replace(
        adapter_spec_for_mode(peft_mode, adapter_reduction_factor), fused=adapter_fused
    )
    lora = LoraSpec(enabled=(peft_mode == PEFTMode.LORA if lora_enabled is None else lora_enabled))
    prompt = PromptSpec(enabled=(peft_mode == PEFTMode.PROMPT if prompt_enabled is None else prompt_enabled))
    # 'norm' trains the LayerNorms: keep them outside the kernel there.
    fuse_ln = peft_mode != PEFTMode.NORM

    if encoder_name in ("vilt", "viltbert"):
        from feddat_tpu_torch.models.vilt import ViltContinualLearner, init_vilt_params
        from feddat_tpu_torch.models.viltbert import ViltBertContinualLearner

        cfg = ViltModelConfig(
            adapter=adapter, lora=lora, prompt=prompt, remat=remat, remat_policy=remat_policy,
            attention_logits_dtype=attention_logits_dtype, fuse_ln=fuse_ln,
            **({"image_size": tuple(image_size)} if image_size else {}),
        )
        cls = ViltBertContinualLearner if encoder_name == "viltbert" else ViltContinualLearner
        with torch.device("meta"):
            model = cls(cfg, task_heads, DTYPES[dtype], attn_impl)
        model = model.to_empty(device=dev)
        return (model if seed is None else init_vilt_params(model, seed)), cfg
    if encoder_name in ("albef_distill", "albef_no_distill"):
        from feddat_tpu_torch.models.albef import AlbefModel, init_albef_params

        cfg = AlbefModelConfig(
            adapter=adapter, lora=lora, prompt=prompt, remat=remat, remat_policy=remat_policy,
            attention_logits_dtype=attention_logits_dtype, fuse_ln=fuse_ln,
            distill=(encoder_name == "albef_distill"), text_remat_policy=text_remat_policy,
        )
        # 'block'/'layer' target the ViT (S=577, the FLOP-dominant stack); the
        # post-LN text, fusion and decoder towers keep the composable path
        routes = (dict(attn_impl="auto", vision_attn_impl=attn_impl)
                  if attn_impl in ("block", "layer") else dict(attn_impl=attn_impl))
        with torch.device("meta"):
            model = AlbefModel(cfg, DTYPES[dtype], **routes)
        model = model.to_empty(device=dev)
        return (model if seed is None else init_albef_params(model, seed)), cfg
    raise ValueError(
        f"unknown encoder {encoder_name!r}; allowed: {ALLOWED_CL_ENCODERS} "
        "('flava' is declared but unimplemented in the reference too)"
    )
