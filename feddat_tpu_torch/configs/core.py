"""Typed configuration tree (copy of ``feddat_tpu/configs/core.py``).

The port keeps its own copy of the dataclasses it needs — ``PEFTMode``,
``AdapterSpec``, ``LoraSpec``, ``PromptSpec``, ``ViltModelConfig``,
``AlbefBertConfig``, ``AlbefModelConfig``, ``OptimizerConfig``,
``FederatedConfig``, ``TrainConfig`` and ``adapter_spec_for_mode`` — with the
same fields and defaults, so a config written for one package reads the same
in the other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class PEFTMode(str, enum.Enum):
    """Parameter-efficient fine-tuning modes (reference ``--optimizer_mode``,
    ``src/train/main.py:132-245``)."""

    FULL = "full"
    ADAPTER = "adapter"
    DAT = "dat"
    FREEZE_ENCODER = "freeze_encoder"
    FREEZE_BOTTOM_K = "freeze_bottom_k_layers"
    NONE = "none"
    NORM = "norm"
    LORA = "lora"
    BIAS = "bias"
    PROMPT = "prompt"


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Bottleneck-adapter configuration (reference
    ``src/modeling/models/adapter.py:16-58``).  DAT uses
    ``('adapter_0', 'adapter_1', 'adapter_2')``: local, shared and frozen
    teacher."""

    names: Tuple[str, ...] = ()
    reduction_factor: int = 16
    scaling: float = 1.0
    # Fixed 0.5/0.5 ensemble mix of the live reference path (``adapter.py:144,160``).
    ensemble_weight: float = 0.5
    # Route the ensemble mode through the fused CUDA epilogue
    # (``ops/adapter_fused.py``) when the hidden states are on the card.
    fused: bool = False

    @property
    def enabled(self) -> bool:
        return len(self.names) > 0

    @property
    def is_dat(self) -> bool:
        return "adapter_2" in self.names


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    """LoRA on attention query/value (loralib ``r=16``, default alpha 1)."""

    rank: int = 16
    alpha: float = 1.0
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    """Reparameterized prompt tuning (reference ``src/train/main.py:214-229``)."""

    length: int = 5
    bottleneck: int = 192
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class ViltModelConfig:
    """ViLT-B/32 (HF ``ViltModel``); images sit on a fixed ``image_size``
    canvas so every batch has a static shape."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_text_len: int = 40
    image_size: Tuple[int, int] = (384, 384)
    patch_size: int = 32
    pretrained_image_size: Tuple[int, int] = (384, 384)
    type_vocab_size: int = 2
    modality_type_vocab_size: int = 3
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    adapter: AdapterSpec = AdapterSpec()
    lora: LoraSpec = LoraSpec()
    prompt: PromptSpec = PromptSpec()
    remat: bool = False
    remat_policy: str = "full"
    attention_logits_dtype: str = "float32"
    scan_unroll: int = 1
    # With attn_impl='block': fold norm_before into the attention-block kernel.
    fuse_ln: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size[0] // self.patch_size) * (
            self.image_size[1] // self.patch_size
        )


@dataclasses.dataclass(frozen=True)
class AlbefBertConfig:
    """xBERT (reference ``src/configs/model_configs.py:40-60``): a BERT-base
    whose layers ``>= fusion_layer`` cross-attend to image states."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    fusion_layer: int = 6
    encoder_width: int = 768
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class AlbefModelConfig:
    """ALBEF = ViT-B/16 at 384 px + xBERT encoder + 6-layer LM decoder
    (reference ``src/modeling/models/albef_model.py:12-57``)."""

    image_res: int = 384
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_ratio: float = 4.0
    vision_layer_norm_eps: float = 1e-6
    bert: AlbefBertConfig = AlbefBertConfig()
    decoder_layers: int = 6
    distill: bool = False
    momentum: float = 0.995
    max_question_len: int = 25
    max_answer_len: int = 10
    adapter: AdapterSpec = AdapterSpec()
    lora: LoraSpec = LoraSpec()
    prompt: PromptSpec = PromptSpec()
    remat: bool = False
    remat_policy: str = "full"
    # See ViltModelConfig.fuse_ln (the ViT blocks under attn_impl='block').
    fuse_ln: bool = False
    text_remat: Optional[bool] = None
    text_remat_policy: str = "full"
    attention_logits_dtype: str = "float32"
    # Candidates packed per row in rank_answer's stage-2 decode (a
    # block-diagonal self-attention bias, exact: the -10000 fill underflows
    # exp to 0.0); applied when it divides k, 1 = the reference's layout.
    eval_pack_group: int = 8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + polynomial (linear) decay with warmup (reference
    ``task_trainer.py:477-504``, ``53-59``; hparams from
    ``src/configs/task_configs_fed.py:48-51``)."""

    lr: float = 1e-4
    weight_decay: float = 1e-2
    adam_eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.98
    warmup_ratio: float = 0.1
    # Polynomial decay power (reference uses power=1, i.e. linear).
    power: float = 1.0
    lr_end: float = 0.0


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """Communication-round loop parameters (reference ``src/train/main.py:300-303, 453-558``)."""

    comm_rounds: int = 20
    local_epochs: int = 1
    eval_every: int = 5
    # Per-client FedAvg weights; None means uniform (the reference's ``main.py:455``).
    client_weights: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level experiment config (the argparse surface of ``main.py:262-322``)."""

    encoder_name: str = "vilt"  # vilt | viltbert | albef_distill | albef_no_distill
    peft_mode: PEFTMode = PEFTMode.DAT
    tasks: Tuple[str, ...] = ()
    batch_size: int = 2
    val_batch_size: int = 2
    seed: int = 1
    optimizer: OptimizerConfig = OptimizerConfig()
    federated: FederatedConfig = FederatedConfig()
    # Scheduler horizon epochs (``max_steps = len(loader) * num_epochs``).
    num_epochs: int = 1
    layers_to_freeze: int = 2
    # Compute dtype for matmuls; params always live in fp32.
    dtype: str = "bfloat16"
    single_task: bool = False
    debug_steps: int = 0
    # Bit generator for dropout masks in the JAX package ("threefry" or the
    # TPU's "rbg"); the port draws from a seeded torch.Generator either way.
    dropout_rng: str = "threefry"


def adapter_spec_for_mode(mode: PEFTMode, reduction_factor: int = 16) -> AdapterSpec:
    """Adapter names per PEFT mode (reference ``main.py:105-118``)."""
    if mode == PEFTMode.DAT:
        return AdapterSpec(
            names=("adapter_0", "adapter_1", "adapter_2"),
            reduction_factor=reduction_factor,
        )
    if mode == PEFTMode.ADAPTER:
        return AdapterSpec(names=("adapter",), reduction_factor=reduction_factor)
    return AdapterSpec()
