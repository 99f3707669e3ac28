"""Synthetic heterogeneous-federation accuracy study (counterpart of
``feddat_tpu/study.py``).

The study trains the real engines on a controlled synthetic federation and
tabulates cross-seed results with the tabulator used for real runs
(``feddat_tpu_torch.utils.results``).  It checks the *mechanism* the FedDAT
paper claims (arXiv:2308.12305): that the federated DAT stack (triple
adapters, teacher refresh, MKD, personalization store, FedAvg, 3-mode eval)
learns under client heterogeneity, and that its dual-adapter design beats the
single-shared-adapter baseline where clients hold conflicting concepts.  Its
data comes from numpy and its frozen backbone is random-init from ``seed``,
so nothing is downloaded.  Each client mixes two concepts:

  * a SHARED concept: the answer is a fixed function of a question token,
    identical for every client (federation helps: the clients' gradients
    agree);
  * a PERSONAL concept: the answer is the image's dominant color channel
    through a CLIENT-SPECIFIC brightness-conditioned rotation (client k
    rotates the channel->answer map when mean brightness exceeds its own
    threshold t_k).  The mapping is nonlinear and conflicts across clients,
    so per-client adapter capacity (DAT's ``adapter_0``) is what it rewards.

Modes compared (reference ``--optimizer_mode`` names): ``none`` (personal
head only), ``adapter`` (one FedAvg'd shared adapter + personal head),
``dat`` (shared ``adapter_1`` + personal ``adapter_0`` + fixed-0.5 ensemble
+ MKD).  Scores are the reference's VQA metric (one-hot targets -> plain
accuracy); DAT rows report the ensemble-mode score (``final_scores``).

The clients are copies of the JAX package's: their arrays and batches are
bitwise JAX's under the same seeds.  The models are the port's, at the same
configurations: full width on the card (kernel routes ``"block"`` or
``"layer"``, bf16), tiny shapes in fp32 on ``"auto"`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from feddat_tpu_torch.configs.core import (
    AlbefBertConfig,
    AlbefModelConfig,
    FederatedConfig,
    LoraSpec,
    OptimizerConfig,
    PEFTMode,
    PromptSpec,
    TrainConfig,
    ViltModelConfig,
    adapter_spec_for_mode,
)
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.models.albef import AlbefModel, init_albef_params
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner, init_vilt_params
from feddat_tpu_torch.train.evaluation import make_albef_eval_step
from feddat_tpu_torch.train.forwards import make_albef_forward
from feddat_tpu_torch.utils.results import mean_std_table

# label space: [0, K) shared-concept answers, [K, K+3) personal-concept
# answers (dominant-channel classes), padded to NUM_LABELS
K_SHARED = 8
NUM_LABELS = 16
PERSONAL_Q_TOKEN = 4  # question token announcing the personal concept
SHARED_Q_BASE = 5  # shared-concept questions use tokens [5, 5+K_SHARED)


@dataclasses.dataclass
class HeterogeneousVQAClient:
    """One synthetic client mixing shared + client-personal concepts.

    Batch schema matches the real ViLT pipeline (the ClientData protocol of
    both engines).  ``brightness_threshold`` is the client-specific t_k that
    conditions the personal concept's channel->answer rotation.
    """

    task_key: str
    client_idx: int
    num_train: int = 256
    num_eval: int = 128
    vocab_size: int = 30522
    text_len: int = 40
    # full-width ViLT-B/32 at a reduced canvas: the study probes accuracy
    # mechanics, not sequence-length throughput
    image_size: Tuple[int, int] = (192, 192)
    batch_size: int = 32
    val_batch_size: int = 32
    seed: int = 0
    personal_fraction: float = 0.5

    def __post_init__(self):
        rng = np.random.RandomState(self.seed * 997 + self.client_idx)
        n = self.num_train + self.num_eval
        H, W = self.image_size
        self.brightness_threshold = 0.35 + 0.1 * self.client_idx

        is_personal = rng.rand(n) < self.personal_fraction
        # questions: token_0 carries the concept; the tail is random filler
        self.input_ids = rng.randint(
            SHARED_Q_BASE + K_SHARED, max(self.vocab_size, 32), size=(n, self.text_len)
        ).astype(np.int32)
        self.input_ids = np.minimum(self.input_ids, self.vocab_size - 1)
        self.attention_mask = np.ones((n, self.text_len), np.int32)

        answers = np.zeros(n, np.int64)
        # fp16 storage: full-scale clients hold hundreds of images; the
        # iterators upcast per batch (the model computes in bf16 anyway)
        self.pixel_values = np.empty((n, H, W, 3), np.float16)
        shared_tokens = rng.randint(0, K_SHARED, size=n)
        dominant = rng.randint(0, 3, size=n)
        brightness = rng.uniform(0.1, 0.9, size=n)
        for i in range(n):
            img = rng.randn(H, W, 3).astype(np.float32) * 0.05 + brightness[i]
            if is_personal[i]:
                self.input_ids[i, 0] = PERSONAL_Q_TOKEN
                img[..., dominant[i]] += 1.0  # the visible dominant channel
                rot = 1 if brightness[i] > self.brightness_threshold else 0
                answers[i] = K_SHARED + (dominant[i] + rot) % 3
            else:
                self.input_ids[i, 0] = SHARED_Q_BASE + shared_tokens[i]
                answers[i] = shared_tokens[i]
            self.pixel_values[i] = img
        self.answers = answers
        self.target_scores = np.zeros((n, NUM_LABELS), np.float32)
        self.target_scores[np.arange(n), answers] = 1.0

    # -- ClientData protocol -------------------------------------------------
    @property
    def num_train_examples(self) -> int:
        return self.num_train

    @property
    def num_eval_examples(self) -> int:
        return self.num_eval

    @property
    def steps_per_epoch(self) -> int:
        return self.num_train // self.batch_size

    def train_batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(self.num_train)
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size : (s + 1) * self.batch_size]
            yield {
                "input_ids": self.input_ids[sel],
                "attention_mask": self.attention_mask[sel],
                "pixel_values": self.pixel_values[sel].astype(np.float32),
                "target_scores": self.target_scores[sel],
            }

    def eval_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        start, n, bs = self.num_train, self.num_eval, self.val_batch_size
        for s in range(0, n, bs):
            sel = np.arange(start + s, start + min(s + bs, n))
            pad = bs - len(sel)
            valid = np.concatenate([np.ones(len(sel)), np.zeros(pad)]).astype(np.float32)
            sel = np.concatenate([sel, np.full(pad, start, dtype=sel.dtype)])
            yield {
                "input_ids": self.input_ids[sel],
                "attention_mask": self.attention_mask[sel],
                "pixel_values": self.pixel_values[sel].astype(np.float32),
                "target_scores": self.target_scores[sel],
                "valid": valid,
            }


@dataclasses.dataclass
class HeterogeneousAlbefClient:
    """ALBEF-family variant of :class:`HeterogeneousVQAClient`: the same
    shared/personal concept split, expressed as answer-ranking batches over
    a dense answer bank (8 shared + 3 personal answers, each a distinct
    token sequence).  Question token 1 announces the concept."""

    task_key: str
    client_idx: int
    num_train: int = 128
    num_eval: int = 64
    vocab_size: int = 30522
    question_len: int = 25
    answer_len: int = 10
    image_size: Tuple[int, int] = (384, 384)
    batch_size: int = 16
    val_batch_size: int = 16
    seed: int = 0
    personal_fraction: float = 0.5
    pad_token_id: int = 0
    bos_token_id: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed * 997 + self.client_idx)
        n = self.num_train + self.num_eval
        H, W = self.image_size
        bank = K_SHARED + 3
        self.brightness_threshold = 0.35 + 0.1 * self.client_idx
        # answer bank: answer a = [BOS, 2+a, 3+a] (distinct 2-token bodies)
        self.answer_ids = np.zeros((bank, self.answer_len), np.int32)
        self.answer_mask = np.zeros((bank, self.answer_len), np.int32)
        for a in range(bank):
            self.answer_ids[a, :3] = [self.bos_token_id, 2 + a, 3 + a]
            self.answer_mask[a, :3] = 1

        is_personal = rng.rand(n) < self.personal_fraction
        # concept tokens live above the answer-token range
        concept_base = 2 + bank + 4
        self.question_ids = rng.randint(
            concept_base + K_SHARED + 2, max(self.vocab_size, concept_base + K_SHARED + 8),
            size=(n, self.question_len),
        ).astype(np.int32)
        self.question_ids = np.minimum(self.question_ids, self.vocab_size - 1)
        self.question_ids[:, 0] = self.bos_token_id
        self.question_mask = np.ones((n, self.question_len), np.int32)

        gt = np.zeros(n, np.int64)
        self.pixel_values = np.empty((n, H, W, 3), np.float16)
        shared_tokens = rng.randint(0, K_SHARED, size=n)
        dominant = rng.randint(0, 3, size=n)
        brightness = rng.uniform(0.1, 0.9, size=n)
        for i in range(n):
            img = rng.randn(H, W, 3).astype(np.float32) * 0.05 + brightness[i]
            if is_personal[i]:
                self.question_ids[i, 1] = concept_base
                img[..., dominant[i]] += 1.0
                rot = 1 if brightness[i] > self.brightness_threshold else 0
                gt[i] = K_SHARED + (dominant[i] + rot) % 3
            else:
                self.question_ids[i, 1] = concept_base + 1 + shared_tokens[i]
                gt[i] = shared_tokens[i]
            self.pixel_values[i] = img
        self.gt = gt

    @property
    def num_train_examples(self) -> int:
        return self.num_train

    @property
    def num_eval_examples(self) -> int:
        return self.num_eval

    @property
    def steps_per_epoch(self) -> int:
        return self.num_train // self.batch_size

    def train_batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(self.num_train)
        La = self.answer_len
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size : (s + 1) * self.batch_size]
            B = len(sel)
            ans_ids = np.zeros((B, 1, La), np.int32)
            ans_mask = np.zeros((B, 1, La), np.int32)
            for i, j in enumerate(sel):
                ans_ids[i, 0] = self.answer_ids[self.gt[j]]
                ans_mask[i, 0] = self.answer_mask[self.gt[j]]
            yield {
                "pixel_values": self.pixel_values[sel].astype(np.float32),
                "question_ids": self.question_ids[sel],
                "question_mask": self.question_mask[sel],
                "answer_ids": ans_ids,
                "answer_mask": ans_mask,
                "answer_weights": np.ones((B, 1), np.float32),
            }

    def eval_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        start, n, bs = self.num_train, self.num_eval, self.val_batch_size
        for s in range(0, n, bs):
            sel = np.arange(start + s, start + min(s + bs, n))
            pad = bs - len(sel)
            valid = np.concatenate([np.ones(len(sel)), np.zeros(pad)]).astype(np.float32)
            sel = np.concatenate([sel, np.full(pad, start, dtype=sel.dtype)])
            yield {
                "pixel_values": self.pixel_values[sel].astype(np.float32),
                "question_ids": self.question_ids[sel],
                "question_mask": self.question_mask[sel],
                "gt_labels": self.gt[sel][:, None],
                "valid": valid,
            }


def _study_model(mode, full_scale: bool, num_clients: int, attn_impl=None):
    """-> (ViltContinualLearner on the meta device, config); ``_build_family``
    places it and draws its weights."""
    spec = adapter_spec_for_mode(mode)
    lora = LoraSpec(enabled=(mode == PEFTMode.LORA))
    prompt = PromptSpec(enabled=(mode == PEFTMode.PROMPT))
    # the attn-block kernel's frozen-projection contract excludes the modes
    # that train the backbone projections (same guard as create_model)
    block_ok = mode not in (
        PEFTMode.FULL, PEFTMode.BIAS, PEFTMode.LORA, PEFTMode.FREEZE_BOTTOM_K
    )
    if full_scale:
        # Mirror create_model's NORM guards: the fused-LN kernel assumes
        # FROZEN LayerNorms (norm_before grads would silently vanish), and
        # the whole-layer kernel freezes norm_after/adapter-LNs too — NORM
        # must keep the LNs outside any kernel that owns their backward.
        if mode == PEFTMode.NORM and attn_impl == "layer":
            raise ValueError("attn_impl='layer' is incompatible with PEFT mode 'norm'")
        cfg = ViltModelConfig(
            adapter=spec,
            lora=lora,
            prompt=prompt,
            image_size=(192, 192),
            remat=True,
            remat_policy="block_save_nox" if block_ok else "full",
            attention_logits_dtype="bfloat16",
            fuse_ln=(block_ok and mode != PEFTMode.NORM),
        )
        dtype, attn_impl = torch.bfloat16, ((attn_impl or "block") if block_ok else "auto")
    else:
        cfg = ViltModelConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_text_len=8, image_size=(32, 32),
            patch_size=16, adapter=spec,
            lora=dataclasses.replace(lora, rank=2),
            prompt=dataclasses.replace(prompt, length=2, bottleneck=8),
        )
        dtype, attn_impl = torch.float32, "auto"  # tiny shapes: kernels don't apply
    heads = {f"client_{i}": TaskHeadSpec(num_labels=NUM_LABELS) for i in range(num_clients)}
    with torch.device("meta"):
        model = ViltContinualLearner(cfg, heads, dtype=dtype, attn_impl=attn_impl)
    return model, cfg


def _study_albef_model(mode, full_scale: bool, attn_impl=None):
    """-> (AlbefModel on the meta device, config); ``_build_family`` places
    it and draws its weights."""
    spec = adapter_spec_for_mode(mode)
    if full_scale:
        # same NORM guards as _study_model / create_model: trainable LNs
        # must stay outside the fused-LN / whole-layer kernels
        if mode == PEFTMode.NORM and attn_impl == "layer":
            raise ValueError("attn_impl='layer' is incompatible with PEFT mode 'norm'")
        cfg = AlbefModelConfig(
            adapter=spec,
            remat=True,
            remat_policy="block_save_nox",
            attention_logits_dtype="bfloat16",
            fuse_ln=(mode != PEFTMode.NORM),
            # a pure checkpointing change (the same gradients); it saves the
            # fusion layers' recompute of the S=577 image keys and values
            text_remat_policy="names",
        )
        with torch.device("meta"):
            model = AlbefModel(cfg, dtype=torch.bfloat16, vision_attn_impl=attn_impl or "block")
        return model, cfg
    # encoder_width: the ViT's width, which flax infers at init and the
    # port's cross-attention is built with
    cfg = AlbefModelConfig(
        image_res=32, patch_size=16, vision_width=32, vision_layers=2, vision_heads=4,
        bert=AlbefBertConfig(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                             intermediate_size=64, fusion_layer=2, encoder_width=32),
        decoder_layers=2, max_question_len=8, max_answer_len=6,
        adapter=spec,
    )
    with torch.device("meta"):
        model = AlbefModel(cfg, dtype=torch.float32)
    return model, cfg


def run_study(
    modes: Sequence[str] = ("none", "adapter", "dat"),
    seeds: Sequence[int] = (0, 1, 2),
    num_clients: int = 4,
    comm_rounds: int = 8,
    full_scale: bool | None = None,
    lr: float = 5e-3,
    out_dir: str | None = None,
    family: str = "vilt",
    attn_impl: str | None = None,
    device: DeviceLike = None,
) -> Dict[str, Dict]:
    """-> {mode: {"table": mean±std per task, "histories": [...]}}.

    ``device`` defaults to the CUDA card and raises without one
    (``device.resolve_device``).  ``full_scale=None`` auto-selects: real
    model shapes on the card, tiny shapes on the CPU.  Data is PAIRED across
    modes (same seed -> identical clients), so mode deltas are not data
    noise.  ``family``: 'vilt' (classification VQA) or 'albef'
    (answer-ranking VQA).  ``attn_impl`` overrides the full-scale attention
    route for kernel-eligible modes ('block' default: #1 forward, #3
    backward; 'layer': #1 and the whole-layer backward #4; 'auto': the plain
    route, no kernel).
    """
    dev = resolve_device(device)
    if family not in ("vilt", "albef"):
        raise ValueError(f"unknown family {family!r}")
    if full_scale is None:
        full_scale = dev.type == "cuda"

    results: Dict[str, Dict] = {}
    for mode_name in modes:
        mode = PEFTMode(mode_name)
        histories: List[List[dict]] = []
        for seed in seeds:
            clients = _make_clients(family, full_scale, num_clients, seed)
            model, params, engine_kw = _build_family(
                family, mode, full_scale, num_clients, clients, seed,
                attn_impl=attn_impl, device=dev,
            )
            cfg = TrainConfig(
                encoder_name="albef_no_distill" if family == "albef" else "vilt",
                peft_mode=mode,
                optimizer=OptimizerConfig(lr=lr),
                federated=FederatedConfig(
                    comm_rounds=comm_rounds, local_epochs=1, eval_every=comm_rounds
                ),
                num_epochs=comm_rounds,
                dtype="bfloat16" if full_scale else "float32",
                seed=seed,
            )
            trainer = FederatedTrainer(model, params, clients, cfg, device=dev, **engine_kw)
            history = trainer.run(resume=False)
            histories.append(history)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                with open(
                    os.path.join(
                        out_dir,
                        f"{family + '_' if family != 'vilt' else ''}"
                        f"{mode_name}_seed{seed}.history.json",
                    ),
                    "w",
                ) as f:
                    json.dump(history, f)
            # the next run builds its own model and graphs: free this one's
            del trainer, model, params, engine_kw, clients
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        results[mode_name] = {
            "table": mean_std_table(histories),
            "histories": histories,
        }
    return results


def _make_clients(family: str, full_scale: bool, num_clients: int, seed: int):
    if family == "vilt":
        if full_scale:
            return {
                f"client_{i}": HeterogeneousVQAClient(
                    task_key=f"client_{i}", client_idx=i, seed=seed
                )
                for i in range(num_clients)
            }
        return {
            f"client_{i}": HeterogeneousVQAClient(
                task_key=f"client_{i}", client_idx=i, seed=seed,
                num_train=32, num_eval=16, vocab_size=64, text_len=8,
                image_size=(32, 32), batch_size=8, val_batch_size=8,
            )
            for i in range(num_clients)
        }
    if full_scale:
        return {
            f"client_{i}": HeterogeneousAlbefClient(
                task_key=f"client_{i}", client_idx=i, seed=seed
            )
            for i in range(num_clients)
        }
    return {
        f"client_{i}": HeterogeneousAlbefClient(
            task_key=f"client_{i}", client_idx=i, seed=seed,
            num_train=16, num_eval=8, vocab_size=64, question_len=8,
            answer_len=6, image_size=(32, 32), batch_size=4, val_batch_size=4,
        )
        for i in range(num_clients)
    }


def _build_family(family, mode, full_scale, num_clients, clients, seed,
                  attn_impl=None, device: DeviceLike = None):
    """-> (model, params, FederatedTrainer kwargs) for the study family: the
    model on ``device`` (default the card) with weights drawn from ``seed``
    in the JAX package's initialisation scheme, ``params`` its state_dict."""
    dev = resolve_device(device)
    if family == "vilt":
        model, _cfg = _study_model(mode, full_scale, num_clients, attn_impl)
        model = init_vilt_params(model.to_empty(device=dev), seed)
        return model, model.state_dict(), {}

    model, _cfg = _study_albef_model(mode, full_scale, attn_impl)
    model = init_albef_params(model.to_empty(device=dev), seed)

    def make_forward(mdl, task_key):
        return make_albef_forward(mdl)

    def make_eval(mdl, task_key):
        c = clients[task_key]
        return make_albef_eval_step(mdl, c.answer_ids, c.answer_mask, k=4)

    return model, model.state_dict(), {"make_forward": make_forward, "make_eval": make_eval}


def format_study(results: Dict[str, Dict]) -> str:
    """Markdown table: rows = modes, columns = per-task mean±std + average."""
    tasks = [t for t in next(iter(results.values()))["table"] if t != "average"]
    header = "| mode | " + " | ".join(tasks) + " | average |"
    sep = "|" + "---|" * (len(tasks) + 2)
    lines = [header, sep]
    for mode_name, r in results.items():
        row = [mode_name]
        for t in tasks + ["average"]:
            cell = r["table"].get(t)
            row.append(f"{cell['mean']:.3f} ± {cell['std']:.3f}" if cell else "—")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)
