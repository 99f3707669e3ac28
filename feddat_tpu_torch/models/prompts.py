"""Reparameterized prompt tuning (counterpart of ``feddat_tpu/models/prompts.py``).

Reference ``src/train/main.py:214-229`` + ``src/modeling/prompted_output.py``:
prompt length 5, the embedding reparameterized through a bottleneck MLP
(``Embedding(P, d) -> Linear(d, d/4) -> Tanh -> Linear(d/4, d)``), spliced
into the token streams right after the CLS position with matching mask
extension.  Each stream has its own module (``prompt_text``, ``prompt_vis``),
as in the JAX package.  Child names follow the flax paths (``prompt_embed``,
``prompt_down``, ``prompt_up``), so ``utils/param_bridge.py`` maps them.
"""

from __future__ import annotations

import torch
from torch import nn

from feddat_tpu_torch.configs.core import PromptSpec
from feddat_tpu_torch.models.adapters import dense


class ReparamPrompt(nn.Module):
    """-> [length, hidden] prompt embeddings in ``dtype``.  Initialised by
    ``models/vilt.py::init_vilt_params`` with the JAX inits (torch's defaults):
    embedding N(0, 1), Linear weights and biases U(±1/√fan_in)."""

    def __init__(self, spec: PromptSpec, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.prompt_embed = nn.Embedding(spec.length, hidden_size)
        self.prompt_down = nn.Linear(hidden_size, spec.bottleneck)
        self.prompt_up = nn.Linear(spec.bottleneck, hidden_size)

    def forward(self) -> torch.Tensor:
        x = self.prompt_embed.weight.to(self.dtype)  # every token, in order
        x = torch.tanh(dense(x, self.prompt_down, self.dtype))
        return dense(x, self.prompt_up, self.dtype)


def splice_after_cls(tokens: torch.Tensor, mask: torch.Tensor, prompt: torch.Tensor):
    """Insert [P, d] prompts after position 0 of [B, S, d] tokens; extend the
    {0,1} [B, S] mask with ones -> ([B, S+P, d], [B, S+P])."""
    b = tokens.shape[0]
    p = prompt[None].expand(b, *prompt.shape).to(tokens.dtype)
    out = torch.cat([tokens[:, :1], p, tokens[:, 1:]], dim=1)
    pm = torch.ones((b, prompt.shape[0]), dtype=mask.dtype, device=mask.device)
    return out, torch.cat([mask[:, :1], pm, mask[:, 1:]], dim=1)
