"""PyTorch/CUDA port of ``feddat_tpu`` for NVIDIA Hopper (H100).

The JAX package ``feddat_tpu`` stays the reference: every module here names
its counterpart there and is tested against it on the CPU
(``tests/test_torch_*.py``).  This package imports ``torch``, ``numpy`` and
``PIL`` only — never ``jax``, ``flax`` or ``feddat_tpu``.

Entry points (``models.create_model``, ``serving.ViltVqaPredictor``) run on
the CUDA device unless the caller passes ``device="cpu"``; without CUDA
they raise instead of carrying on on the CPU (see :mod:`.device`).

The Pallas kernels of the JAX package become hand-written CUDA C++ kernels
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at their first launch
(``ops/_build.py``).
"""

from feddat_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
