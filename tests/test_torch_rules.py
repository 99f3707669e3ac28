"""Rules of the port that hold on any host:

* nothing in ``feddat_tpu_torch/`` or ``chip_smoke.py`` imports ``jax``,
  ``flax`` or ``feddat_tpu``;
* entry points need the card unless the caller passes ``device="cpu"``;
* a CUDA kernel wrapper given CPU tensors raises instead of running the
  plain version, and ``attn_impl`` values of later slices raise.
"""

import ast
import pathlib

import pytest
import torch

from feddat_tpu_torch.configs.core import PEFTMode
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.device import resolve_device
from feddat_tpu_torch.models import create_model
from feddat_tpu_torch.models.layers import PreLNLayer
from feddat_tpu_torch.configs.core import AdapterSpec
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner
from feddat_tpu_torch.ops import adapter_fused as af
from feddat_tpu_torch.ops import attn_block as ab
from feddat_tpu_torch.serving import ViltVqaPredictor

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "feddat_tpu")


def _port_files():
    return sorted((ROOT / "feddat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = {f"{f.relative_to(ROOT)}: {m}" for f in files for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, sorted(bad)
    assert "feddat_tpu_torch" in set(_imported_roots(ROOT / "chip_smoke.py"))


def _skip_on_a_cuda_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_entry_points_raise_without_cuda():
    _skip_on_a_cuda_host()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("vilt", {"t": TaskHeadSpec(2)}, PEFTMode.DAT)
    tiny = ViltContinualLearner.__new__(ViltContinualLearner)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViltVqaPredictor(tiny, None, "t", WordPieceTokenizer.toy(["a"]), ["x"])


def test_kernel_wrappers_refuse_cpu_tensors():
    _skip_on_a_cuda_host()
    x = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    w = torch.zeros(128, 128, dtype=torch.bfloat16)
    before = (ab.KERNEL.launches, af.KERNEL.launches)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ab.attn_block_cuda(x, w, w, w, w, torch.zeros(3, 128), torch.zeros(1, 128), None, None, 2)
    params = (torch.zeros(128, 8), torch.zeros(8), torch.zeros(8, 128), torch.zeros(128))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        af.adapter_fused_cuda(x, params, params, 0.5)
    assert (ab.KERNEL.launches, af.KERNEL.launches) == before


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback on a build failure: loading a kernel library raises with
    what the compiler printed (a stand-in compiler that always fails)."""
    from feddat_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'attn_block.cu(1): error: stand-in failure' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="stand-in failure"):
        _build.load("attn_block")
    assert _build._LIBS == {} and not list((tmp_path / "build").glob("*.so"))


def test_attn_impls_of_later_slices_raise():
    spec = AdapterSpec(names=("adapter_0",), reduction_factor=4)
    for impl in ("layer", "fused", "flash"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PreLNLayer(32, 4, 64, spec, attn_impl=impl)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        PreLNLayer(32, 4, 64, spec, attn_impl="xla-typo")
