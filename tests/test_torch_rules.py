"""Rules of the port that hold on any host:

* nothing in ``feddat_tpu_torch/``, ``chip_smoke.py`` or the port's scripts
  (``scripts/torch_*.py``) imports ``jax``, ``flax`` or ``feddat_tpu``;
* entry points (model, predictors and their ``from_checkpoint``, the batch
  prefetch, the CLI) need the card unless the caller passes ``device="cpu"``;
* a CUDA kernel wrapper given CPU tensors raises instead of running the
  plain version, and an unknown ``attn_impl`` raises;
* no port module draws randomness from torch's global RNG: no
  ``F.dropout``/``nn.Dropout``, and every ``torch.rand``/``randn``/
  ``randint``/``bernoulli`` call names its ``generator``.
"""

import ast
import pathlib

import numpy as np
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
from feddat_tpu_torch.ops import flash as fl
from feddat_tpu_torch.ops import fused_attention as fa
from feddat_tpu_torch.ops import layer_block as lb
from feddat_tpu_torch.serving import AlbefVqaPredictor, ViltVqaPredictor

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "feddat_tpu")


def _port_files():
    return (sorted((ROOT / "feddat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


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
    scripts = {f.name for f in files if f.parent.name == "scripts"}
    assert {"torch_accuracy_study.py", "torch_kernel_ab.py", "torch_spmd_cards.py"} <= scripts


def _skip_on_a_cuda_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_entry_points_raise_without_cuda(tmp_path):
    _skip_on_a_cuda_host()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("vilt", {"t": TaskHeadSpec(2)}, PEFTMode.DAT)
    tiny = ViltContinualLearner.__new__(ViltContinualLearner)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViltVqaPredictor(tiny, None, "t", WordPieceTokenizer.toy(["a"]), ["x"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("albef_no_distill", {}, PEFTMode.DAT, dtype="bfloat16", attn_impl="flash")
    from feddat_tpu_torch.models.albef import AlbefModel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlbefVqaPredictor(AlbefModel.__new__(AlbefModel), None, WordPieceTokenizer.toy(["a"]), ["x"])
    # the device is resolved before the checkpoint directory is read
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViltVqaPredictor.from_checkpoint("no-such-checkpoint", WordPieceTokenizer.toy(["a"]), ["x"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlbefVqaPredictor.from_checkpoint("no-such-checkpoint", WordPieceTokenizer.toy(["a"]))
    from feddat_tpu_torch.data.pipeline import prefetch_to_device

    batches = iter([{"x": np.zeros(2, np.float32)}])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefetch_to_device(batches)
    assert next(batches)["x"].shape == (2,)  # refused before the producer started
    from feddat_tpu_torch import cli

    # without --device cpu, before the logger, the model or a dataset
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--encoder_name", "vilt", "--output_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


def test_kernel_wrappers_refuse_cpu_tensors():
    _skip_on_a_cuda_host()
    x = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    w = torch.zeros(128, 128, dtype=torch.bfloat16)
    before = (ab.KERNEL.launches, af.KERNEL.launches)
    assert (ab.KERNEL_BWD.launches, lb.KERNEL.launches) == (0, 0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ab.attn_block_cuda(x, w, w, w, w, torch.zeros(3, 128), torch.zeros(1, 128), None, None, 2)
    params = (torch.zeros(128, 8), torch.zeros(8), torch.zeros(8, 128), torch.zeros(128))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        af.adapter_fused_cuda(x, params, params, 0.5)
    lse, f32 = torch.zeros(1, 2, 4), torch.zeros(3, 128)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ab.attn_block_bwd_cuda(x, w, w, w, w, f32, None, None, x, lse, x, 2)
    ln, adapter = torch.zeros(2, 128), (torch.zeros(128, 8), torch.zeros(1, 8),
                                         torch.zeros(8, 128), torch.zeros(1, 128))
    for layer_bwd in (lb.layer_block_bwd_cuda, lb.layer_block_bwd_cuda_stages):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            layer_bwd(x, x, x, lse, x, None, w, w, w, w, f32, ln, ln,
                      torch.zeros(256, 128), torch.zeros(1, 256), torch.zeros(128, 256),
                      torch.zeros(1, 128), *adapter, *adapter, 2, None, 1e-12, 1e-12,
                      1.0, 0.0, False)
    heads = torch.zeros(1, 2, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.fused_attention_fwd_cuda(heads, heads, heads, None, 0.125)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.fused_attention_bwd_cuda(heads, heads, heads, None, heads, heads, lse, 0.125)
    flash_before = fl.KERNEL.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fl.flash_attention_fwd_cuda(heads, heads[:, :, :3], heads[:, :, :3], None, 0.125)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fl.flash_attention_bwd_cuda(heads, heads, heads, None, heads, heads, lse, 0.125)
    with pytest.raises(TypeError, match="k must be q's torch.float32"):
        fl.flash_attention_bwd_cuda(heads.float(), heads, heads, None, heads, heads, lse, 0.125)
    with pytest.raises(TypeError, match="torch.bfloat16 or torch.float32, got torch.float16"):
        fl.flash_attention_bwd_cuda(heads.half(), heads, heads, None, heads, heads, lse, 0.125)
    assert (fl.KERNEL_BWD_DQ.launches, fl.KERNEL_BWD_DKV.launches) == (0, 0)
    assert (ab.KERNEL.launches, af.KERNEL.launches, ab.KERNEL_BWD.launches,
            lb.KERNEL.launches, fa.KERNEL.launches, fa.KERNEL_BWD.launches) == before + (0, 0, 0, 0)
    assert fl.KERNEL.launches == flash_before


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


def test_editing_a_shared_header_changes_the_library_path(tmp_path, monkeypatch):
    """Every ``csrc/*.cuh`` is part of each library's hash, so an edited
    header never loads a stale build."""
    from feddat_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (csrc / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    (csrc / "other.cuh").write_text("// new header\n")
    assert len({first, second, _build.library_path("k")}) == 3
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == ["k.cu"]


def test_a_library_with_parts_links_each_source_compiled_apart(tmp_path, monkeypatch):
    """A library with parts (``_build.PARTS``): each source is compiled to an
    object of its own with its own flags (``-c``, no ``-shared``), all at
    once, and the objects are linked into the one library; the part's source
    is in the library's hash and is no library of its own."""
    from feddat_tpu_torch.ops import _build

    csrc, calls = tmp_path / "csrc", tmp_path / "calls"
    csrc.mkdir()
    for name in ("lib_main", "lib_part"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"  # writes its -o file and logs its arguments
    fake.write_text(f'#!/bin/sh\necho "$@" >> {calls}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info    : Used 1 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "PARTS", {"lib_main": ("lib_part",)})
    monkeypatch.setattr(_build, "_PART_OF", {"lib_part": "lib_main"})
    monkeypatch.setattr(_build, "SPLIT_COMPILE", ("lib_part",))
    assert _build.sources() == ["lib_main"]
    before = _build.library_path("lib_main")
    reports = _build.build()
    assert list(reports) == ["lib_main"] and before.exists()
    cmds = [ln.split() for ln in calls.read_text().splitlines()]  # the compiles in any order, then the link
    main, part = (next(c for c in cmds if c[-1].endswith(f"{n}.cu")) for n in ("lib_main", "lib_part"))
    link = cmds[-1]
    assert len(cmds) == 3 and all("-c" in c and "-shared" not in c for c in (main, part))
    assert "--split-compile=0" not in main and "--split-compile=0" in part
    assert "-shared" in link and sorted(a for a in link if a.endswith(".o")) == \
        sorted(c[c.index("-o") + 1] for c in (main, part))
    assert not list((tmp_path / "build").glob("*.o"))
    (csrc / "lib_part.cu").write_text("// edited\n")
    assert _build.library_path("lib_main") != before


def test_ptxas_summary_gives_each_kernel_its_registers_and_spills():
    """The build report that chip_smoke.py and the A/B script print: one line
    per kernel of an ``nvcc -Xptxas -v`` log (here two lines of the form ptxas
    writes), with the mangled name made readable."""
    from feddat_tpu_torch.ops import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4port4sm9016gemm_sm90_kernelILi0ELi3EEEvNS_8GemmArgsE'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4port4sm9016gemm_sm90_kernelILi0ELi3EEEvNS_8GemmArgsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 112 registers, used 1 barriers",
        "ptxas info    : Function properties for "
        "_ZN51_GLOBAL__N__57dd581c_18_flash_attention_cu_da77f36219flash_bwd_dq_kernelE12FlashBwdArgsi",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size",
    ])
    assert _build.ptxas_summary(log) == [
        "port::sm90::gemm_sm90_kernel<0, 3>: 112 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_bwd_dq_kernel: 128 registers; 8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
    ]


@pytest.mark.parametrize("symbol,name", [
    ("_ZN4port4sm9016gemm_sm90_kernelILi1ELi2EfEEvNS_8GemmArgsE", "port::sm90::gemm_sm90_kernel<1, 2, float>"),
    ("_ZN51_GLOBAL__N__57dd581c_18_flash_attention_cu_da77f36216flash_fwd_kernelI13__nv_bfloat16Li2EEEv"
     "NS_9FlashArgsIT_EEi", "flash_fwd_kernel<bf16, 2>"),
    ("_ZN51_GLOBAL__N__57dd581c_18_flash_attention_cu_da77f36219flash_bwd_dq_kernelIfLi1EEEvNS_12FlashBwdArgs"
     "IT_EEi", "flash_bwd_dq_kernel<float, 1>"),
    ("_ZN4port19split3_heads_kernelENS_5HeadsIKfEEP13__nv_bfloat16iix", "port::split3_heads_kernel"),
    ("_ZN4portL19split3_heads_kernelENS_5HeadsIKfEEP13__nv_bfloat16iix", "port::split3_heads_kernel"),
    ("_ZN44_GLOBAL__N__57dd581c_11_flash_dp_cu_0a1b2c3d23flash_dp_bwd_dkv_kernelILi80EEEvN4por"
     "t4anyd7AnyArgsI13__nv_bfloat16EEii", "flash_dp_bwd_dkv_kernel<80>"),
])
def test_ptxas_summary_names_each_template_instance(symbol, name):
    """Kernels that are templates over the element type and a ring depth
    print each instance with its arguments, so ptxas's report tells the bf16
    and float32 instances apart."""
    from feddat_tpu_torch.ops import _build

    log = (f"ptxas info    : Function properties for {symbol}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers")
    assert _build.ptxas_summary(log) == [
        f"{name}: 64 registers; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]


def test_attn_impls_of_later_slices_raise():
    """Every attn_impl of the JAX package is ported ("flash" in slice 4, with
    kernel #7); an unknown value still raises."""
    spec = AdapterSpec(names=("adapter_0",), reduction_factor=4)
    assert PreLNLayer(32, 4, 64, spec, attn_impl="flash").attention.attn_impl == "flash"
    for impl in ("xla", "fused"):  # the composable route, with kernels #5/#6 for "fused"
        assert PreLNLayer(32, 4, 64, spec, attn_impl=impl).attention.attn_impl == impl
    with pytest.raises(ValueError, match="unknown attn_impl"):
        PreLNLayer(32, 4, 64, spec, attn_impl="xla-typo")
    with pytest.raises(ValueError, match="unknown attention impl"):
        from feddat_tpu_torch.ops.attention import dot_product_attention

        x = torch.zeros(1, 1, 2, 8)
        dot_product_attention(x, x, x, impl="flash-typo")


# torch's sampling functions, and the tensor methods that sample in place
TORCH_RANDOM = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like", "randperm",
                "bernoulli", "normal", "multinomial"}
TENSOR_RANDOM = {"bernoulli_", "normal_", "uniform_", "random_", "exponential_", "cauchy_"}


def _samples(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and (
        f.attr in TENSOR_RANDOM or (f.attr in TORCH_RANDOM and isinstance(f.value, ast.Name)
                                    and f.value.id == "torch"))


def test_no_global_rng_in_the_port():
    """Dropout masks (and every other draw) come from explicit generators:
    the step's output is a function of its state, not of torch.manual_seed."""
    bad = []
    for f in sorted((ROOT / "feddat_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Attribute) and node.attr in ("dropout", "Dropout") and (
                    isinstance(node.value, ast.Name) and node.value.id in ("F", "nn", "functional")):
                bad.append(f"{f.relative_to(ROOT)}:{node.lineno}: {node.value.id}.{node.attr}")
            if isinstance(node, ast.Call) and _samples(node) \
                    and not any(kw.arg == "generator" for kw in node.keywords):
                bad.append(f"{f.relative_to(ROOT)}:{node.lineno}: .{node.func.attr}() without generator")
    assert not bad, bad
