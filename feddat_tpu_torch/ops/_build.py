"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``feddat_tpu_torch/_build/`` the first
time a kernel of it launches, then loaded with ``ctypes`` (pointers and the
stream passed as ``c_void_p``).  This keeps PyTorch's headers out of the
build: a source compiles in seconds, not minutes.

* Only sources inside the package are compiled; the library name carries a
  hash of the source, every shared ``csrc/*.cuh`` header and the flags, so
  an edited source or header rebuilds.
* Nothing here runs at import: ``import feddat_tpu_torch`` works on a host
  without ``nvcc``.  A failed build raises with ``nvcc``'s output.
* :func:`build` starts one ``nvcc`` per source, all at once, and waits for
  all of them (``chip_smoke.py`` builds everything up front this way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Sources nvcc compiles with its device-code optimisation split over the
# host's cores (``--split-compile``): the four whose build the any-head-dim
# and tail kernels made the longest (the build is as long as its slowest
# source).  flash_attention.cu is left whole: split, ptxas gives two of its
# head-dim-64 fp32 instances 1-2 other registers.  Split, ptxas gives every
# kernel of the other four its registers unsplit but #4's fp32 adapter row
# pass (175 -> 176, no spills).
SPLIT_COMPILE = ("adapter_fused", "attn_block", "fused_attention", "layer_block")


def nvcc_flags(name: str) -> Sequence[str]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return (*NVCC_FLAGS, *(("--split-compile=0",) if name in SPLIT_COMPILE else ()))

_LIBS: Dict[str, ctypes.CDLL] = {}
# held while a library is built and loaded: threads of one process build it
# once (processes are kept apart by the temporary name and os.replace)
BUILD_LOCK = threading.Lock()
# Every CudaKernel made, in order: ``train/compiled.py`` reads their counts
# around a capture and adds each kernel's share to it at every replay.
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """``_build/lib<name>-<hash>.so`` for the current source, headers and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> Sequence[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every listed source (default: all) that has no up-to-date
    library, all in parallel.  Returns ``{name: ptxas report}`` for the
    sources it compiled.  Raises ``RuntimeError`` with the compiler output
    if any build fails."""
    names = [n for n in (sources() if names is None else names)
             if not library_path(n).exists()]
    if not names:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
        reports[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


# template arguments of the kernels' mangled names: an int, or an element type
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|(f)|(13__nv_bfloat16)")


def _kernel_name(symbol: str) -> str:
    """A readable name for a mangled kernel symbol: the nested name's parts
    (the anonymous namespace left out) and its int and element-type template
    arguments, e.g. ``port::sm90::gemm_sm90_kernel<0, 0, float>`` or
    ``flash_fwd_kernel<bf16, 2>``; the symbol itself otherwise."""
    body = symbol[3:] if symbol.startswith("_ZN") else symbol[2:] if symbol.startswith("_Z") else ""
    parts, i = [], 0
    while i < len(body) and body[i].isdigit():
        j = i
        while body[j].isdigit():
            j += 1
        n = int(body[i:j])
        parts.append(body[j:j + n])
        i = j + n
    if not parts:
        return symbol
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    if not body[i:].startswith("I"):
        return name
    args, i = [], i + 1
    while (m := _TEMPLATE_ARG.match(body, i)) is not None:
        args.append(m.group(1) or ("float" if m.group(2) else "bf16"))
        i = m.end()
    return name + (f"<{', '.join(args)}>" if args and body[i:i + 1] == "E" else "")


def ptxas_summary(log: str) -> Sequence[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name, registers
    and spills."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            lines.append(f"{_kernel_name(name)}: {m.group(1)} registers; {spills}")
            name = None
    return lines


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


class CudaKernel:
    """One C entry point of a ``csrc`` library, with its launch count.

    ``launches`` is a plain integer that the owning wrapper raises by one
    for every successful launch, so a run can show that its main path went
    through the kernel.  A launch recorded into a CUDA graph is not one: the
    capture takes it back and every replay of the graph adds it again
    (``train/compiled.py``)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def function(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.function()(*args)
        if err != 0:
            msg = load(self.source).kernel_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t) -> Optional[int]:
    """``data_ptr`` of a tensor for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()
