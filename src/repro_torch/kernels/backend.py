"""Device rule and build for the port's hand-written CUDA kernels.

The device rule (the counterpart of ``repro.kernels.backend``): a kernel
wrapper looks at the device of the tensors it is given. CPU tensors take
the kernel's plain PyTorch version (``kernels/ref.py``); CUDA tensors
launch the hand-written kernel, or the call raises. Nothing falls back to
the plain version on the card, and a failed build raises.

The build: each ``csrc/<name>.cu`` has a plain C interface and is compiled
on first use with ``nvcc`` for ``sm_90a`` into a shared library that
``ctypes`` loads. The library's file name carries a digest of its source,
the shared headers it may include (``csrc/*.cuh``) and the flags, so an
edited source or header is never served by a stale library.
``build()`` starts one ``nvcc`` per source, all at once, and waits for
them; a source of ``PARTS`` builds as that many translation units
(``-DKERNEL_PART=i``, each instantiating its share of the source's
templates), all started with the others and linked into its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

#: every kernel source under ``csrc/`` (one shared library each)
KERNELS = ("fed_mix_segment", "fed_mix", "fed_mix_matching", "fed_mix_q",
           "fed_aggregate", "flash_attention", "ssd_scan",
           "flash_attention_bwd", "flash_attention_bwd_vd",
           "flash_attention_bwd_256", "ssd_scan_bwd")

CSRC = Path(__file__).resolve().parent / "csrc"
# The libraries go to <repo>/build/repro_torch/, which .gitignore lists
# (``build/``): they are made at first use inside the checkout and never
# committed.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: sources built as several translation units (their dtypes' halves): the
#: two longest nvcc runs of the build, which set its wall time
PARTS = {"flash_attention": 2, "fed_mix_q": 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# device rule
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The entry points' device: ``None`` means the card. A CUDA device
    with no card raises — the CPU is used only when the caller asks for
    it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        use_full_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def use_full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions. The reference
    accumulates in full f32 (``preferred_element_type=f32``); cuDNN's
    default TF32 convolutions keep ~3 decimal digits and would break every
    f32 tolerance the port is held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kernel_device(name: str, *tensors: torch.Tensor) -> str:
    """'cpu' (take the plain version) or 'cuda' (launch the kernel) for a
    wrapper's tensors; mixed or other devices raise ``ValueError``."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: "
                         f"{sorted(str(d) for d in devs)}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous (got "
                             f"strides {tuple(t.stride())} for shape "
                             f"{tuple(t.shape)})")


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "cannot be built")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``; its digest covers the source,
    every shared header (``csrc/*.cuh``) and the flags, so an edited
    header rebuilds every kernel."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(f"parts={PARTS.get(name, 1)}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source (per part of a source of ``PARTS``, then one link), all
    started together. Returns the seconds each build took (0.0 for a
    library already built); raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs, seconds = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        src = str(CSRC / f"{name}.cu")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        if name not in PARTS:
            cmds = [([nvcc(), *NVCC_FLAGS, "-o", tmp, src], None)]
        else:
            cmds = []
            for i in range(PARTS[name]):
                fd, obj = tempfile.mkstemp(suffix=".o", dir=BUILD_DIR)
                os.close(fd)
                cmds.append(([nvcc(), *compile_flags, "-c",
                              f"-DKERNEL_PART={i}", "-o", obj, src], obj))
        jobs[name] = (tmp, lib, time.perf_counter(),
                      [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        obj) for cmd, obj in cmds])
    failed = []
    for name, (tmp, lib, t0, procs) in jobs.items():
        outs = [(proc.communicate()[0], proc.returncode, obj)
                for proc, obj in procs]
        objs = [obj for _, _, obj in outs if obj is not None]
        bad = [(out, rc) for out, rc, _ in outs if rc != 0]
        if not bad and objs:
            link = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                bad.append((link.stdout + link.stderr, link.returncode))
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        seconds[name] = time.perf_counter() - t0
        if bad:
            failed += [f"--- {name} (nvcc exit {rc}) ---\n{out}"
                       for out, rc in bad]
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)            # atomic: readers never see half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        if name not in _libs:
            lib = library_path(name)
            if not lib.exists():
                build([name])
            _libs[name] = ctypes.CDLL(str(lib))
        return _libs[name]


def c_function(name: str, symbol: str, argtypes: Sequence,
               restype=ctypes.c_int):
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def raise_on_error(name: str, rc: int) -> None:
    """A C entry point returns ``cudaGetLastError()`` after its launch: a
    launch the card refused never runs, and a later synchronize would not
    report it."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def stream_ptr(device: Optional[torch.device] = None) -> int:
    return torch.cuda.current_stream(device).cuda_stream
