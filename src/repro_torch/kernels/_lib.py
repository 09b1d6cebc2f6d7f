"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
lands in ``build/kernels/<hash>/`` at the root of the checkout (git-ignored),
keyed by a hash of the sources and flags, so a fresh checkout builds once and
an edited source rebuilds. A missing ``nvcc`` or a failed build raises: there
is no fallback to the plain PyTorch versions for tensors on the card.

Each wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel, bumped where the kernel is launched and nowhere else), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libejfat_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: launches of each kernel since the last ``reset_launches()``
#: (``flash_attention`` counts every launch of either attention design,
#: ``flash_attention_wgmma`` those of the wgmma design alone; likewise
#: ``lb_route`` and ``lb_route_global``)
LAUNCHES: dict[str, int] = {"lb_route": 0, "lb_route_global": 0,
                            "dispatch_plan": 0, "seg_masks": 0,
                            "flash_attention": 0, "flash_attention_wgmma": 0,
                            "farm_serve": 0, "seq_cumsum": 0, "build_calendar": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: how a driver prints its launches (on stderr, after its run)
LAUNCH_LINE = "# kernel launches: "


def launch_line() -> str:
    """``LAUNCHES`` as the one line a driver prints when it ends."""
    return LAUNCH_LINE + json.dumps(LAUNCHES, sort_keys=True)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(q for q in CSRC.iterdir() if q.is_file()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the .so.

    Each ``csrc/*.cu`` compiles to an object in its own ``nvcc`` process, all
    started together; one more ``nvcc`` links them into the library.
    """
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
        if not failed:
            so = tmp_dir / LIB_NAME
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ejfat_lb_route_smem_bytes.argtypes = [i, i, i, i, i]
    lib.ejfat_lb_route.argtypes = [i, p, p, i, p, p, p, p, p, p, p, p,
                                   i, i, i, i, p, p, p, p, p]
    lib.ejfat_dispatch_scratch_words.argtypes = [i, i]
    lib.ejfat_dispatch_plan.argtypes = [p, i, i, p, p, p, p]
    lib.ejfat_seg_masks.argtypes = [p, p, p, p, p, i, p, p, p]
    lib.ejfat_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ejfat_flash_attention_wgmma.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.ejfat_farm_serve.argtypes = [p, p, p, p, p, p, i, p, p, p, p, p, p]
    lib.ejfat_seq_cumsum.argtypes = [p, i, p, p]
    lib.ejfat_build_calendar.argtypes = [p, i, p, i, p, p]
    lib.ejfat_chain_probe.argtypes = [ctypes.c_double, ctypes.c_double, i, p, p, p, p]
    for fn in (lib.ejfat_lb_route_smem_bytes, lib.ejfat_dispatch_scratch_words):
        fn.restype = ctypes.c_longlong
    for fn in (lib.ejfat_lb_route, lib.ejfat_dispatch_plan, lib.ejfat_seg_masks,
               lib.ejfat_flash_attention, lib.ejfat_flash_attention_wgmma,
               lib.ejfat_farm_serve, lib.ejfat_seq_cumsum, lib.ejfat_build_calendar,
               lib.ejfat_chain_probe):
        fn.restype = ctypes.c_int


def lib():
    """The loaded kernel library (built on first call in this process)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        _declare(handle)
        _LIB = handle
    return _LIB


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
            shape: tuple | None = None) -> None:
    """The checks every wrapper makes before handing a pointer to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
