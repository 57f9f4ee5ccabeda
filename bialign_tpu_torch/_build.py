"""Build and load the CUDA kernels of the port.

Counterpart of :mod:`bialign_tpu.native` (lazy build at first use, ctypes
load).  ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a``, all sources at
once in processes of their own, and links the objects into one shared
library with a plain C interface, ``build/bialign_tpu_torch/
libbialign_cuda.so`` at the root of the checkout; it is rebuilt when a
source is newer than the library.  Nothing here runs at import: the CPU
tests import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "bialign_tpu_torch"
LIB_PATH = BUILD_DIR / "libbialign_cuda.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",    # registers, shared memory and spills per kernel
]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the library's extern "C" functions (csrc/*.cu)
_SIGNATURES = {
    "bialign_fill_affine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bialign_fill_nonaffine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bialign_score_affine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bialign_score_nonaffine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bialign_score_affine_ms0": [_P, _P, _P, _P, _I, _I, _I, _P],
    "bialign_score_affine_ms0_grid": [_P, _P, _P, _P, _I, _I, _I, _P],
    # rings, out, mu1, mu2, ns, ms, consts (host), B, N, M, (S,) (lanes, T0,
    # or threads,) (d_max,) device, stream
    "bialign_batch_affine": [_P] * 7 + [_I] * 6 + [_P],
    "bialign_batch_nonaffine": [_P] * 7 + [_I] * 6 + [_P],
    # bands in place of rings: the same arguments
    "bialign_batch_fill_affine": [_P] * 7 + [_I] * 6 + [_P],
    "bialign_batch_fill_nonaffine": [_P] * 7 + [_I] * 6 + [_P],
    "bialign_conveyor_affine": [_P] * 7 + [_I] * 8 + [_P],
    "bialign_conveyor_nonaffine": [_P] * 7 + [_I] * 8 + [_P],
    "bialign_cta_affine": [_P] * 7 + [_I] * 6 + [_P],
    "bialign_cta_nonaffine": [_P] * 7 + [_I] * 6 + [_P],
    "bialign_cta_affine_ms0": [_P] * 7 + [_I] * 5 + [_P],
    "bialign_walk_affine": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    "bialign_walk_nonaffine": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    # bands, mu1, mu2, cases, ns, ms, B, N, M, D, S, out, lmax, device, stream
    "bialign_walk_affine_batch": [_P] * 6 + [_I] * 5 + [_P, _I, _I, _P],
    "bialign_walk_nonaffine_batch": [_P] * 6 + [_I] * 5 + [_P, _I, _I, _P],
    # ring, ckpts, mu1, mu2, cases, n, m, S, C, device, stream
    "bialign_ckpt_affine": [_P] * 5 + [_I] * 5 + [_P],
    "bialign_ckpt_nonaffine": [_P] * 5 + [_I] * 5 + [_P],
    # window, ck, mu1, mu2, cases, n, m, S, d0, C, device, stream
    "bialign_block_affine": [_P] * 5 + [_I] * 6 + [_P],
    "bialign_block_nonaffine": [_P] * 5 + [_I] * 6 + [_P],
    # window, mu1, mu2, cases, n, m, S, d0, start, state, out, lmax, device,
    # stream
    "bialign_walk_affine_block": [_P] * 4 + [_I] * 5 + [_P, _P, _I, _I, _P],
    "bialign_walk_nonaffine_block": [_P] * 4 + [_I] * 5 + [_P, _P, _I, _I, _P],
    # shards (host table [K, 8]), K, cases, n, m, S (csrc/seqsplit.cu)
    "bialign_seqsplit_score_affine": [_P, _I, _P] + [_I] * 3,
    "bialign_seqsplit_score_nonaffine": [_P, _I, _P] + [_I] * 3,
    # ... and C
    "bialign_seqsplit_ckpt_affine": [_P, _I, _P] + [_I] * 4,
    "bialign_seqsplit_ckpt_nonaffine": [_P, _I, _P] + [_I] * 4,
    # ... and d0, C
    "bialign_seqsplit_block_affine": [_P, _I, _P] + [_I] * 5,
    "bialign_seqsplit_block_nonaffine": [_P, _I, _P] + [_I] * 5,
    # ys, mu1, mu2, n, m, S, 2 gamma, gamma + delta, threads, device, stream
    # (csrc/triplet.cu: routes "global" and "shared")
    "bialign_triplet_fill": [_P] * 3 + [_I] * 7 + [_P],
    "bialign_triplet_fill_shared": [_P] * 3 + [_I] * 7 + [_P],
    # next, hops, sink, device, stream (csrc/probe.cu, for chip_smoke.py)
    "bialign_probe_chase": [_P, _I, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise FileNotFoundError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA engine needs the CUDA toolkit"
    )


def stale() -> bool:
    """True when the library is missing or older than a source."""
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def build() -> str:
    """Compile the library; return nvcc's report (ptxas resource usage).

    One ``nvcc -c`` per source, all started together, then one link.  The
    objects go into a temporary directory and the library is written under
    a temporary name and renamed into place, so a process never loads a
    half-written file.
    """
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(objdir) / (src.stem + ".o"))
            cmd = [compiler, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, _obj, proc in jobs]     # waits for every job
        for cmd, out, rc in outputs:
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
            report.append(out)
        tmp = str(Path(objdir) / "libbialign_cuda.so")
        cmd = [compiler, *LINK_FLAGS, "-o", tmp, *[obj for _c, obj, _p in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        report.append(proc.stdout + proc.stderr)
        os.replace(tmp, LIB_PATH)
    return "".join(report)


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is stale."""
    global _lib
    if _lib is None:
        if stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bialign_error_string.argtypes = [ctypes.c_int]
        lib.bialign_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Call library function ``name``.

    ``args`` are tensors (passed as their data pointers), None (a null
    pointer), ints and ctypes values, in the order of the C signature.
    Raises when the function reports a CUDA error.
    """
    lib = load()
    cargs = [
        _P(a.data_ptr()) if isinstance(a, torch.Tensor)
        else _P(None) if a is None
        else a if isinstance(a, (_P, _I)) else _I(a)
        for a in args
    ]
    err = getattr(lib, name)(*cargs)
    if err:
        msg = lib.bialign_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch(name: str, device: torch.device, *args) -> None:
    """Call library function ``name`` on ``device``'s current stream, as
    :func:`call`; the device index and the stream are appended."""
    stream = torch.cuda.current_stream(device).cuda_stream
    call(name, *args, device.index, _P(stream))
