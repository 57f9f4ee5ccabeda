"""The CUDA sources of ``bialign_tpu_torch/csrc`` built for the host.

The emulation tests build a kernel's source with the host's C++20 compiler
against this directory's headers (a CTA as std::threads, its warp
functions), after two mechanical rewrites: a kernel's ``extern __shared__``
buffer becomes the CTA's host buffer, and each ``<<<...>>>`` launch a
``host_launch`` call.  These are the pieces the tests share.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

HOST = Path(__file__).resolve().parent
CSRC = HOST.parents[1] / "bialign_tpu_torch" / "csrc"

_SHARED = re.compile(r"extern __shared__ int32_t smem\[\];")
_LAUNCH = re.compile(r"([\w:]+)<<<(.*?)>>>\(", re.S)


def for_host(text: str, buffers: int, launches: int, what: str) -> str:
    """``text`` with both rewrites, which must find ``buffers`` shared
    buffers and ``launches`` launches."""
    text, k = _SHARED.subn("int32_t* smem = host_cta_shared;", text)
    assert k == buffers, f"the shared buffers of {what} moved"
    text, k = _LAUNCH.subn(lambda mt: f"host_launch({mt[1]}, {mt[2]}, ",
                           text)
    assert k == launches, f"the launches of {what} moved"
    return text


def copy_csrc(dst: Path, files: dict) -> Path:
    """csrc copied to ``dst``, each of ``files`` (name: (shared buffers,
    launches)) rewritten for the host; returns ``dst``."""
    shutil.copytree(CSRC, dst)
    for name, (buffers, launches) in files.items():
        path = dst / name
        path.write_text(for_host(path.read_text(), buffers, launches, name))
    return dst


def compiler() -> str:
    """The host's C++ compiler; the test is skipped without one."""
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        pytest.skip("no host C++ compiler")
    return found


def build(cxx: str, sources: list, so: Path, *flags: str) -> ctypes.CDLL:
    """``sources`` compiled in parallel (each with its own directory on the
    include path) and linked into the shared library ``so``."""
    objs = [so.parent / f"{so.stem}_{src.stem}.o" for src in sources]
    jobs = [subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-w", *flags, "-I", str(HOST),
         "-I", str(src.parent), "-x", "c++", "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)]
    for job in jobs:
        out = job.communicate()[0]
        assert job.returncode == 0, out
    subprocess.run([cxx, "-shared", "-o", str(so), *map(str, objs),
                    "-lpthread"], check=True)
    return ctypes.CDLL(str(so))


def call(lib, name: str, *args) -> None:
    """The entry point ``name`` on CPU tensors and ints, on device 0 and
    the null stream; it must return 0."""
    call_as_is(lib, name, *args, 0, None)


def call_as_is(lib, name: str, *args) -> None:
    """The entry point ``name`` on CPU tensors, ints and None (a null
    pointer), nothing appended; it must return 0."""
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else ctypes.c_void_p(None) if a is None
             else ctypes.c_int(a) for a in args]
    err = getattr(lib, name)(*cargs)
    assert err == 0, f"{name}: error {err}"


def garbage(rng, shape) -> torch.Tensor:
    """int32 values drawn over the whole range."""
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32))
