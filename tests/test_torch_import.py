"""The PyTorch port loads and runs without JAX, and its CUDA engine
refuses to run anywhere but on a CUDA device."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import golden as G
from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.data import dnapol_pair

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_and_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.path.insert(0, "tests")
        import golden as G
        import bialign_tpu_torch
        from bialign_tpu_torch import BiAligner, _build, cli, convert, data
        from bialign_tpu_torch.ops import band, cuda_dp, device_traceback
        ba = BiAligner(**G.TOY_RNA, engine="torch", device="cpu",
                       **G.TOY_RNA_AFFINE_PARAMS)
        assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
        assert list(ba.decode_trace()) == G.TOY_RNA_AFFINE_DEFAULT_OUT
        loaded = [k for k, v in sys.modules.items()
                  if v is not None and k.split(".")[0] == "jax"]
        assert not loaded, loaded
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_engine_refuses_a_cpu_device():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        BiAligner(**G.TOY_RNA, engine="cuda", device="cpu",
                  **G.TOY_RNA_AFFINE_PARAMS)


def test_cuda_engine_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        BiAligner(**G.TOY_RNA, **G.TOY_RNA_AFFINE_PARAMS)   # the defaults


def test_unknown_engine_is_refused():
    with pytest.raises(ValueError, match="engine"):
        BiAligner(**G.TOY_RNA, engine="pallas", device="cpu")


@pytest.mark.parametrize("params,item", [
    (dict(lowmem=True), "P13"),
    (dict(seqsplit_mesh=object()), "P15"),
    (dict(gap_cost=-10 ** 8), "P2"),       # fails check_int32_safe
])
def test_unported_modes_raise(params, item):
    ba = BiAligner(**G.TOY_RNA, engine="torch", device="cpu", **params)
    with pytest.raises(NotImplementedError, match=item):
        ba.optimize()


def test_dnapol_pair_loads_through_the_port():
    seqA, strA, seqB, strB = dnapol_pair()
    assert (len(seqA), len(strA), len(seqB), len(strB)) == (928, 928, 933,
                                                            933)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where there is no JAX: it imports neither jax nor
    the JAX package, only bialign_tpu_torch (which reuses the JAX-free host
    layers itself)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    tops = {name.split(".")[0] for name in names}
    assert "jax" not in tops and "bialign_tpu" not in tops, sorted(tops)
    assert "bialign_tpu_torch" in tops
