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


PORT_FILES = sorted((ROOT / "bialign_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "bialign_tpu"}


def _port_modules():
    pkg = ROOT / "bialign_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_and_runs_with_jax_blocked():
    """Every module of the port imports, and the toy golden runs, in a
    process where any import of jax or of the JAX package fails, and of
    matplotlib (the card's machine has none; the plot imports it when it
    draws)."""
    code = textwrap.dedent("""
        import importlib, sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.modules["bialign_tpu"] = None  # and any of the JAX package
        sys.modules["matplotlib"] = None   # and of matplotlib
        sys.path.insert(0, "tests")
        import golden as G
        for name in sys.argv[1:]:
            importlib.import_module(name)
        from bialign_tpu_torch import BiAligner
        ba = BiAligner(**G.TOY_RNA, engine="torch", device="cpu",
                       **G.TOY_RNA_AFFINE_PARAMS)
        assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
        assert list(ba.decode_trace()) == G.TOY_RNA_AFFINE_DEFAULT_OUT
        loaded = [k for k, v in sys.modules.items() if v is not None
                  and k.split(".")[0] in ("jax", "jaxlib", "bialign_tpu")]
        assert not loaded, loaded
        print("ok", len(sys.argv) - 1)
    """)
    modules = list(_port_modules())
    assert "bialign_tpu_torch.ops.cuda_dp" in modules
    assert "bialign_tpu_torch.scoring.tables" in modules
    assert "bialign_tpu_torch.ops.checkpoint_dp" in modules
    for name in ("parallel.driver", "parallel.batch_cli", "utils.profiling",
                 "utils.warmup", "models.triplet", "render.plot"):
        assert f"bialign_tpu_torch.{name}" in modules
    proc = subprocess.run([sys.executable, "-c", code, *modules], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(modules)}"


def _imported_tops(path):
    """Top-level names of every import statement in ``path``; a relative
    import counts as the port's own package."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("bialign_tpu_torch" if node.level
                         else node.module)
    return {name.split(".")[0] for name in names}


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    assert not _imported_tops(path) & FORBIDDEN, sorted(_imported_tops(path))


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


# tables that fail check_int32_safe take the int64 engine now:
# tests/test_torch_int64.py
@pytest.mark.parametrize("params,item", [
    (dict(lowmem=True, seqsplit_mesh=object()), "P15"),
    (dict(seqsplit_mesh=object()), "P15"),
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
    the JAX package, only bialign_tpu_torch, which stands alone."""
    tops = _imported_tops(ROOT / "chip_smoke.py")
    assert "jax" not in tops and "bialign_tpu" not in tops, sorted(tops)
    assert "bialign_tpu_torch" in tops
