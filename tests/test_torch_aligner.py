"""BiAligner and CLI of the PyTorch port (plain twins on the CPU) against
the goldens and against the JAX package's CLI, line for line."""

import pytest

import golden as G
from bialign_tpu.cli import main as jax_main
from bialign_tpu.data import example_path
from bialign_tpu.io.cfssp import read_molecule_from_file

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.cli import main as port_main

GOLDENS = [
    (G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS, G.TOY_RNA_AFFINE_SCORE,
     G.TOY_RNA_AFFINE_DEFAULT_OUT),
    (G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS, G.TOY_RNA_NONAFFINE_SCORE,
     G.TOY_RNA_NONAFFINE_DEFAULT_OUT),
    (G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS, G.TOY_PROTEIN_SCORE,
     G.TOY_PROTEIN_SORTED_OUT),
]


@pytest.mark.parametrize("mol,params,score,lines", GOLDENS,
                         ids=["rna_affine", "rna_nonaffine", "protein_sorted"])
def test_golden(mol, params, score, lines):
    ba = BiAligner(**mol, engine="torch", device="cpu", **params)
    assert ba.optimize() == score
    assert list(ba.decode_trace()) == lines


def test_dnapol_prefix150_score():
    seqA, strA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
    seqB, strB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
    ba = BiAligner(seqA[:150], seqB[:150], strA[:150], strB[:150],
                   engine="torch", device="cpu", type="Protein",
                   shift_cost=-210, structure_weight=800,
                   simmatrix="BLOSUM62", gap_opening_cost=-200, gap_cost=-50,
                   max_shift=1)
    assert ba.optimize() == 117180
    assert list(ba.eval_trace())[-1].split(" --> ")[-1] == "117180"


_RNA = [G.TOY_RNA["seqA"], G.TOY_RNA["seqB"],
        "--strA", G.TOY_RNA["strA"], "--strB", G.TOY_RNA["strB"]]
_RNA_AFFINE = ["--structure_weight", "400", "--gap_opening_cost", "-200",
               "--gap_cost", "-50", "--max_shift", "1", "--shift_cost",
               "-150"]
_PROTEIN = [G.TOY_PROTEIN["seqA"], G.TOY_PROTEIN["seqB"],
            "--strA", G.TOY_PROTEIN["strA"], "--strB", G.TOY_PROTEIN["strB"],
            "--type", "Protein", "--simmatrix", "BLOSUM62",
            "--structure_weight", "800", "--gap_opening_cost", "-150",
            "--gap_cost", "-50", "--shift_cost", "-150", "--max_shift", "1",
            "--outmode", "sorted"]


@pytest.mark.parametrize("argv", [
    _RNA + _RNA_AFFINE,
    _RNA + _RNA_AFFINE + ["-v", "--outmode", "full"],
    _RNA + ["-v"],                               # non-affine CLI defaults
    _PROTEIN,
    _RNA + _RNA_AFFINE + ["--lowmem", "-v"],
    _RNA + ["--lowmem", "-v"],                   # reads cells block by block
    _PROTEIN + ["--lowmem"],
], ids=["rna_affine", "rna_affine_verbose_full", "rna_defaults_verbose",
        "protein_sorted", "rna_affine_lowmem_verbose",
        "rna_defaults_lowmem_verbose", "protein_sorted_lowmem"])
def test_cli_output_equals_jax_cli(capsys, argv):
    jax_main(argv + ["--engine", "xla"])
    want = capsys.readouterr().out
    port_main(argv + ["--engine", "torch", "--device", "cpu"])
    got = capsys.readouterr().out
    assert "SCORE:" in got
    assert got == want


def test_cli_outmode_help(capsys):
    with pytest.raises(SystemExit):
        port_main(_RNA + ["--outmode", "help", "--engine", "torch",
                          "--device", "cpu"])
    assert "Available modes: " in capsys.readouterr().out
