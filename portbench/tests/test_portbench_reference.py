"""The plain reference against upstream's goldens, its tables against a
literal transcription of upstream's loops, and the int16 control."""

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference import decode, tables
from portbench.tests import cases

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def _one(rec, params, **kw):
    return reference.align([rec], params, traces=True, **kw)[0]


@pytest.mark.parametrize("rec, params, score, outmode, lines", [
    (cases.TOY_RNA, cases.TOY_RNA_AFFINE, cases.TOY_RNA_AFFINE_SCORE,
     "default", cases.TOY_RNA_AFFINE_LINES),
    (cases.TOY_RNA, cases.TOY_RNA_DEFAULTS, cases.TOY_RNA_DEFAULTS_SCORE,
     "default", cases.TOY_RNA_DEFAULTS_LINES),
    (cases.TOY_PROTEIN, cases.TOY_PROTEIN_PARAMS, cases.TOY_PROTEIN_SCORE,
     "sorted", cases.TOY_PROTEIN_SORTED),
], ids=["toy-rna-affine", "toy-rna-defaults", "toy-protein"])
def test_goldens(rec, params, score, outmode, lines):
    ans = _one(rec, params)
    assert ans["score"] == score
    assert ans["complete"]
    got = decode.lines(ans["trace"], rec, rna=params["type"] == "RNA",
                       outmode=outmode)
    assert got[:len(lines)] == lines


def test_dnapol_prefix_anchor():
    seqA, strA = tables.read_cfssp(
        ROOT / "portbench/data/DNAPolymerase1_Escherichia.cfssp.gz")
    seqB, strB = tables.read_cfssp(
        ROOT / "portbench/data/DNAPolymerase1_Xanthomonas.cfssp.gz")
    assert (len(seqA), len(seqB)) == (928, 933)
    rec = (seqA[:150], seqB[:150], strA[:150], strB[:150])
    assert _one(rec, cases.DNAPOL_PREFIX_PARAMS)["score"] == \
        cases.DNAPOL_PREFIX_SCORE


def test_batch_equals_pairs():
    """Pairs padded into one batch score as they do alone."""
    recs = [cases.TOY_RNA, (cases.TOY_RNA[0][:11], cases.TOY_RNA[1][3:],
                            "..(((...)))", "((.....))....")]
    for params in (cases.TOY_RNA_AFFINE, cases.TOY_RNA_DEFAULTS):
        both = reference.align(recs, params, traces=True)
        for rec, ans in zip(recs, both):
            alone = _one(rec, params)
            assert (ans["score"], ans["trace"]) == (alone["score"],
                                                    alone["trace"])


def _profile_loops(structure):
    """Upstream's pairing profile, loop for loop (bialignment.pyx:340-392)."""
    n = len(structure)
    sbpp = np.zeros((n + 1, n + 1))
    stack = []
    for i, ch in enumerate(structure):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            j = stack.pop()
            sbpp[i + 1, j + 1] = sbpp[j + 1, i + 1] = 1.0
        else:
            sbpp[i + 1, i + 1] = 1.0
    up, down, unp = [0.0] * (n + 1), [0.0] * (n + 1), [0.0] * (n + 1)
    for i in range(n + 1):
        acc = 0
        for j in range(1, i - 1):
            acc += sbpp[i, j]
        up[i] = acc
        acc = 0
        for j in range(i + 1, n + 1):
            acc += sbpp[i, j]
        down[i] = acc
        unp[i] = 1.0 - up[i] - down[i]
    return np.array(up), np.array(down), np.array(unp)


@pytest.mark.parametrize("structure", ["...(((.....))).....",
                                       "((..))()..((((...))..))", "......"])
def test_rna_profile_matches_upstream_loops(structure):
    for got, want in zip(tables.pairing_profile(structure),
                         _profile_loops(structure)):
        np.testing.assert_array_equal(got, want)


def test_control_int16_is_wrong():
    """The control, the reference at int16, reads wrong scores at a size a
    test holds (scores above 2^15)."""
    rna6 = tuple(x * 6 for x in cases.TOY_RNA)
    for rec, params in ((cases.TOY_PROTEIN, cases.TOY_PROTEIN_PARAMS),
                        (rna6, cases.TOY_RNA_DEFAULTS)):
        want = _one(rec, params)
        got = _one(rec, params, dtype=torch.int16)
        assert got["score"] != want["score"]
