"""A protein pair's score tables built on its device from residue codes
(``scoring/pair_codes.py``, ``BiAligner``'s device route) against the host
tables (``build_score_tables``): the tables, the ``KeyError`` of a residue
outside the matrix, the int32 verdict, the route's choice, and the whole
aligner through the route, forced on the CPU (the plain twins)."""

import warnings

import numpy as np
import pytest
import torch

import golden as G
from bialign_tpu_torch import BiAligner
from bialign_tpu_torch import aligner as A
from bialign_tpu_torch.data import dnapol_pair
from bialign_tpu_torch.models.molecule import preprocess_molecule
from bialign_tpu_torch.ops.cases import check_int32_safe
from bialign_tpu_torch.parallel.mesh import Mesh
from bialign_tpu_torch.scoring import pair_codes as PC
from bialign_tpu_torch.scoring.tables import build_score_tables
from bialign_tpu_torch.utils import profiling as P

CPU = dict(engine="torch", device="cpu")
CUDA = torch.device("cuda")
BLOSUM = "ARNDCQEGHILKMFPSTWYVBZX*"
PROTEIN = dict(type="Protein", simmatrix="BLOSUM62", structure_weight=800,
               gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
               max_shift=1)
MATCH = dict(PROTEIN, simmatrix=None, sequence_match_similarity=120,
             sequence_mismatch_similarity=-40)
DNAPOL_PREFIX = dict(type="Protein", shift_cost=-210, structure_weight=800,
                     simmatrix="BLOSUM62", gap_opening_cost=-200,
                     gap_cost=-50, max_shift=1)


@pytest.fixture
def device_route(monkeypatch):
    """The device route on the CPU: the route predicate's device test
    answers as on a CUDA device."""
    monkeypatch.setattr(A, "_builds_on_device", lambda device: True)


def _params(**kw):
    return dict(A.PARAM_DEFAULTS, **kw)


def _mols(seqA, seqB, strA=None, strB=None):
    rng = np.random.default_rng(len(seqA) * 1000 + len(seqB))
    strA = strA or "".join(rng.choice(list("HCET"), len(seqA)))
    strB = strB or "".join(rng.choice(list("HCET"), len(seqB)))
    return (preprocess_molecule(seqA, strA, is_rna=False),
            preprocess_molecule(seqB, strB, is_rna=False))


def _device_tables(molA, molB, params):
    """(mu1, mu2, peak) through the helper on the CPU."""
    params = _params(**params)
    table = PC.code_table(params)
    sw = params["structure_weight"]
    codes = PC.encode(molA, molB, table, sw)
    mu1, mu2 = PC.planes(codes, table, sw, "cpu")
    return mu1.numpy(), mu2.numpy(), codes.peak


def _matrix(tmp_path, rows: dict, name="m.txt"):
    """A similarity matrix file: ``rows`` maps a key to its values."""
    keys = list(rows)
    text = "-  " + "  ".join(keys) + "\n" + "".join(
        f"{k}  " + "  ".join(str(v) for v in vals) + "\n"
        for k, vals in rows.items())
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# -- the tables ----------------------------------------------------------------

PAIRS = {
    "empty_both": ("", ""),
    "empty_a": ("", "ARND"),
    "empty_b": ("WYV", ""),
    "one_one": ("W", "W"),
    "one_seven": ("C", "RAKLPLK"),
    "uneven": ("RAKLPLKEKKLTA", "KAKL"),
    "alphabet": (BLOSUM, BLOSUM[::-1]),
    "alphabet_twice": (BLOSUM * 2, BLOSUM[5:] + BLOSUM[:5]),
}


@pytest.mark.parametrize("params", [PROTEIN, MATCH],
                         ids=["blosum62", "match_mismatch"])
@pytest.mark.parametrize("pair", PAIRS.values(), ids=list(PAIRS))
def test_device_tables_equal_the_host_tables(pair, params):
    molA, molB = _mols(*pair)
    mu1, mu2, peak = _device_tables(molA, molB, params)
    want = build_score_tables(molA, molB, _params(**params), is_rna=False)
    for got, host in zip((mu1, mu2), want):
        assert got.dtype == host.dtype == np.int32
        assert got.shape == host.shape == (len(pair[0]) + 1,
                                            len(pair[1]) + 1)
        np.testing.assert_array_equal(got, host)
    assert peak == max(int(np.abs(mu).max(initial=0)) for mu in want)


# -- the KeyError of a residue outside the matrix ------------------------------

KEY_ERRORS = {
    # seqA[0]'s row is absent: the host names it first
    "first_of_a": ("JAKL", "AUKL", "J"),
    # seqA[0] valid: the first residue of B outside the matrix
    "in_b": ("AJKL", "AKUL", "U"),
    "in_b_and_a": ("AKLJ", "ALKUJ", "U"),
    # only A holds one
    "in_a_only": ("AKLOJ", "ARKL", "O"),
}


def _host_error(seqA, seqB, params):
    with pytest.raises(KeyError) as host:
        BiAligner(seqA, seqB, "H" * len(seqA), "H" * len(seqB), **params,
                  **CPU)
    return host.value


@pytest.mark.parametrize("case", KEY_ERRORS.values(), ids=list(KEY_ERRORS))
def test_key_error_names_the_host_tables_residue(case, device_route,
                                                 monkeypatch):
    seqA, seqB, char = case
    with pytest.raises(KeyError) as dev:
        BiAligner(seqA, seqB, "H" * len(seqA), "H" * len(seqB), **PROTEIN,
                  **CPU)
    monkeypatch.setattr(A, "_builds_on_device", lambda device: False)
    host = _host_error(seqA, seqB, PROTEIN)
    assert dev.value.args == host.args == (char,)


@pytest.mark.parametrize("pair", [("", "AJ"), ("JU", "")],
                         ids=["empty_a", "empty_b"])
def test_an_empty_sequence_raises_nothing(pair, device_route):
    before = P.snapshot()
    ba = BiAligner(*pair, "H" * len(pair[0]), "H" * len(pair[1]), **PROTEIN,
                   **CPU)
    assert P.since(before)["pair.planes"].count == 1
    assert ba._peak == 0
    for mu in (ba.mu1, ba.mu2):
        assert mu.shape == (len(pair[0]) + 1, len(pair[1]) + 1)
        assert not mu.any()


@pytest.mark.parametrize("where", ["seqA", "seqB", "strA", "strB"])
def test_a_character_outside_latin1_takes_the_host_route(where, device_route,
                                                          monkeypatch):
    mol = dict(G.TOY_PROTEIN)
    mol[where] = mol[where][:5] + "Ж" + mol[where][6:]
    before = P.snapshot()
    with pytest.raises(UnicodeEncodeError) as dev:
        BiAligner(**mol, **PROTEIN, **CPU)
    got = P.since(before)
    assert "pair.encode" in got and "pair.planes" not in got
    monkeypatch.setattr(A, "_builds_on_device", lambda device: False)
    with pytest.raises(UnicodeEncodeError) as host:
        BiAligner(**mol, **PROTEIN, **CPU)
    assert str(dev.value) == str(host.value)


def test_a_character_outside_latin1_beside_an_empty_sequence(device_route):
    ba = BiAligner("", "AKЖ", "", "HHH", **PROTEIN, **CPU)
    assert ba._peak is None and not ba.mu1.any() and ba.mu1.shape == (1, 4)


# -- the int32 verdict ---------------------------------------------------------

def _verdict_cases(tmp_path):
    big = _matrix(tmp_path, {"A": [4, 0, -2, 1], "C": [0, 9, -3, -2],
                             "D": [-2, -3, 6, -4], "W": [1, -2, -4, 10 ** 6]})
    return {
        "blosum62": (("RAKLPLKEKK", "KAKLPLKE"), PROTEIN, True),
        "match_mismatch": (("RAKLPLKEKK", "KAKLPLKE"), MATCH, True),
        "structure_weight_beyond": (("ACDEFGHIKL", "ACDEFGAIKL"),
                                    dict(PROTEIN,
                                         structure_weight=500_000_000),
                                    False),
        "gap_cost_beyond": (("RAKLPLKEKK", "KAKLPLKE"),
                            dict(PROTEIN, gap_cost=-10 ** 8), False),
        "large_entry_absent": (("ACDDCA", "CADW"), dict(PROTEIN,
                                                        simmatrix=big), True),
        "large_entry_present": (("ACWDCA", "CADW"), dict(PROTEIN,
                                                         simmatrix=big),
                                False),
    }


VERDICTS = ["blosum62", "match_mismatch", "structure_weight_beyond",
            "gap_cost_beyond", "large_entry_absent", "large_entry_present"]


@pytest.mark.parametrize("name", VERDICTS)
def test_int32_verdict_equals_the_host_check(name, tmp_path, device_route,
                                             monkeypatch):
    (seqA, seqB), params, safe = _verdict_cases(tmp_path)[name]
    strA, strB = "H" * len(seqA), "HC" * (len(seqB) // 2) + "H" * (
        len(seqB) % 2)
    ba = BiAligner(seqA, seqB, strA, strB, **params, **CPU)
    assert ba._peak is not None
    host_tables = build_score_tables(ba.molA, ba.molB, ba._params,
                                     is_rna=False)
    verdict = PC.int32_safe(len(seqA), len(seqB), ba._peak, ba._params)
    assert verdict == check_int32_safe(*host_tables, ba._params) == safe
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        score = ba.optimize()
        lines = list(ba.decode_trace())
    took_int64 = any("int64 engine" in str(w.message) for w in caught)
    assert took_int64 == (not safe) == ba._int64
    monkeypatch.setattr(A, "_builds_on_device", lambda device: False)
    host = BiAligner(seqA, seqB, strA, strB, **params, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert (score, lines) == (host.optimize(), list(host.decode_trace()))


def test_tables_set_by_hand_are_checked_and_uploaded(device_route):
    """Tables assigned after the constructor (as the fuzz lane assigns
    tables beyond the int32 certificate) are host tables for the fill."""
    ba = BiAligner(**G.TOY_PROTEIN, **PROTEIN, **CPU)
    assert ba._peak is not None
    mu1 = np.array(ba.mu1)
    mu1[1:, 1:] = 600_000_000
    ba.mu1 = mu1
    assert ba._peak is None and ba.mu1 is mu1
    before = P.snapshot()
    with pytest.warns(RuntimeWarning, match="int64 engine"):
        ba.optimize()
    assert "pair.upload" in P.since(before)
    assert torch.equal(ba._mu1_t, torch.from_numpy(mu1.astype(np.int64)))


# -- the route -----------------------------------------------------------------

def test_route_of_the_tables(tmp_path):
    ragged = _matrix(tmp_path, {"A": [4, 0, -2], "C": [0, 9],
                                "D": [-2, -3, 6]}, "ragged.txt")
    square = _matrix(tmp_path, {"A": [4, 0, -2], "C": [0, 9, -3],
                                "D": [-2, -3, 6]}, "square.txt")
    mesh = Mesh(["cpu"] * 2, ("sp",))
    assert isinstance(A._code_table(CUDA, _params(**PROTEIN)), PC.CodeTable)
    assert isinstance(A._code_table(CUDA, _params(**MATCH)), PC.CodeTable)
    assert isinstance(A._code_table(CUDA, _params(**dict(
        PROTEIN, simmatrix=square))), PC.CodeTable)
    host = [
        (CUDA, dict(PROTEIN, type="RNA")),
        (CUDA, dict(PROTEIN, simmatrix=ragged)),
        (torch.device("cpu"), PROTEIN),
        (CUDA, dict(PROTEIN, seqsplit_mesh=mesh)),
        (CUDA, dict(PROTEIN, structure_weight=1 << 31)),
        (CUDA, dict(MATCH, sequence_match_similarity=-(1 << 31) - 1)),
    ]
    for device, params in host:
        assert A._code_table(device, _params(**params)) is None, params


def test_the_table_goes_to_a_device_once():
    table = A._code_table(CUDA, _params(**PROTEIN))
    assert A._code_table(CUDA, _params(**PROTEIN)) is table
    cpu = torch.device("cpu")
    assert table.on(cpu) is table.on(cpu)
    assert table.on(cpu).dtype == torch.int32


# -- the whole aligner on the device route -------------------------------------

@pytest.mark.parametrize("lowmem", [False, True])
def test_toy_protein_golden_on_the_device_route(lowmem, device_route):
    ba = BiAligner(**G.TOY_PROTEIN, lowmem=lowmem, **G.TOY_PROTEIN_PARAMS,
                   **CPU)
    assert ba._peak is not None
    assert ba.optimize() == G.TOY_PROTEIN_SCORE
    assert list(ba.decode_trace()) == G.TOY_PROTEIN_SORTED_OUT
    host = build_score_tables(ba.molA, ba.molB, ba._params, is_rna=False)
    for got, want in zip((ba.mu1, ba.mu2), host):
        np.testing.assert_array_equal(got, want)
    assert list(ba.eval_trace())[-1].split(" --> ")[-1] == str(
        G.TOY_PROTEIN_SCORE)


@pytest.mark.parametrize("lowmem", [False, True])
def test_dnapol_prefix_on_the_device_route(lowmem, device_route,
                                           monkeypatch):
    seqA, strA, seqB, strB = dnapol_pair()
    mol = (seqA[:150], seqB[:150], strA[:150], strB[:150])
    ba = BiAligner(*mol, lowmem=lowmem, **DNAPOL_PREFIX, **CPU)
    assert ba._peak is not None
    assert ba.optimize() == 117180
    trace = ba.traceback()
    lines = list(ba.decode_trace(trace))
    monkeypatch.setattr(A, "_builds_on_device", lambda device: False)
    host = BiAligner(*mol, lowmem=lowmem, **DNAPOL_PREFIX, **CPU)
    assert host._peak is None
    assert host.optimize() == 117180
    assert trace == host.traceback()
    assert lines == list(host.decode_trace())
    for got, want in zip((ba.mu1, ba.mu2), (host.mu1, host.mu2)):
        np.testing.assert_array_equal(got, want)
