"""The port's own host layers against the JAX package's, module by module:
each is a copy that must behave exactly as its original on the same inputs
(tolerance 0: ints, strings and float64 arrays compared for equality)."""

import dataclasses
import filecmp
import inspect

import numpy as np
import pytest

import bialign_tpu as J
import bialign_tpu.config
import bialign_tpu.data
import bialign_tpu.io
import bialign_tpu.models.molecule
import bialign_tpu.ops.cases
import bialign_tpu.ops.checkpoint_dp
import bialign_tpu.ops.traceback
import bialign_tpu.parallel.batch
import bialign_tpu.parallel.driver
import bialign_tpu.render.decode
import bialign_tpu.render.plot
import bialign_tpu.scoring.fold
import bialign_tpu.scoring.structure
import bialign_tpu.scoring.tables
import bialign_tpu.models.triplet
import bialign_tpu.utils.profiling
import bialign_tpu.version
import golden as G
from bialign_tpu.ops import reference_dp
from test_pallas import _rand_pair

import bialign_tpu_torch as T
import bialign_tpu_torch.config
import bialign_tpu_torch.data
import bialign_tpu_torch.io
import bialign_tpu_torch.models.molecule
import bialign_tpu_torch.ops.cases
import bialign_tpu_torch.ops.checkpoint_dp
import bialign_tpu_torch.ops.traceback
import bialign_tpu_torch.parallel.batch
import bialign_tpu_torch.parallel.driver
import bialign_tpu_torch.render.decode
import bialign_tpu_torch.render.plot
import bialign_tpu_torch.scoring.fold
import bialign_tpu_torch.scoring.structure
import bialign_tpu_torch.scoring.tables
import bialign_tpu_torch.models.triplet
import bialign_tpu_torch.utils.profiling
import bialign_tpu_torch.version

RNA_A, RNA_B = G.TOY_RNA["seqA"], G.TOY_RNA["seqB"]
STR_A, STR_B = G.TOY_RNA["strA"], G.TOY_RNA["strB"]
PRO = G.TOY_PROTEIN


def _same(a, b):
    """Deep equality of molecule dicts, tuples, lists and arrays."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_version():
    assert T.__version__ == J.__version__
    assert (T.version.COMPAT_REFERENCE == J.version.COMPAT_REFERENCE)


# -- ops/cases.py ------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "NEG_INF", "STATES", "N_STATES", "STATE_INDEX", "STATE_BOTH_MATCH",
    "HALF_STATES", "NONAFFINE_COLS", "N_NONAFFINE_CASES"])
def test_cases_constants(name):
    assert getattr(T.ops.cases, name) == getattr(J.ops.cases, name)


def test_cases_functions():
    tc, jc = T.ops.cases, J.ops.cases
    assert np.array_equal(tc.STATES_ARR, jc.STATES_ARR)
    for q in range(jc.N_STATES):
        assert list(tc.iter_affine_cases(q)) == list(jc.iter_affine_cases(q))
    for src in jc.STATES:
        for col in jc.NONAFFINE_COLS:
            assert (tc.affine_score_multiplicities(src, col)
                    == jc.affine_score_multiplicities(src, col))
    for col in jc.NONAFFINE_COLS:
        assert (tc.nonaffine_case_multiplicities(col)
                == jc.nonaffine_case_multiplicities(col))
        for S in range(4):
            for o in [(0, 0, 0, 0), (3, 2, 3, 2), (1, 1, 0, 2), (5, 4, 8, 1),
                      (2, 2, 2 + S, 2 - S), (4, 4, 4 - S, 4 + S + 1)]:
                assert tc.guard_case(o, col, S) == jc.guard_case(o, col, S)


@pytest.mark.parametrize("beta,gamma,delta", [(-150, -50, -150),
                                              (-200, -50, -210), (-1, -2, -3)])
def test_cases_tables_array_for_array(beta, gamma, delta):
    ta = T.ops.cases.AffineTables(beta, gamma, delta)
    ja = J.ops.cases.AffineTables(beta, gamma, delta)
    for name in ("a_const", "b_src", "b_const", "c_src", "c_const",
                 "mu1_coef", "mu2_coef", "b_mu2_coef", "c_mu1_coef"):
        assert _same(getattr(ta, name), getattr(ja, name)), name
    assert ta.a_const_separable() == ja.a_const_separable()
    tn = T.ops.cases.NonAffineTables(gamma, delta)
    jn = J.ops.cases.NonAffineTables(gamma, delta)
    for name in ("cols", "mu1_coef", "mu2_coef", "const"):
        assert _same(getattr(tn, name), getattr(jn, name)), name


def test_check_int32_safe_on_both_sides_of_its_limit():
    mu = np.zeros((101, 101), dtype=np.int32)
    verdicts = set()
    # the bound grows with |gap_cost|: walk it across the limit
    for gap in (-200, -10 ** 5, -10 ** 6, -2 * 10 ** 6, -10 ** 7, -10 ** 8):
        p = dict(gap_cost=gap, gap_opening_cost=-150, shift_cost=-150)
        got = T.ops.cases.check_int32_safe(mu, mu, p)
        assert got == J.ops.cases.check_int32_safe(mu, mu, p)
        assert (T.ops.cases.int32_value_bound(mu, mu, p)
                == J.ops.cases.int32_value_bound(mu, mu, p))
        verdicts.add(got)
    assert verdicts == {True, False}
    # and the exact edge: the largest safe bound and the first unsafe one
    limit = -(1 << 30) - np.iinfo(np.int32).min - (1 << 20)
    per_col = 2 * (100 + 100 + 2)
    for mod in (T.ops.cases, J.ops.cases):
        big = np.full((101, 101), (limit - 1) // (2 * per_col), np.int64)
        zero = dict(gap_cost=0, gap_opening_cost=0, shift_cost=0)
        assert mod.check_int32_safe(big, big, zero)
        assert not mod.check_int32_safe(big + 1, big, zero)


# -- scoring, models ---------------------------------------------------------

def test_structure_and_fold():
    ts, js = T.scoring.structure, J.scoring.structure
    for db in (STR_A, STR_B, "((..))", "....", ""):
        assert ts.parse_dotbracket(db) == js.parse_dotbracket(db)
    seq = "GGGAAAUCCCGCGAAAGC"
    sbpp_t = T.scoring.fold.partition_bpp(seq)
    sbpp_j = J.scoring.fold.partition_bpp(seq)
    assert _same(sbpp_t, sbpp_j)
    assert ts.mea(sbpp_t) == js.mea(sbpp_j)
    assert _same(T.scoring.fold.predict_structure(seq),
                 J.scoring.fold.predict_structure(seq))
    a, b = "GC-GGAU", "G-AGGAU"
    assert ts.consensus_sequence(a, b) == js.consensus_sequence(a, b)
    assert (ts.highlight_sequence_identity(a, b)
            == js.highlight_sequence_identity(a, b))
    assert (ts.highlight_structure_identity("((-.))", "(-(.))")
            == js.highlight_structure_identity("((-.))", "(-(.))"))


@pytest.mark.parametrize("seq,struct,is_rna", [
    (RNA_A, STR_A, True),
    (RNA_B, STR_B, True),
    (RNA_A, None, True),           # folded: ViennaRNA if present, else fold.py
    (PRO["seqA"], PRO["strA"], False),
], ids=["rna_fixed_A", "rna_fixed_B", "rna_folded", "protein"])
def test_preprocess_molecule(seq, struct, is_rna):
    got = T.models.molecule.preprocess_molecule(seq, struct, is_rna=is_rna)
    want = J.models.molecule.preprocess_molecule(seq, struct, is_rna=is_rna)
    assert _same(got, want)
    if is_rna:
        assert (T.models.molecule.expected_pairing(got)
                == J.models.molecule.expected_pairing(want))


def test_preprocess_molecule_errors():
    for mod in (T.models.molecule, J.models.molecule):
        with pytest.raises(mod.MoleculeError, match="have to be provided"):
            mod.preprocess_molecule(PRO["seqA"], None, is_rna=False)
        with pytest.raises(mod.MoleculeError, match="same length"):
            mod.preprocess_molecule("ACGU", "..", is_rna=True)


@pytest.mark.parametrize("mol,is_rna,params", [
    (G.TOY_RNA, True, {}),
    (G.TOY_RNA, True, dict(sequence_match_similarity=70,
                           sequence_mismatch_similarity=-30,
                           structure_weight=250)),
    (PRO, False, dict(structure_weight=800)),
    (PRO, False, dict(simmatrix="BLOSUM62", structure_weight=800)),
    (dict(seqA="ACDEFGHIKLMNPQRSTVWY", strA="HHHHHEEEEECCCCCTTTTT",
          seqB="YWVTSRQPNMLKIHGFEDCA", strB="HHHHHEEEEECCCCCTTTTT"), False,
     dict(simmatrix="BLOSUM62", structure_weight=400)),
], ids=["rna_default", "rna_mismatch", "protein_match", "protein_blosum",
        "protein_blosum_all_residues"])
def test_build_score_tables(mol, is_rna, params):
    tabs = []
    for pkg in (T, J):
        molA = pkg.models.molecule.preprocess_molecule(
            mol["seqA"], mol["strA"], is_rna=is_rna)
        molB = pkg.models.molecule.preprocess_molecule(
            mol["seqB"], mol["strB"], is_rna=is_rna)
        tabs.append(pkg.scoring.tables.build_score_tables(
            molA, molB, params, is_rna=is_rna))
    (t1, t2), (j1, j2) = tabs
    assert _same(t1, j1) and _same(t2, j2)
    assert t1.dtype == np.int32 and t1.any() and t2.any()


def test_build_score_tables_unknown_residue():
    for pkg in (T, J):
        molA = pkg.models.molecule.preprocess_molecule("AC1", "HHH",
                                                       is_rna=False)
        with pytest.raises(KeyError):
            pkg.scoring.tables.build_score_tables(
                molA, molA, dict(simmatrix="BLOSUM62"), is_rna=False)


# -- io, data ----------------------------------------------------------------

def test_read_simmatrix(tmp_path):
    assert (T.io.read_simmatrix("BLOSUM62") == J.io.read_simmatrix("BLOSUM62"))
    assert (T.io.read_simmatrix("BLOSUM62", scale=7)
            == J.io.read_simmatrix("BLOSUM62", scale=7))
    path = T.io.materialize_matrix("BLOSUM62", str(tmp_path))
    assert T.io.read_simmatrix(path) == J.io.read_simmatrix(path)
    assert T.io.read_simmatrix(path) == T.io.read_simmatrix("BLOSUM62")
    assert T.io.BLOSUM62_TEXT == J.io.BLOSUM62_TEXT


@pytest.mark.parametrize("name", J.data.EXAMPLES)
def test_example_files_are_byte_equal_copies(name):
    assert T.data.EXAMPLES == J.data.EXAMPLES
    port = inspect.getfile(T.data).replace("__init__.py", name + ".gz")
    orig = inspect.getfile(J.data).replace("__init__.py", name + ".gz")
    assert port != orig
    assert filecmp.cmp(port, orig, shallow=False)
    assert T.data.example_text(name) == J.data.example_text(name)


@pytest.mark.parametrize("name", J.data.EXAMPLES[:2])
def test_read_molecule_from_file_on_the_ports_copies(name):
    got = T.io.read_molecule_from_file(T.data.example_path(name), "Protein")
    want = J.io.read_molecule_from_file(J.data.example_path(name), "Protein")
    assert got == want
    assert len(got[0]) == len(got[1]) > 900
    assert T.data.read_example(name) == want


@pytest.mark.parametrize("name", J.data.EXAMPLES[2:])
def test_read_fasta_on_the_ports_copies(name):
    path = T.data.example_path(name)
    assert T.io.read_fasta(path) == J.io.read_fasta(path)
    assert T.io.read_first_sequence(path) == J.io.read_first_sequence(path)
    assert len(T.io.read_first_sequence(path)) > 900


def test_structure_file_readers():
    stride = "\n".join([
        "CHN  toy.pdb A",
        "SEQ  1    ACDEF                                                 5",
        "STR       HHEEC",
    ])
    assert T.io.read_stride(stride) == J.io.read_stride(stride)
    res = "    1    1 A M              0   0  100"
    dssp = "\n".join(["header", "  #  RESIDUE AA STRUCTURE BRIDGE",
                      res.ljust(200), res.replace(" M ", " K ").ljust(200)])
    assert T.io.read_dssp(dssp) == J.io.read_dssp(dssp)


# -- ops/traceback.py --------------------------------------------------------

@pytest.mark.parametrize("n,m,S", [(5, 7, 1), (8, 8, 2), (7, 9, 0),
                                   (6, 5, 3)])
def test_host_walk_on_an_oracle_band(n, m, S):
    rng = np.random.default_rng(17 * n + m + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_affine(mu1, mu2, S, -150, -50, -150)
    got = T.ops.traceback.affine_traceback(H, mu1, mu2, S, -150, -50, -150)
    want = J.ops.traceback.affine_traceback(H, mu1, mu2, S, -150, -50, -150)
    assert _same(got, want) and got[1] is True
    H = reference_dp.fill_nonaffine(mu1, mu2, S, -200, -250)
    got = T.ops.traceback.nonaffine_traceback(H, mu1, mu2, S, -200, -250)
    want = J.ops.traceback.nonaffine_traceback(H, mu1, mu2, S, -200, -250)
    assert _same(got, want) and len(got) >= max(n, m)


# -- ops/checkpoint_dp.py ----------------------------------------------------

@pytest.mark.parametrize("D", [1, 8, 31, 32, 33, 85, 1862, 7991, 25991])
def test_default_block(D):
    assert (T.ops.checkpoint_dp.default_block(D)
            == J.ops.checkpoint_dp.default_block(D))


# -- render/decode.py, aligner -----------------------------------------------

ALIGNED = [
    ("rna_affine", G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS),
    ("rna_nonaffine", G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS),
    ("protein", G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS),
]


@pytest.fixture(scope="module", params=ALIGNED, ids=[a[0] for a in ALIGNED])
def aligned(request):
    """(JAX aligner, port aligner, the JAX aligner's trace) of one golden."""
    _name, mol, params = request.param
    ja = J.BiAligner(**mol, engine="xla", **params)
    ja.optimize()
    ta = T.BiAligner(**mol, engine="torch", device="cpu", **params)
    return ja, ta, ja.traceback()


def test_decode_constants():
    assert T.render.decode.OUTMODES == J.render.decode.OUTMODES
    assert T.render.decode.NL_ROW == J.render.decode.NL_ROW
    assert T.BiAligner.outmodes == J.BiAligner.outmodes
    assert T.aligner.PARAM_DEFAULTS == J.aligner.PARAM_DEFAULTS


def test_decode_trace_full(aligned):
    ja, ta, trace = aligned
    full = ta.decode_trace_full(trace)
    assert full == ja.decode_trace_full(trace)
    assert full == T.render.decode.decode_trace_full(
        trace, ja.molA, ja.molB, nameA="A", nameB="B", is_rna=ja._is_rna)


@pytest.mark.parametrize("outmode", list(J.render.decode.OUTMODES)
                         + ["sort", "bogus"])
@pytest.mark.parametrize("nodescription", [False, True])
def test_decode_trace_in_every_outmode(aligned, outmode, nodescription,
                                       capsys):
    ja, ta, trace = aligned
    full = ja.decode_trace_full(trace)
    kw = dict(outmode=outmode, nodescription=nodescription)
    got = list(T.render.decode.decode_trace(full, **kw))
    got_said = capsys.readouterr().out
    want = list(J.render.decode.decode_trace(full, **kw))
    assert got == want and got
    assert got_said == capsys.readouterr().out


def test_eval_trace(aligned):
    """The verbose replay, affine and non-affine: the port's own walk and
    band against the JAX aligner's, line for line."""
    ja, ta, trace = aligned
    assert ta.optimize() == ja.optimize()
    want = list(ja.eval_trace(trace))
    assert list(ta.eval_trace(trace)) == want
    assert list(ta.eval_trace()) == want
    assert want[-1].endswith(f"--> {ja.optimize()}")
    assert (ta.mu1_at(1, 1), ta.mu2_at(2, 3)) == (ja.mu1_at(1, 1),
                                                  ja.mu2_at(2, 3))


# -- config.py ---------------------------------------------------------------

def test_align_config():
    tf = {f.name: f.default for f in dataclasses.fields(T.AlignConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(J.AlignConfig)}
    assert tf.pop("engine") == "cuda" and jf.pop("engine") == "auto"
    assert tf.pop("device") == "cuda"        # the port's own field
    assert tf == jf
    cfg = T.AlignConfig.from_params(dict(
        G.TOY_RNA_AFFINE_PARAMS, engine="torch", device="cpu", unknown=1))
    assert cfg.affine and J.AlignConfig.from_params(
        G.TOY_RNA_AFFINE_PARAMS).affine
    ba = cfg.aligner(**G.TOY_RNA)
    assert isinstance(ba, T.BiAligner)
    assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
    for bad in (dict(type="DNA"), dict(max_shift=-1), dict(engine="pallas")):
        with pytest.raises(ValueError):
            T.AlignConfig(**bad)


# -- parallel/batch.py: the numpy part of the batched-scores path -----------

JB, TB = J.parallel.batch, T.parallel.batch
BATCH_SIZES = [(5, 7), (8, 8), (3, 12), (12, 3), (1, 1), (6, 6), (9, 4),
               (7, 7), (0, 3), (16, 17)]


def _batch_tables(seed=42, sizes=BATCH_SIZES):
    rng = np.random.default_rng(seed)
    return [_rand_pair(rng, n, m) for n, m in sizes]


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 64, 65, 508])
@pytest.mark.parametrize("q", [1, 8, 64, 128])
def test_batch_quantize(x, q):
    assert TB.quantize(x, q) == JB.quantize(x, q)


@pytest.mark.parametrize("n,m,N,M", [(5, 7, 8, 8), (8, 8, 8, 8),
                                     (0, 3, 8, 16), (1, 1, 64, 64)])
def test_batch_pad_table(n, m, N, M):
    mu1, _mu2 = _rand_pair(np.random.default_rng(n + m), n, m)
    assert _same(TB.pad_table(mu1, N, M), JB.pad_table(mu1, N, M))


@pytest.mark.parametrize("quantum", [8, 16, 64])
def test_batch_make_buckets_dense(quantum):
    tables = _batch_tables()
    want = JB.make_buckets_dense(tables, quantum)
    got = TB.make_buckets_dense(tables, quantum)
    assert list(got) == list(want)            # same keys, same order
    for key in want:
        assert _same(dataclasses.asdict(got[key]),
                     dataclasses.asdict(want[key]))


@pytest.mark.parametrize("sizes,pad_count", [
    (BATCH_SIZES[:4], 0), (BATCH_SIZES[:4], 3),
    ([(6, 6)] * 5, 0), ([(6, 6)] * 5, 2),   # the single-shape fast path
    ([(0, 3)], 0),
])
def test_batch_stack_padded(sizes, pad_count):
    raws = [mu1 for mu1, _mu2 in _batch_tables(7, sizes)]
    want = JB.stack_padded(raws, 16, 24, pad_count)
    got = TB.stack_padded(raws, 16, 24, pad_count)
    assert got.shape == (len(sizes) + pad_count, 17, 25)
    assert _same(got, want)


@pytest.mark.parametrize("affine,params,safe", [
    (True, (-150, -50, -150), True),
    (False, (-200, -250), True),
    (True, (-20_000_000, -2_000_000, -2_000_000), False),
    (False, (-2_000_000, -20_000_000), False),
])
def test_batch_int32_guard(affine, params, safe):
    tables = _batch_tables()[:3]
    if not safe:        # as tests/test_batch.py:301-307
        tables.append((np.full((9, 9), 2_000_000, dtype=np.int32),) * 2)
    for guard in (JB._require_int32_safe, TB._require_int32_safe):
        if safe:
            guard(tables, params, affine)
        else:
            with pytest.raises(ValueError, match="int32"):
                guard(tables, params, affine)


# -- parallel/batch.py: the numpy part of the alignments and codes paths ----

CODE_PAIRS = [("ACDE", "ACD", "HHCC", "HCC"), ("", "KR", "", "EE"),
              ("RAKLPLKEK", "KAKLPLKEKK", "CHHHHHHHH", "HHHHHHHHHC"),
              ("W", "", "C", ""), (PRO["seqA"], PRO["seqB"], PRO["strA"],
                                   PRO["strB"])]


@pytest.mark.parametrize("pair", CODE_PAIRS, ids=[f"{len(p[0])}x{len(p[1])}"
                                                  for p in CODE_PAIRS])
def test_batch_encode_pair(pair):
    got, want = TB.encode_pair(*pair), JB.encode_pair(*pair)
    assert all(g.dtype == np.uint8 for g in got) and _same(got, want)


def test_batch_encode_pair_outside_latin1_raises_key_error():
    """The JAX package raises UnicodeEncodeError here; the port raises what
    the tables path raises for a residue it does not know."""
    with pytest.raises(UnicodeEncodeError):
        JB.encode_pair("ACΔE", "ACD", "HHCC", "HCC")
    with pytest.raises(KeyError, match="Δ"):
        TB.encode_pair("ACΔE", "ACD", "HHCC", "HCC")
    with pytest.raises(KeyError):
        TB.encode_pair("ACDE", "ACD", "HHCC", "H€C")


@pytest.mark.parametrize("match,mismatch", [(100, 0), (5, -4), (0, 0)])
def test_batch_match_mismatch_lut(match, mismatch):
    got = TB.match_mismatch_lut(match, mismatch)
    assert got.dtype == np.int32
    assert _same(got, JB.match_mismatch_lut(match, mismatch))


@pytest.mark.parametrize("quantum", [8, 64])
def test_batch_code_buckets_are_the_jax_ones_without_padding(quantum):
    """The JAX buckets pad ca/sa to the lane width and the batch axis to a
    multiple of PACK; the port's hold the same codes without either."""
    pairs = [TB.encode_pair(*p) for p in CODE_PAIRS]
    want = JB._code_buckets(pairs, quantum)
    got = TB._code_buckets(pairs, quantum)
    assert list(got) == list(want)
    for (N, M), (indices, ca, cb, sa, sb, ns, ms) in want.items():
        b = got[N, M]
        B = len(indices)
        assert b.indices == indices and (b.N, b.M) == (N, M)
        assert b.n == ns[:B].tolist() and b.m == ms[:B].tolist()
        gca, gcb, gsa, gsb = b.mu1d
        assert gca.shape == gsa.shape == (B, N + 1)
        assert gcb.shape == gsb.shape == (B, M + 1)
        assert all(a.dtype == np.uint8 for a in b.mu1d)
        assert _same(gca, ca[:B, :N + 1]) and _same(gsa, sa[:B, :N + 1])
        assert _same(gcb, cb[:B]) and _same(gsb, sb[:B])
        assert not ca[:B, N + 1:].any()          # what was cut was padding


def test_batch_code_buckets_check_the_structure_lengths():
    with pytest.raises(ValueError, match="structure codes"):
        TB._code_buckets([TB.encode_pair("ACD", "AC", "HH", "HC")], 8)


@pytest.mark.parametrize("affine,params,sw,peak,safe", [
    (True, (-150, -50, -150), 800, 17, True),
    (False, (-200, -250), 400, 100, True),
    (True, (-150, -50, -150), 800, (1 << 24) + 5, True),   # the JAX 2^24 limit
    (True, (-150, -50, -150), 40_000_000, 17, False),
    (False, (-200, -250), 400, 40_000_000, False),
])
def test_batch_int32_guard_of_the_codes_path(affine, params, sw, peak, safe):
    """The drift bound of the JAX guard, from the table's peak and the
    structure weight, without its 2^24 refusal (the port indexes the table,
    it does not contract float32 one-hots)."""
    lut = TB.match_mismatch_lut(peak, -3)
    buckets = {(4, 4): None, (2, 4): None}   # the bound takes the largest
    if safe:
        TB._require_int32_safe_codes(lut, sw, buckets, params, affine)
    else:
        with pytest.raises(ValueError, match="int32"):
            TB._require_int32_safe_codes(lut, sw, buckets, params, affine)
    if peak < 1 << 24:
        if safe:
            JB._require_int32_safe_codes(lut, sw, buckets, params, affine)
        else:
            with pytest.raises(ValueError, match="int32"):
                JB._require_int32_safe_codes(lut, sw, buckets, params, affine)
    else:
        with pytest.raises(ValueError, match="2\\^24"):
            JB._require_int32_safe_codes(lut, sw, buckets, params, affine)


@pytest.mark.parametrize("N,M,S,affine,budget,chunk", [
    (512, 512, 1, True, None, 100),     # 28 such pairs are one chunk
    (512, 512, 1, True, 2 << 30, 12),
    (4096, 4096, 1, True, None, 1),     # a 4000 x 4000 pair still fits
    (64, 64, 1, True, None, 1024),      # capped
    (512, 512, 2, False, None, 326),
    (8192, 8192, 3, True, None, 1),     # never less than one pair
])
def test_batch_auto_chunk_is_sized_for_the_card(N, M, S, affine, budget,
                                                chunk):
    """The port's own budget (16 GiB of an 80 GB card), without the TPU's
    lane and diagonal rounding; one band per pair is
    (N+M+1) * (9) * W^2 * (N+1) * 4 bytes."""
    assert TB.BAND_BUDGET == 16 << 30
    got = TB._auto_chunk(N, M, S, affine, budget)
    per_pair = (N + M + 1) * (9 if affine else 1) * (2 * S + 1) ** 2 \
        * (N + 1) * 4
    assert got == max(1, min(1024, (budget or TB.BAND_BUDGET) // per_pair))
    assert got == min(chunk, 1024)


# -- parallel/driver.py, utils/profiling.py: the host parts of the driver --

def test_driver_pair_record():
    kw = dict(id="p", seqA="AC", seqB="A", strA="HH", strB="C")
    got = T.parallel.driver.PairRecord(**kw)
    want = J.parallel.driver.PairRecord(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(T.parallel.driver.PairRecord("q", "A", "C")) \
        == dataclasses.asdict(J.parallel.driver.PairRecord("q", "A", "C"))


def _spool_session(mod, path):
    """What a ResultSpool says and writes over two sessions, the first cut
    in the middle of a line."""
    rs = mod.ResultSpool(str(path))
    rs.write("a", 1)
    rs.write_many([("b", np.int64(2), {"trace": [8, 15], "complete": True}),
                   ("c", -3, None)])
    rs.close()
    with open(path, "a") as fh:
        fh.write('{"id": "d", "sc')
    rs = mod.ResultSpool(str(path))
    done = [rs.is_done(x) for x in "abcd"]
    rs.write("d", 4)
    rs.close()
    return done, path.read_text()


def test_driver_result_spool(tmp_path):
    got = _spool_session(T.parallel.driver, tmp_path / "t.jsonl")
    assert got == _spool_session(J.parallel.driver, tmp_path / "j.jsonl")
    assert got[0] == [True, True, True, False]


@pytest.mark.parametrize("codes", [[], [0, 15, 8, 3, 12, 10, 5]])
def test_driver_trace_codes(codes):
    td, jd = T.parallel.driver, J.parallel.driver
    trace = jd.trace_from_codes(codes)
    assert td.trace_from_codes(codes) == trace
    assert td.trace_to_codes(trace) == jd.trace_to_codes(trace) == codes


def test_driver_merge_spools(tmp_path):
    shards = [tmp_path / "s0.jsonl", tmp_path / "s1.jsonl"]
    shards[0].write_text('{"id": "a", "score": 1}\n{"id": "b", "score": 2}\n')
    shards[1].write_text('{"id": "c", "score": 3, "trace": [8]}\n'
                         '{"id": "a", "score": 1}\n{"id"')
    paths = [str(p) for p in shards]
    got = T.parallel.driver.merge_spools(paths)
    assert got == J.parallel.driver.merge_spools(paths)
    assert list(got) == ["a", "b", "c"]


@pytest.mark.parametrize("n,m,S", [(0, 0, 0), (928, 933, 1), (5, 7, 4)])
def test_profiling_band_cells(n, m, S):
    assert T.utils.profiling.band_cells(n, m, S) \
        == J.utils.profiling.band_cells(n, m, S)


def test_profiling_run_stats():
    runs = []
    for mod in (T.utils.profiling, J.utils.profiling):
        st = mod.RunStats()
        assert (st.pairs_per_s, st.cells_per_s, st.pairs_per_dispatch) \
            == (0.0, 0.0, 0.0)
        st.add_batch("chunk", 5, 1000, n_dispatches=2)
        st.add_batch((64, 64), 3, 500)
        st.seconds = 2.0
        st.start().stop()
        st.seconds = 2.0
        runs.append((dataclasses.asdict(st), st.pairs_per_s, st.cells_per_s,
                     st.pairs_per_dispatch, st.to_json()))
    assert runs[0] == runs[1]


# -- models/triplet.py: the numpy parts ---------------------------------------

def test_triplet_constants():
    tt, jt = T.models.triplet, J.models.triplet
    assert tt.TRIPLET_COLS == jt.TRIPLET_COLS
    for gamma, delta in [(-200, -250), (-50, -150), (0, 0), (7, -3)]:
        assert tt._case_consts(gamma, delta) == jt._case_consts(gamma, delta)


@pytest.mark.parametrize("n,m,S", [(4, 6, 1), (6, 3, 2), (0, 2, 1), (3, 3, 0)])
def test_triplet_fill_oracle(n, m, S):
    mu1, mu2 = _rand_pair(np.random.default_rng(n * 7 + m + S), n, m)
    assert _same(T.models.triplet.fill_oracle(mu1, mu2, S, -200, -250),
                 J.models.triplet.fill_oracle(mu1, mu2, S, -200, -250))


# -- render/plot.py ------------------------------------------------------------

def test_plot_breaklines_and_runs():
    tp, jp = T.render.plot, J.render.plot
    ali = [("A", "abcdefgh"), ("B", "12345678")]
    for width in (1, 3, 8, 20):
        assert tp.breaklines(ali, width) == jp.breaklines(ali, width)
    assert tp.breaklines([], 3) == jp.breaklines([], 3) == []
    for text in ("HHEEC", "", "A", "CCCHHHHHHEEEC-"):
        assert list(tp.runs(text)) == list(jp.runs(text))
    assert tp.SS_GLYPHS == jp.SS_GLYPHS
    assert tp.SS_FALLBACK == jp.SS_FALLBACK
    assert dataclasses.asdict(tp._Tracks()) \
        == dataclasses.asdict(jp._Tracks())


@pytest.fixture(scope="module")
def toy_protein_full():
    ba = J.BiAligner(PRO["seqA"], PRO["seqB"], PRO["strA"], PRO["strB"],
                     engine="numpy", **G.TOY_PROTEIN_PARAMS)
    ba.optimize()
    return ba.decode_trace_full()


def test_plot_fourway_from_full(toy_protein_full):
    got = T.render.plot.fourway_from_full(toy_protein_full)
    assert got == J.render.plot.fourway_from_full(toy_protein_full)
    assert [name for name, _ in got] == [
        "A", "B", "A ss", "B ss", "A shifts", "B shifts"]


def test_plot_alignment(tmp_path, toy_protein_full):
    """tests/test_io_render.py's plot of the toy pair, through the port's
    copy and the original: the same figure, drawn element by element."""
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    def drawn(fig):
        return [[(type(a).__name__, getattr(a, "get_text", lambda: None)(),
                  repr(getattr(a, "get_xydata", lambda: None)()))
                 for a in ax.get_children()] for ax in fig.axes]

    out = tmp_path / "ali.svg"
    got = T.render.plot.plot_alignment(toy_protein_full, 60,
                                       outname=str(out))
    assert out.exists() and out.stat().st_size > 0
    want = J.render.plot.plot_alignment(toy_protein_full, 60)
    assert drawn(got) == drawn(want)
    plt.close("all")
    with pytest.raises(TypeError, match="unexpected"):
        T.render.plot.plot_alignment(toy_protein_full, 60, bogus=1)
