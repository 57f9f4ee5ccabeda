"""The traffic generator: the same seed gives the same records, every
record within the ranges its mix states."""

import json
from itertools import islice
from pathlib import Path

import pytest

from portbench import generator
from portbench.reference.tables import partners

ROOT = Path(__file__).resolve().parents[2]
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


def _cell(config, mix):
    return (json.loads((ROOT / f"portbench/configs/{config}.json").read_text()),
            json.loads((ROOT / f"portbench/traffic/{mix}.json").read_text()))


@pytest.mark.parametrize("config, mix, count", [
    ("readme-dnapol1", "scores", 600), ("readme-dnapol1", "align", 300),
    ("readme-dnapol1", "pair", 20), ("cli-defaults-rna", "pair16s", 6)])
def test_same_seed_same_records(config, mix, count):
    c, m = _cell(config, mix)
    for seed in SEEDS[:3]:
        a = list(islice(generator.records(c, m, seed, ROOT), count))
        b = list(islice(generator.records(c, m, seed, ROOT), count))
        assert a == b
    other = list(islice(generator.records(c, m, SEEDS[3], ROOT), count))
    assert other != a


@pytest.mark.parametrize("seed", SEEDS)
def test_windows_in_range(seed):
    c, m = _cell("readme-dnapol1", "scores")
    spec = m["records"]
    base = generator.base_pair(c, ROOT)
    recs = list(islice(generator.records(c, m, seed, ROOT), 700))
    for r, (rid, a, b, sa, sb) in enumerate(recs):
        assert len(a) == len(sa) and len(b) == len(sb)
        if r % spec["full_every"] == 0:
            assert rid.startswith("full-") and (a, sa, b, sb) == base
            continue
        assert spec["length"][0] <= len(a) <= spec["length"][1]
        assert abs(len(a) - len(b)) <= spec["b_delta"]
        assert a in base[0] and b in base[2]


@pytest.mark.parametrize("seed", SEEDS)
def test_homologs_in_range(seed):
    c, m = _cell("readme-dnapol1", "pair")
    spec = m["records"]
    seqA, strA, seqB, strB = generator.base_pair(c, ROOT)
    for _rid, a, b, sa, sb in islice(generator.records(c, m, seed, ROOT), 30):
        lo, hi = spec["trim"]
        assert len(seqA) - 2 * hi <= len(a) <= len(seqA) - 2 * lo
        assert len(seqB) - 2 * hi <= len(b) <= len(seqB) - 2 * lo
        assert sa in strA and sb in strB and len(sa) == len(a)
        assert set(a) <= set(spec["alphabet"]) | set(seqA)


@pytest.mark.parametrize("seed", SEEDS)
def test_rna_pairs_in_range(seed):
    c, m = _cell("cli-defaults-rna", "pair16s")
    spec = m["records"]
    lo, hi = spec["length"]
    recs = list(islice(generator.records(c, m, seed, ROOT), 5))
    sizes = [lo + round((hi - lo) * generator.spread(k)) for k in range(5)]
    assert [len(r[1]) for r in recs] == sizes      # every seed alike
    for _rid, a, b, sa, sb in recs:
        assert len(sa) == len(a) and len(sb) == len(b)
        share = 2 * sa.count("(") / len(a)
        assert spec["paired"][0] <= share <= spec["paired"][1]
        for s in (sa, sb):
            p = partners(s)                       # balanced, else raises
            paired = [i for i in range(1, len(p)) if p[i] > i]
            assert all(p[i] - i >= 4 for i in paired)   # loops of 3 or more
        assert set(a + b) <= set(spec["alphabet"])
        assert abs(len(a) - len(b)) <= spec["indels"][1] * \
            spec["indel_length"][1]


def test_spread_prefixes_centre():
    shares = [generator.spread(k) for k in range(9)]
    assert shares == [0.5, 0.0, 1.0, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]
    for k in (1, 3, 5, 9):
        assert sum(shares[:k]) / k == pytest.approx(0.5, abs=0.07)


@pytest.mark.parametrize("seed", SEEDS)
def test_substitute_changes_each_hit_to_another_letter(seed):
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    seq = (alphabet + "X") * 200
    rng = generator.rng_of(seed)
    out = generator.substitute(rng, seq, 0.05, alphabet)
    assert len(out) == len(seq)
    changed = [(a, b) for a, b in zip(seq, out) if a != b]
    assert all(b in alphabet for _a, b in changed)
    assert 0.03 * len(seq) <= len(changed) <= 0.07 * len(seq)
    # the same draws, so a hit never keeps its letter
    hits = generator.rng_of(seed).random(len(seq)) < 0.05
    assert len(changed) == int(hits.sum())
