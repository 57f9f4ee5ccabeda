"""Homologs of the configuration's base pair: each end of A and of B
trimmed by a number drawn from ``trim`` [lo, hi], and a share
``substitution`` of each molecule's residues replaced by another of
``alphabet``; the structure strings are kept position for position."""

from portbench.generator import base_pair, rng_of, substitute


def records(spec, config, seed, root):
    seqA, strA, seqB, strB = base_pair(config, root)
    lo, hi = spec["trim"]
    share, alphabet = spec["substitution"], spec["alphabet"]
    rng = rng_of(seed)
    r = 0
    while True:
        cut = rng.integers(lo, hi + 1, 4)
        a = slice(cut[0], len(seqA) - cut[1])
        b = slice(cut[2], len(seqB) - cut[3])
        yield (f"h-{r}", substitute(rng, seqA[a], share, alphabet),
               substitute(rng, seqB[b], share, alphabet), strA[a], strB[b])
        r += 1
