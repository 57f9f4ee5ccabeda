"""Synthetic RNA pairs: A's length the k-th of ``length`` [lo, hi] in the
order 0.5, 0, 1, 0.25, 0.75, ... of the range for every seed (any prefix
centres on the middle, so a window of a few pairs does the same work
whatever the seed), letters from ``alphabet``, a nested dot-bracket
structure with a paired share in ``paired`` [lo, hi] (stems of ``stem``
[lo, hi] pairs, loops of 3 or more); B is A with a share ``substitution``
of its bases replaced, a share ``opened`` of its base pairs opened, and
``indels`` [lo, hi] short insertions or deletions of ``indel_length``
[lo, hi] unpaired bases, so B's brackets stay balanced."""

import numpy as np

from portbench.generator import rng_of, spread, substitute


def nested_structure(rng, n, stem):
    """A random nested dot-bracket string of length ``n``: stems of
    ``stem`` [lo, hi] pairs closing loops of 3 or more."""
    out = []
    todo = [("seg", n)]
    while todo:
        what, size = todo.pop()
        if what == "text":
            out.append(size)
            continue
        while size > 0:
            if size >= 2 * stem[0] + 3 and rng.random() < 0.2:
                L = int(rng.integers(stem[0], min(stem[1], (size - 3) // 2)
                                     + 1))
                inner = int(rng.integers(3, size - 2 * L + 1))
                rest = size - 2 * L - inner
                # emitted in order: the helix's opening, its inside, its
                # closing, then the rest of this segment
                todo.append(("seg", rest))
                todo.append(("text", ")" * L))
                todo.append(("seg", inner))
                todo.append(("text", "(" * L))
                break
            out.append(".")
            size -= 1
    return "".join(out)


def _rna_edit(rng, seq, st, spec):
    """B from A: substitutions, opened pairs and indels of unpaired runs."""
    seq = substitute(rng, seq, spec["substitution"], spec["alphabet"])
    chars = list(st)
    stack, pairs = [], []
    for pos, ch in enumerate(chars):
        if ch == "(":
            stack.append(pos)
        elif ch == ")":
            pairs.append((stack.pop(), pos))
    for k in np.flatnonzero(rng.random(len(pairs)) < spec["opened"]):
        i, j = pairs[k]
        chars[i] = chars[j] = "."
    letters = list(seq)
    n_indels = int(rng.integers(spec["indels"][0], spec["indels"][1] + 1))
    for _ in range(n_indels):
        L = int(rng.integers(spec["indel_length"][0],
                             spec["indel_length"][1] + 1))
        # inside runs of unpaired bases that keep 3 or more after a deletion
        free = [p for a, b in _unpaired_runs(chars) if b - a >= L + 3
                for p in range(a, b - L + 1)]
        if not free:
            continue
        p = free[int(rng.integers(len(free)))]
        if rng.random() < 0.5:
            del chars[p:p + L], letters[p:p + L]
        else:
            ins = [spec["alphabet"][int(x)]
                   for x in rng.integers(len(spec["alphabet"]), size=L)]
            chars[p:p] = ["."] * L
            letters[p:p] = ins
    return "".join(letters), "".join(chars)


def _unpaired_runs(chars):
    """[(start, end)] of the maximal runs of '.'."""
    runs, start = [], None
    for pos, ch in enumerate(chars + [")"]):
        if ch == "." and start is None:
            start = pos
        elif ch != "." and start is not None:
            runs.append((start, pos))
            start = None
    return runs


def records(spec, config, seed, root):
    lo, hi = spec["length"]
    plo, phi = spec["paired"]
    alphabet = spec["alphabet"]
    rng = rng_of(seed)
    r = 0
    while True:
        n = lo + int(round((hi - lo) * spread(r)))
        while True:
            st = nested_structure(rng, n, spec["stem"])
            share = 2 * st.count("(") / n
            if plo <= share <= phi:
                break
        seqA = "".join(alphabet[int(x)]
                       for x in rng.integers(len(alphabet), size=n))
        seqB, stB = _rna_edit(rng, seqA, st, spec)
        yield (f"r-{r}", seqA, seqB, st, stB)
        r += 1
