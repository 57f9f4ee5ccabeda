"""Windows of the configuration's base pair: A's length drawn from
``length`` [lo, hi], B's within ``b_delta`` of it, each cut at a place
drawn from the seed; every ``full_every``-th record (from the first) is the
whole pair."""

from portbench.generator import BLOCK, base_pair, rng_of


def records(spec, config, seed, root):
    seqA, strA, seqB, strB = base_pair(config, root)
    lo, hi = spec["length"]
    delta = spec["b_delta"]
    every = spec["full_every"]
    rng = rng_of(seed)
    r = 0
    while True:
        la = rng.integers(lo, hi + 1, BLOCK)
        lb = la + rng.integers(-delta, delta + 1, BLOCK)
        ua, ub = rng.random(BLOCK), rng.random(BLOCK)
        for k in range(BLOCK):
            if r % every == 0:
                yield (f"full-{r}", seqA, seqB, strA, strB)
            else:
                a0 = int(ua[k] * (len(seqA) - la[k] + 1))
                b0 = int(ub[k] * (len(seqB) - lb[k] + 1))
                yield (f"w-{r}", seqA[a0:a0 + la[k]], seqB[b0:b0 + lb[k]],
                       strA[a0:a0 + la[k]], strB[b0:b0 + lb[k]])
            r += 1
