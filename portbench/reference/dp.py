"""Plain PyTorch fill of the BiAlign band and its walk, for the benchmark's
check.

The fill runs over the antidiagonals d = i + j of a batch of pairs padded to
one (N, M): every case whose column advances i or j reads diagonal d - 1 or
d - 2, kept in a ring of three padded slabs; the columns (0, 0, c, d) stay
in their cell (i, j) and are closed by 2 S relaxation passes over the W x W
shift positions (each pass lengthens the chains it has closed by one step).
A predecessor off the band reads the ring's padding, ``VERY_NEG``, far
below any value a path can reach, so it never wins a max; a cell with no
predecessor in the band at all holds ``NEG_INF``, as upstream.  A pair
padded to (N, M) reads only its own cells: every predecessor has smaller
coordinates.  Values are int64 unless ``dtype`` asks otherwise (the
control computes in int16).

The walk (:func:`walk`) reads one pair's band on the host in the upstream
order: the non-affine walk takes the first case that reproduces a cell,
the affine one the co-optimal case of least (total |shift|, |net B shift|),
first on ties, starting from the best state of least intrinsic shift
(bialignment.pyx:513-586).
"""

from __future__ import annotations

import numpy as np
import torch

from .recurrence import (
    BOTH_MATCH,
    NEG_INF,
    NONAFFINE_COLUMNS,
    STATES,
    affine_cases,
    affine_terms,
    case_value_terms,
    nonaffine_terms,
    pred_in_band,
)


def sentinels(dtype):
    """(NEG_INF, VERY_NEG) for ``dtype``: upstream's -2^30 and a padding far
    below it; scaled down to fit a narrower integer type."""
    if dtype == torch.int64:
        return NEG_INF, -(1 << 50)
    bits = torch.iinfo(dtype).bits
    return -(1 << (bits - 3)), -(1 << (bits - 2))


def _no_case_table(affine, S):
    """[16, W, W, Q] bool: no case of target q has its predecessor in the
    band at a cell whose (i, j, k, l) are zero as the 4 bits of the first
    index say (i first), at shift position (sk, sl)."""
    W = 2 * S + 1
    Q = len(STATES) if affine else 1
    out = np.zeros((16, W, W, Q), dtype=bool)
    for code, sk, sl, q in np.ndindex(16, W, W, Q):
        nonzero = [not (code >> (3 - b)) & 1 for b in range(4)]
        cols = ([c for _s, c, _g in affine_cases(q)] if affine
                else list(NONAFFINE_COLUMNS))
        out[code, sk, sl, q] = not any(
            all(nonzero[b] or not col[b] for b in range(4))
            and 0 <= sk + col[0] - col[2] <= 2 * S
            and 0 <= sl + col[1] - col[3] <= 2 * S
            for col in cols)
    return torch.from_numpy(out)


def run(tables, S, costs, *, affine, store=False, device="cpu",
        dtype=torch.int64):
    """Scores (and bands) of pairs given as [(mu1, mu2)] numpy tables.

    Returns (scores, bands): ``scores`` a list of ints; ``bands`` a list of
    numpy arrays [Q, n+1, m+1, W, W] (the pair's own cells) when ``store``,
    else None.
    """
    B = len(tables)
    N = max(t[0].shape[0] for t in tables) - 1
    M = max(t[0].shape[1] for t in tables) - 1
    W = 2 * S + 1
    Q = len(STATES) if affine else 1
    dev = torch.device(device)
    neg_inf, very_neg = sentinels(dtype)

    mu1 = torch.zeros((B, N + 1, M + 1), dtype=dtype)
    mu2 = torch.zeros((B, N + 1, M + 1), dtype=dtype)
    for b, (t1, t2) in enumerate(tables):
        n1, m1 = t1.shape
        mu1[b, :n1, :m1] = torch.from_numpy(np.asarray(t1, np.int64)).to(dtype)
        mu2[b, :n1, :m1] = torch.from_numpy(np.asarray(t2, np.int64)).to(dtype)
    mu1, mu2 = mu1.to(dev), mu2.to(dev)
    ends = [(t[0].shape[0] - 1, t[0].shape[1] - 1) for t in tables]

    cases = case_value_terms(affine, costs)
    # external cases grouped by column: {col: [(q, s, const, m1, m2)]}
    ext, internal = {}, {}
    for q, s, col, const, m1, m2 in cases:
        bucket = internal if col[0] == col[1] == 0 else ext
        bucket.setdefault(col, []).append((q, s, const, m1, m2))

    def const_tensor(entries):
        """[Q_target, Q_source] constants, very_neg where no case."""
        t = torch.full((Q, Q), very_neg, dtype=dtype)
        for q, s, const, _m1, _m2 in entries:
            t[q, s] = const
        return t.to(dev)

    groups = []
    for table, is_internal in ((ext, False), (internal, True)):
        for col, entries in table.items():
            targets = sorted({e[0] for e in entries})
            m1 = {e[0]: e[3] for e in entries}
            m2 = {e[0]: e[4] for e in entries}
            groups.append(dict(
                col=col, internal=is_internal,
                targets=torch.tensor(targets, device=dev),
                const=const_tensor(entries)[targets],     # [T, Q]
                m1=torch.tensor([m1[q] for q in targets], dtype=dtype,
                                device=dev).view(1, -1, 1, 1, 1),
                m2=torch.tensor([m2[q] for q in targets], dtype=dtype,
                                device=dev).view(1, -1, 1, 1, 1),
                any_m1=any(m1.values()), any_m2=any(m2.values())))

    no_case = _no_case_table(affine, S).to(dev)            # [16, W, W, Q]
    ring = torch.full((3, B, Q, N + 3, W + 2, W + 2), very_neg, dtype=dtype,
                      device=dev)
    band = (torch.full((B, Q, N + 1, M + 1, W, W), very_neg, dtype=dtype,
                       device=dev) if store else None)
    finals = {}
    ii = torch.arange(N + 1, device=dev).view(-1, 1, 1)
    sk = torch.arange(W, device=dev).view(1, -1, 1)
    sl = torch.arange(W, device=dev).view(1, 1, -1)
    want = {n + m for n, m in ends}
    neg_inf_t = torch.tensor(neg_inf, dtype=dtype, device=dev)
    inner = (slice(None), slice(None), slice(1, N + 2), slice(1, W + 1),
             slice(1, W + 1))

    for d in range(N + M + 1):
        jj = d - ii
        kk = ii + sk - S
        ll = jj + sl - S
        valid = ((jj >= 0) & (jj <= M) & (kk >= 0) & (kk <= N)
                 & (ll >= 0) & (ll <= M))                       # [N+1, W, W]
        invalid = ~valid.view(1, 1, N + 1, W, W)
        mu1_d = mu1[:, ii[:, 0, 0], jj[:, 0, 0].clamp(0, M)]    # [B, N+1]
        mu1_d = mu1_d.view(B, 1, N + 1, 1, 1)
        mu2_d = mu2[:, kk.clamp(0, N), ll.clamp(0, M)]          # [B, N+1, W, W]
        mu2_d = mu2_d.view(B, 1, N + 1, W, W)

        def candidates(src_slab, g):
            """Best value of each of the group's targets over its sources:
            [B, T, N+1, W, W]."""
            x0, x1, x2, x3 = g["col"]
            pred = src_slab[:, :, 1 - x0:2 - x0 + N,
                            1 + x0 - x2:1 + x0 - x2 + W,
                            1 + x1 - x3:1 + x1 - x3 + W]        # [B, Q, ...]
            c = g["const"].view(1, -1, Q, 1, 1, 1)
            v = (pred.unsqueeze(1) + c).amax(2)                 # [B, T, ...]
            if g["any_m1"]:
                v = v + g["m1"] * mu1_d
            if g["any_m2"]:
                v = v + g["m2"] * mu2_d
            return v

        # cases from diagonals d - 1 and d - 2
        cur = torch.full((B, Q, N + 1, W, W), very_neg, dtype=dtype,
                         device=dev)
        for g in groups:
            if not g["internal"]:
                x0, x1 = g["col"][:2]
                idx = g["targets"]
                cur[:, idx] = torch.maximum(
                    cur[:, idx], candidates(ring[(d - x0 - x1) % 3], g))
        code = ((ii == 0).long() * 8 + (jj == 0).long() * 4
                + (kk == 0).long() * 2 + (ll == 0).long())      # [N+1, W, W]
        nocase = no_case[code, sk, sl].permute(3, 0, 1, 2).unsqueeze(0)
        cur = torch.where(nocase, neg_inf_t, cur)
        cur.masked_fill_(invalid, very_neg)
        if d == 0:
            origin = torch.full((Q,), neg_inf, dtype=dtype, device=dev)
            origin[BOTH_MATCH if affine else 0] = 0
            cur[:, :, 0, S, S] = origin
        slot = ring[d % 3]
        slot.fill_(very_neg)
        slot[inner] = cur
        # cases within the cell, columns (0, 0, c, d): chains of up to 2 S
        # steps
        for _ in range(2 * S):
            for g in groups:
                if g["internal"]:
                    idx = g["targets"]
                    here = slot[inner][:, idx]
                    slot[:, idx, 1:N + 2, 1:W + 1, 1:W + 1] = torch.maximum(
                        here, candidates(slot, g))
        done = slot[inner]
        done.masked_fill_(invalid, very_neg)
        if store:
            lo, hi = max(0, d - M), min(N, d)
            rows = torch.arange(lo, hi + 1, device=dev)
            band[:, :, rows, d - rows] = done[:, :, lo:hi + 1]
        if d in want:
            finals[d] = done.clone()

    scores = []
    for b, (n, m) in enumerate(ends):
        last = finals[n + m][b, :, n, S, S]
        scores.append(int(last.max()))
    bands = None
    if store:
        bands = [band[b, :, :n + 1, :m + 1].cpu().numpy()
                 for b, (n, m) in enumerate(ends)]
    return scores, bands


def walk(H, mu1, mu2, S, costs, *, affine):
    """(trace, complete) of one pair's band ``H`` [Q, n+1, m+1, W, W] (numpy)
    with its tables; the trace is forward, a list of 4-tuples."""
    n, m = H.shape[1] - 1, H.shape[2] - 1

    def cell(q, i, j, k, l):
        return int(H[q, i, j, k - i + S, l - j + S])

    if not affine:
        gamma, delta = costs
        terms = [(col,) + nonaffine_terms(col) for col in NONAFFINE_COLUMNS]
        i, j, k, l = n, m, n, m
        cols = []
        while True:
            here = cell(0, i, j, k, l)
            for col, ng, nd, m1, m2 in terms:
                if not pred_in_band(col, i, j, k, l, S):
                    continue
                val = (cell(0, i - col[0], j - col[1], k - col[2], l - col[3])
                       + ng * gamma + nd * delta + m1 * int(mu1[i, j])
                       + m2 * int(mu2[k, l]))
                if val == here:
                    cols.append(col)
                    i, j, k, l = i - col[0], j - col[1], k - col[2], l - col[3]
                    break
            else:
                break
        return cols[::-1], True

    beta, gamma, delta = costs
    final = [cell(q, n, m, n, m) for q in range(len(STATES))]
    best = max(final)
    intrinsic = [abs(s[0] - s[2]) + abs(s[1] - s[3]) for s in STATES]
    q = min((intrinsic[q], q) for q in range(len(STATES))
            if final[q] == best)[1]
    i, j, k, l = n, m, n, m
    net_a = net_b = 0
    first, complete = True, False
    cols = []
    while True:
        if (i, j, k, l) == (0, 0, 0, 0) and q == BOTH_MATCH and not first:
            complete = True
            break
        here = cell(q, i, j, k, l)
        pick = None
        for s, col, _g in affine_cases(q):
            if not pred_in_band(col, i, j, k, l, S):
                continue
            ng, nb, nd, m1, m2 = affine_terms(STATES[s], col)
            val = (cell(s, i - col[0], j - col[1], k - col[2], l - col[3])
                   + ng * gamma + nb * beta + nd * delta
                   + m1 * int(mu1[i, j]) + m2 * int(mu2[k, l]))
            if val != here:
                continue
            src = STATES[s]
            t_a = net_a + col[0] - col[2] + src[0] - src[2]
            t_b = net_b + col[1] - col[3] + src[1] - src[3]
            key = (abs(t_a) + abs(t_b), abs(t_b))
            if pick is None or key < pick[0]:
                pick = (key, s, col)
        if pick is None:
            break
        _key, q, col = pick
        cols.append(col)
        i, j, k, l = i - col[0], j - col[1], k - col[2], l - col[3]
        net_a += col[0] - col[2]
        net_b += col[1] - col[3]
        first = False
    return cols[::-1], complete
