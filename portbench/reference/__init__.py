"""The benchmark's plain reference: tables, band fill, walk and decode of
BiAlign in numpy and plain PyTorch, written from upstream's definition.  It
imports nothing of the program under test and takes nothing the program
made."""

from __future__ import annotations

import torch

from . import decode, dp, tables


def costs_of(params):
    """(beta, gamma, delta) when the parameters select the affine
    recurrence (gap_opening_cost != 0), else (gamma, delta)."""
    beta = int(params["gap_opening_cost"])
    gamma, delta = int(params["gap_cost"]), int(params["shift_cost"])
    return (beta, gamma, delta) if beta else (gamma, delta)


def align(records, params, *, traces, device="cpu", dtype=torch.int64):
    """Reference answers for records (seqA, seqB, strA, strB), all in one
    batched fill: a list of dicts with ``score`` and, when ``traces``,
    ``trace`` and ``complete``; also ``tables`` (mu1, mu2)."""
    S = int(params["max_shift"])
    costs = costs_of(params)
    affine = len(costs) == 3
    tabs = [tables.tables(r, params) for r in records]
    scores, bands = dp.run(tabs, S, costs, affine=affine, store=traces,
                           device=device, dtype=dtype)
    out = []
    for pos, (score, tab) in enumerate(zip(scores, tabs)):
        ans = {"score": score, "tables": tab}
        if traces:
            ans["trace"], ans["complete"] = dp.walk(
                bands[pos], tab[0], tab[1], S, costs, affine=affine)
            bands[pos] = None
        out.append(ans)
    return out
