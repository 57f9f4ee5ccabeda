"""Kernel warmup for serving deployments.

Counterpart of :mod:`bialign_tpu.utils.warmup`.  The port compiles nothing
per shape: its CUDA kernels are built once by ``nvcc`` into one library
(:mod:`bialign_tpu_torch._build`) and take every shape at run time.  What a
serving process pays on its first request, and can pay at startup instead,
is:

* the build of ``csrc/`` (when the library is missing or stale) and its
  load;
* the case tables of the recurrence copied to the device once per cost
  tuple (``cuda_dp._device_cases``);
* the first launch of each kernel family (the module's load on the card,
  the caching allocator's first blocks).

Usage::

    from bialign_tpu_torch.utils.warmup import prewarm
    prewarm([(932, 932)], params=dict(gap_opening_cost=-150,
             gap_cost=-50, shift_cost=-150), max_shift=1)

or from the shell::

    python -m bialign_tpu_torch.utils.warmup --lengths 932x932 512x512 \
        --max-shift 1 --gap_opening_cost -150 --gap_cost -50 \
        --shift_cost -150
"""

from __future__ import annotations

import time

import torch


def _timed(timings, log, desc, fn):
    """Run ``fn`` with the device drained before and after; record and log
    its seconds."""
    device_sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    device_sync()
    t0 = time.perf_counter()
    fn()
    device_sync()
    dt = time.perf_counter() - t0
    timings.append((desc, dt))
    if log:
        log(f"prewarmed {desc} in {dt:.2f}s")


def prewarm(lengths, *, params, max_shift: int = 2, band: bool = True,
            score_only: bool = True, traceback: bool = False,
            streaming: bool = False, streaming_batch: int = 512,
            engine: str = "cuda", device="cuda", log=None):
    """Build and load the kernels, and run each selected kernel family once
    for every pair length in ``lengths``.

    ``lengths``: iterable of (n, m) pair lengths expected in production;
    repeated lengths run once.  ``params``: dict with
    ``gap_opening_cost``, ``gap_cost``, ``shift_cost`` (non-zero gap
    opening selects the affine kernels, pyx:203-205) and
    ``structure_weight``.  ``band``/``score_only`` select the fill modes;
    ``traceback`` also runs one pair through ``BiAligner`` (fill and device
    walk); ``streaming`` also runs one ``streaming_batch``-pair chunk of the
    ``StreamingAligner`` codes path (the tables built on the device, then
    the bucket kernels).  ``engine``, ``device`` as in
    :mod:`bialign_tpu_torch.parallel.batch` (``engine="cuda"`` needs a CUDA
    device; ``"torch"`` runs the plain twins).

    Returns a list of ``(description, seconds)`` timings.
    """
    from .. import BiAligner, _build
    from ..ops import cuda_dp
    from ..parallel import batch as pbatch

    # the device with its index, as the kernels' tensors name it (the key
    # of the case tables' cache)
    device = torch.empty(0, device=pbatch._resolve(engine, device, None)) \
        .device
    cuda = engine == "cuda"
    beta = int(params.get("gap_opening_cost", 0))
    gamma = int(params.get("gap_cost", -200))
    delta = int(params.get("shift_cost", -250))
    sw = int(params.get("structure_weight", 400))
    affine = beta != 0
    ptuple = (beta, gamma, delta) if affine else (gamma, delta)
    kind = "affine" if affine else "nonaffine"

    timings: list = []
    if cuda:
        _timed(timings, log, "library build and load", _build.load)
        _timed(timings, log, f"{kind} case table on {device}",
               lambda: cuda_dp._device_cases(kind, ptuple, device))
    if affine:
        fills = {"score": (cuda_dp.affine_score, cuda_dp.affine_score_plain),
                 "band": (cuda_dp.fill_affine_device,
                          cuda_dp.fill_affine_plain)}
    else:
        fills = {"score": (cuda_dp.nonaffine_score,
                           cuda_dp.nonaffine_score_plain),
                 "band": (cuda_dp.fill_nonaffine_device,
                          cuda_dp.fill_nonaffine_plain)}
    modes = [m for m, on in (("score", score_only), ("band", band)) if on]
    for n, m in dict.fromkeys((int(n), int(m)) for n, m in lengths):
        zeros = torch.zeros((n + 1, m + 1), dtype=torch.int32, device=device)
        for mode in modes:
            fill = fills[mode][0 if cuda else 1]
            _timed(timings, log, f"{kind} {mode} n={n} m={m} ms={max_shift}",
                   lambda: fill(zeros, zeros, max_shift, *ptuple))
        if streaming:
            la, lb = max(n, 1), max(m, 1)
            pairs = [pbatch.encode_pair("A" * la, "A" * lb, "." * la,
                                        "." * lb)] * streaming_batch
            lut = torch.from_numpy(pbatch.match_mismatch_lut(100, 0)) \
                .to(device)
            _timed(timings, log,
                   f"codes batch n={n} m={m} B={streaming_batch} "
                   f"ms={max_shift}",
                   lambda: pbatch.dispatch_score_batch_codes(
                       pairs, max_shift, ptuple, affine=affine, lut=lut,
                       structure_weight=sw, engine=engine,
                       device=device).get())
        if traceback:
            def walk():
                ba = BiAligner("A" * n, "A" * m, "." * n, "." * m,
                               type="RNA", max_shift=max_shift,
                               gap_opening_cost=beta, gap_cost=gamma,
                               shift_cost=delta, engine=engine,
                               device=device)
                ba.optimize()
                ba.traceback()

            _timed(timings, log, f"traceback n={n} m={m} ms={max_shift}",
                   walk)
    return timings


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Build and warm the bialign_tpu_torch kernels for "
        "expected input lengths."
    )
    ap.add_argument("--lengths", nargs="+", required=True,
                    help="pair lengths as NxM (e.g. 932x932)")
    ap.add_argument("--max-shift", type=int, nargs="+", default=[2])
    ap.add_argument("--gap_opening_cost", type=int, default=0)
    ap.add_argument("--gap_cost", type=int, default=-200)
    ap.add_argument("--shift_cost", type=int, default=-250)
    ap.add_argument("--structure_weight", type=int, default=400)
    ap.add_argument("--traceback", action="store_true",
                    help="also run the fill and the device walk of one "
                    "pair")
    ap.add_argument("--streaming", action="store_true",
                    help="also run one StreamingAligner codes-path chunk")
    ap.add_argument("--streaming-batch", type=int, default=512)
    ap.add_argument("--engine", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    lengths = []
    for tok in ns.lengths:
        n, _, m = tok.partition("x")
        lengths.append((int(n), int(m or n)))
    params = dict(gap_opening_cost=ns.gap_opening_cost,
                  gap_cost=ns.gap_cost, shift_cost=ns.shift_cost,
                  structure_weight=ns.structure_weight)
    total = 0.0
    for S in ns.max_shift:
        for desc, dt in prewarm(lengths, params=params, max_shift=S,
                                traceback=ns.traceback,
                                streaming=ns.streaming,
                                streaming_batch=ns.streaming_batch,
                                engine=ns.engine, device=ns.device,
                                log=print):
            total += dt
    print(f"prewarm total {total:.2f}s")


if __name__ == "__main__":
    main()
