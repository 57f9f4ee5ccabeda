"""Batched bi-alignment scoring.

Counterpart of the tables-input scores path of
:mod:`bialign_tpu.parallel.batch`: data parallelism over independent pairs.

Pipeline:
  1. pairs are bucketed by padded length (multiples of ``bucket_quantum``);
  2. each bucket's dense int32 score tables are zero-padded to the bucket
     shape and stacked ``[B, N+1, M+1]`` on the host, and copied to the
     device from pinned memory;
  3. one call per bucket scores all its pairs
     (:func:`bialign_tpu_torch.ops.cuda_dp.affine_batch_scores`,
     ``nonaffine_batch_scores``); per-pair true lengths ride along as data,
     so padding never changes scores (tests/test_torch_batch.py);
  4. the scores of all buckets come back in one copy, in input order.

``engine="cuda"`` runs the CUDA kernels and needs a CUDA device;
``engine="torch"`` runs their plain PyTorch twins on any device.  Neither
gives way to the other.  Not ported yet: a device mesh (``mesh=``), the
batched alignments and the codes-input path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cuda_dp

ENGINES = ("cuda", "torch")


def quantize(x: int, q: int) -> int:
    return ((max(x, 1) + q - 1) // q) * q


def pad_table(mu: np.ndarray, N: int, M: int) -> np.ndarray:
    """Zero-pad a (n+1, m+1) score table to (N+1, M+1).

    Padded entries are only read by cells outside the genuine region
    (i > n or j > m), which never feed genuine cells (the recurrence is
    monotone in (i, j)), so the pad value cannot change any score.
    """
    out = np.zeros((N + 1, M + 1), dtype=np.int32)
    out[: mu.shape[0], : mu.shape[1]] = mu
    return out


@dataclass
class Bucket:
    """One padded shape bucket of pairs awaiting scoring."""

    N: int
    M: int
    indices: list = field(default_factory=list)   # position in user order
    mu1d: list = field(default_factory=list)
    mu2d: list = field(default_factory=list)
    n: list = field(default_factory=list)
    m: list = field(default_factory=list)


def make_buckets_dense(tables, bucket_quantum: int = 64):
    """Group pairs into buckets of dense raw tables, keyed by (N, M).

    Tables are kept raw here; :func:`stack_padded` pads each bucket's
    stack to the bucket-exact [B, N+1, M+1] in one vectorized write
    (the all-same-shape serving case skips per-pair padding entirely).
    """
    buckets: dict = {}
    for idx, (mu1, mu2) in enumerate(tables):
        n = mu1.shape[0] - 1
        m = mu1.shape[1] - 1
        N = quantize(n, bucket_quantum)
        M = quantize(m, bucket_quantum)
        b = buckets.setdefault((N, M), Bucket(N, M))
        b.mu1d.append(np.asarray(mu1))
        b.mu2d.append(np.asarray(mu2))
        b.indices.append(idx)
        b.n.append(n)
        b.m.append(m)
    return buckets


def stack_padded(raws, N: int, M: int, pad_count: int = 0) -> np.ndarray:
    """Stack raw (n+1, m+1) tables into one [B, N+1, M+1] int32 array
    (+ ``pad_count`` repeats of the last table for batch-axis padding).

    Single-shape fast path: one stack + one block write, so the
    steady-state serving case where every pair in a bucket has the same
    length pays no per-pair padding loop.
    """
    raws = list(raws) + [raws[-1]] * pad_count
    shapes = {a.shape for a in raws}
    out = np.zeros((len(raws), N + 1, M + 1), dtype=np.int32)
    if len(shapes) == 1:
        (n1, m1), = shapes
        out[:, :n1, :m1] = np.stack(raws)
        return out
    for i, a in enumerate(raws):
        out[i, : a.shape[0], : a.shape[1]] = a
    return out


def _require_int32_safe(tables, params, affine: bool):
    """Entry-level int32-overflow guard for the batched engines.

    The batched kernels compute in int32 with a -2^30 sentinel and have no
    int64 twin, so an unsafe pair must fail loudly, not silently wrap.
    Checked on the ORIGINAL tables before any int32 cast (the
    bucket-padding cast would wrap first and hide the magnitude), per-pair
    form of ops/cases.int32_value_bound.
    """
    if affine:
        beta, gamma, delta = params
    else:
        beta = 0
        gamma, delta = params
    for idx, (mu1, mu2) in enumerate(tables):
        amax = max(int(np.abs(mu1).max(initial=0)),
                   int(np.abs(mu2).max(initial=0)))
        n = mu1.shape[0] - 1
        m = mu1.shape[1] - 1
        per_col = (2 * abs(int(gamma)) + 2 * abs(int(beta))
                   + 2 * abs(int(delta)) + 2 * amax)
        bound = 2 * (n + m + 2) * per_col
        if not ((-(1 << 30)) - bound > np.iinfo(np.int32).min
                + (1 << 20)):
            raise ValueError(
                "scoring parameters/tables exceed the certified int32 "
                f"range for pair {idx} (value drift bound {bound}); the "
                "batched engines have no int64 path, and the single-pair "
                "int64 engine is not ported yet (ROADMAP.md Queue 1 P2)"
            )


def _resolve(engine: str, device, mesh) -> torch.device:
    """Check the engine, the device and the mesh of a call; the device."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (a batch sharded over several devices) is not ported "
            "yet: ROADMAP.md Queue 1 P15")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    device = torch.device(device)
    if engine == "cuda" and (device.type != "cuda"
                             or not torch.cuda.is_available()):
        raise RuntimeError(
            f"engine='cuda' needs a CUDA device, got device={str(device)!r} "
            f"(CUDA available: {torch.cuda.is_available()}); "
            "engine='torch' runs the plain PyTorch twins on any device")
    return device


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a CUDA device from pinned memory,
    without waiting for the copy."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _device_buckets(tables, bucket_quantum: int, device: torch.device):
    """[(indices, (mu1p, mu2p, ns, ms) on ``device``, d_max)] per bucket;
    d_max is the bucket's largest n + m, its last diagonal."""
    out = []
    for (N, M), b in make_buckets_dense(tables, bucket_quantum).items():
        stacks = (stack_padded(b.mu1d, N, M), stack_padded(b.mu2d, N, M),
                  np.asarray(b.n, dtype=np.int32),
                  np.asarray(b.m, dtype=np.int32))
        out.append((b.indices, tuple(_to_device(x, device) for x in stacks),
                    max(n + m for n, m in zip(b.n, b.m))))
    return out


def _bucket_scores(stacks, d_max: int, max_shift: int, params, affine: bool,
                   engine: str) -> torch.Tensor:
    """Queue one bucket's scores on its device; ``[B]`` int32, not waited
    for."""
    if engine == "cuda":
        fn = (cuda_dp.affine_batch_scores if affine
              else cuda_dp.nonaffine_batch_scores)
        return fn(*stacks, max_shift, *params, d_max=d_max)
    fn = (cuda_dp.affine_batch_scores_plain if affine
          else cuda_dp.nonaffine_batch_scores_plain)
    return fn(*stacks, max_shift, *params)


class PendingScores:
    """Dispatched-but-unharvested batched scores.

    Kernel launches and copies are asynchronous: the kernels are already
    running (or queued) on the device when this object is returned, so the
    caller can overlap host work (preprocessing and packing the next chunk)
    with device compute.  :meth:`get` waits for them and assembles the
    scores in input order.
    """

    def __init__(self, n_pairs: int, parts):
        self._n = n_pairs
        self._parts = parts          # [(indices, device_scores)]

    @property
    def n_dispatches(self) -> int:
        """Kernel dispatches made (one per length bucket)."""
        return len(self._parts)

    def get(self) -> np.ndarray:
        out = np.zeros(self._n, dtype=np.int64)
        if not self._parts:
            return out
        # one copy over all buckets: each copy back is a round trip that
        # waits for the device
        fetched = torch.cat([dev for _, dev in self._parts]).cpu().numpy()
        order = np.concatenate([np.asarray(indices, dtype=np.int64)
                                for indices, _ in self._parts])
        out[order] = fetched
        return out


def dispatch_score_batch(tables, max_shift: int, params, *, affine: bool,
                         mesh=None, bucket_quantum: int = 64,
                         engine: str = "cuda",
                         device="cuda") -> PendingScores:
    """Pack and LAUNCH every bucket's score kernel without blocking.

    Same arguments/semantics as :func:`score_batch`; returns a
    :class:`PendingScores` instead of the assembled array.
    """
    device = _resolve(engine, device, mesh)
    tables = list(tables)
    _require_int32_safe(tables, params, affine)
    parts = [
        (indices, _bucket_scores(stacks, d_max, max_shift, tuple(params),
                                 affine, engine))
        for indices, stacks, d_max in _device_buckets(tables, bucket_quantum,
                                                      device)
    ]
    return PendingScores(len(tables), parts)


def score_batch(tables, max_shift: int, params, *, affine: bool, mesh=None,
                bucket_quantum: int | None = None, engine: str = "cuda",
                device="cuda"):
    """Score a batch of pairs; returns int64 scores in input order.

    ``tables``: (mu1, mu2) int arrays of shape (n+1, m+1) per pair.
    ``params``: (beta, gamma, delta) for affine, (gamma, delta) otherwise.
    ``engine``: "cuda" (the CUDA kernels, on a CUDA ``device``) or "torch"
    (their plain PyTorch twins, on any device).  ``mesh`` is not ported.

    ``tables`` may also be a :class:`PreparedBatch` (device-resident
    buckets built once): scoring then skips the bucket rebuild and the
    host->device transfer entirely (steady-state serving path).
    """
    if isinstance(tables, PreparedBatch):
        tables.check_compatible(max_shift, params, affine, mesh,
                                engine=engine, device=device,
                                bucket_quantum=bucket_quantum)
        return tables.scores()

    if bucket_quantum is None:
        bucket_quantum = 64
    return dispatch_score_batch(
        tables, max_shift, params, affine=affine, mesh=mesh,
        bucket_quantum=bucket_quantum, engine=engine, device=device,
    ).get()


class PreparedBatch:
    """Device-resident buckets built once, scored many times.

    ``score_batch`` rebuilds buckets and re-transfers every table per
    call: right for one-shot streams, wasteful for steady-state serving
    where the same corpus (or the same shapes) is scored repeatedly.
    ``PreparedBatch`` does the host-side packing and the host->device
    transfer once; :meth:`scores` then runs only the kernels.

    Accepted by :func:`score_batch` in place of ``tables``.
    """

    def __init__(self, tables, max_shift: int, params, *, affine: bool,
                 mesh=None, bucket_quantum: int = 64, engine: str = "cuda",
                 device="cuda"):
        self.device = _resolve(engine, device, mesh)
        tables = list(tables)
        _require_int32_safe(tables, params, affine)
        self.max_shift = max_shift
        self.params = tuple(params)
        self.affine = affine
        self.mesh = mesh
        self.bucket_quantum = bucket_quantum
        self.engine = engine
        self.n_pairs = len(tables)
        self._buckets = _device_buckets(tables, bucket_quantum, self.device)

    def check_compatible(self, max_shift: int, params, affine: bool,
                         mesh, *, engine: str = "cuda", device="cuda",
                         bucket_quantum: int | None = None) -> None:
        """Fail loudly if a score_batch call's arguments differ from
        what this batch was prepared with: the prepared device arrays
        bake in those choices, so silently returning stale-parameter
        scores would be wrong results, not a cache hit.  The same
        strictness applies to ``engine`` and ``device`` (the prepared
        buckets run the engine and lie on the device they were built for)
        and to an explicit ``bucket_quantum`` that differs from the one the
        buckets were built with."""
        got = (max_shift, tuple(params), affine, mesh)
        have = (self.max_shift, self.params, self.affine, self.mesh)
        if got != have:
            raise ValueError(
                "PreparedBatch was built with (max_shift, params, "
                f"affine, mesh)={have} but score_batch was called with "
                f"{got}; rebuild the PreparedBatch for the new settings"
            )
        if (engine != self.engine
                or torch.device(device).type != self.device.type):
            raise ValueError(
                f"engine={engine!r}, device={str(device)!r} conflicts with "
                f"a PreparedBatch: its device buckets run engine="
                f"{self.engine!r} on {self.device}; pass the raw tables to "
                "score_batch for another engine or device"
            )
        if bucket_quantum is not None and \
                bucket_quantum != self.bucket_quantum:
            raise ValueError(
                f"bucket_quantum={bucket_quantum} conflicts with the "
                f"PreparedBatch (built with {self.bucket_quantum}); "
                "rebuild it to re-bucket"
            )

    def dispatch(self) -> PendingScores:
        """Queue every bucket's kernels; nothing is copied or waited for."""
        parts = [
            (indices, _bucket_scores(stacks, d_max, self.max_shift,
                                     self.params, self.affine, self.engine))
            for indices, stacks, d_max in self._buckets
        ]
        return PendingScores(self.n_pairs, parts)

    def scores(self) -> np.ndarray:
        """Score every pair; returns int64 scores in the original input
        order.  Only kernel dispatches and the scores' one copy back: no
        bucket rebuild, no transfer of tables."""
        return self.dispatch().get()
