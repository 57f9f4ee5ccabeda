"""Batched bi-alignment scores and alignments.

Counterpart of :mod:`bialign_tpu.parallel.batch`: data parallelism over
independent pairs, from score tables or from residue and structure codes.

Scores, from tables:
  1. pairs are bucketed by padded length (multiples of ``bucket_quantum``);
  2. each bucket's dense int32 score tables are zero-padded to the bucket
     shape and stacked ``[B, N+1, M+1]`` on the host, and copied to the
     device from pinned memory;
  3. one call per bucket scores all its pairs
     (:func:`bialign_tpu_torch.ops.cuda_dp.affine_batch_scores`,
     ``nonaffine_batch_scores``); per-pair true lengths ride along as data,
     so padding never changes scores (tests/test_torch_batch.py);
  4. the scores of all buckets come back in one copy, in input order.

Alignments (:func:`align_batch`): each bucket is cut into chunks whose band
fits a memory budget (:func:`_auto_chunk`); per chunk the band-emitting fill
(``affine_batch_bands`` / ``nonaffine_batch_bands``) and the walk of every
pair (:mod:`bialign_tpu_torch.ops.device_traceback`) are queued on the
device, and only the walks' outputs, O(n+m) codes a pair, are kept: no band
crosses to the host.  All chunks come back in one copy and are decoded on
the host.

From codes (``dispatch_score_batch_codes``, ``dispatch_align_batch_codes``;
protein scoring only): each pair ships its four code vectors, about n + m
bytes each, and the tables are built on the device from a 256 x 256 table
(:func:`bialign_tpu_torch.ops.cuda_dp.mu_planes_from_codes`).

``engine="cuda"`` runs the CUDA kernels and needs a CUDA device;
``engine="torch"`` runs their plain PyTorch twins on any device.  Neither
gives way to the other.

``mesh=`` (a :class:`~bialign_tpu_torch.parallel.mesh.Mesh`; ``device`` is
then not used) shards every bucket over the devices of its axis ``"data"``:
the bucket's pairs are dealt out in contiguous shards, as even as they
divide, one a device (a shard of no pair is skipped, so a mesh larger than
a bucket is legal).  Each shard is uploaded, filled and walked on its
device, on a stream of its own, by the same kernels and routes as one
device's bucket; scores, traces and flags come back in input order.  Pairs
never talk to each other, so no collective is needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import cuda_dp
from ..ops import device_traceback as dtb
from ..ops.cases import N_STATES
from .mesh import joined, mesh_devices, shard_stream, split, using

ENGINES = ("cuda", "torch")

# Device memory one chunk's band may take, in bytes: a fifth of the 80 GB of
# an NVIDIA H100 80GB HBM3.  Every chunk of a bucket pays the bucket's whole
# sequence of launches again, so a chunk should be as large as memory
# allows: with this budget a bucket of 28 pairs of 512 x 512 at max_shift 1
# (affine, 4.8 GB) is one chunk, and a 4000 x 4000 pair (10.4 GB) fits.
BAND_BUDGET = 16 << 30


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
                "batched engines have no int64 path: align such a pair "
                "alone with BiAligner, which runs the int64 engine"
            )


def _resolve(engine: str, device, mesh) -> list:
    """Check the engine and the devices of a call: ``[device]``, or the
    devices of ``mesh``'s axis "data", each held to the engine as a single
    device is; returns them."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    devices = ([torch.device(device)] if mesh is None
               else [torch.device(d) for d in mesh_devices(mesh, "data")])
    for dev in devices:
        if engine == "cuda" and (dev.type != "cuda"
                                 or not torch.cuda.is_available()):
            raise RuntimeError(
                f"engine='cuda' needs a CUDA device, got device="
                f"{str(dev)!r} (CUDA available: "
                f"{torch.cuda.is_available()}); engine='torch' runs the "
                "plain PyTorch twins on any device")
    return devices


def _places(devices, mesh) -> list:
    """(device, stream) of each shard of a call: one device's current
    stream (None) without a mesh, else a stream a shard on a CUDA device."""
    if mesh is None:
        return [(devices[0], None)]
    return [(dev, shard_stream(dev)) for dev in devices]


def _shards_of(b: "Bucket", places) -> list:
    """(rows, device, stream) of each shard of a bucket: its pairs dealt
    out in contiguous slices, as even as they divide; empty ones left
    out."""
    return [(slice(lo, hi), dev, stream) for (dev, stream), (lo, hi)
            in zip(places, split(len(b.indices), len(places))) if hi > lo]


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a CUDA device from pinned memory,
    without waiting for the copy."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _last_diagonal(b: Bucket, rows: slice = slice(None)) -> int:
    """The largest n + m of a bucket's pairs ``rows``."""
    return max(n + m for n, m in zip(b.n[rows], b.m[rows]))


def _upload_tables(b: Bucket, device: torch.device,
                   rows: slice = slice(None)) -> tuple:
    """(mu1p, mu2p, ns, ms) of the pairs ``rows`` of a bucket of tables on
    ``device``."""
    stacks = (stack_padded(b.mu1d[rows], b.N, b.M),
              stack_padded(b.mu2d[rows], b.N, b.M),
              np.asarray(b.n[rows], dtype=np.int32),
              np.asarray(b.m[rows], dtype=np.int32))
    return tuple(_to_device(x, device) for x in stacks)


def _device_buckets(tables, bucket_quantum: int, device: torch.device):
    """[(indices, (mu1p, mu2p, ns, ms) on ``device``, d_max)] per bucket
    of one device."""
    return [(indices, stacks, d_max) for indices, stacks, d_max, _place
            in _shard_buckets(tables, bucket_quantum, [(device, None)])]


def _shard_buckets(tables, bucket_quantum: int, places) -> list:
    """[(indices, (mu1p, mu2p, ns, ms), d_max, (device, stream))] per shard
    of each bucket, uploaded on its stream; d_max is the shard's largest
    n + m, its last diagonal.  Queue under ``joined(places)``."""
    out = []
    for b in make_buckets_dense(tables, bucket_quantum).values():
        for rows, dev, stream in _shards_of(b, places):
            with using(stream):
                out.append((b.indices[rows], _upload_tables(b, dev, rows),
                            _last_diagonal(b, rows), (dev, stream)))
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
        # waits for the device (the shards of a mesh gathered on the first
        # one's device first)
        first = self._parts[0][1].device
        fetched = torch.cat([dev.to(first) for _, dev in self._parts]) \
            .cpu().numpy()
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
    places = _places(_resolve(engine, device, mesh), mesh)
    tables = list(tables)
    _require_int32_safe(tables, params, affine)
    with joined(places):
        parts = _dispatch_scores(
            _shard_buckets(tables, bucket_quantum, places), max_shift,
            tuple(params), affine, engine)
    return PendingScores(len(tables), parts)


def _dispatch_scores(buckets, max_shift, params, affine, engine) -> list:
    """Queue the scores of every shard of ``_shard_buckets`` on its
    stream; [(indices, device scores)]."""
    parts = []
    for indices, stacks, d_max, (_dev, stream) in buckets:
        with using(stream):
            parts.append((indices, _bucket_scores(
                stacks, d_max, max_shift, params, affine, engine)))
    return parts


def score_batch(tables, max_shift: int, params, *, affine: bool, mesh=None,
                bucket_quantum: int | None = None, engine: str = "cuda",
                device="cuda"):
    """Score a batch of pairs; returns int64 scores in input order.

    ``tables``: (mu1, mu2) int arrays of shape (n+1, m+1) per pair.
    ``params``: (beta, gamma, delta) for affine, (gamma, delta) otherwise.
    ``engine``: "cuda" (the CUDA kernels, on a CUDA ``device``) or "torch"
    (their plain PyTorch twins, on any device).  ``mesh``: a
    :class:`~bialign_tpu_torch.parallel.mesh.Mesh` whose axis "data" the
    buckets are sharded over, in place of ``device``.

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


# -- batched alignments -------------------------------------------------------
#
# One fill and one walk per chunk of a bucket, both on the device: the host
# receives per-pair trace codes (O(n+m) ints each), never a band.

def _fill_walk(stacks, d_max: int, max_shift: int, params, affine: bool,
               engine: str) -> torch.Tensor:
    """Queue one chunk's band-emitting fill and the walk of each of its
    pairs; the walks' output ``[B, 3 + Lmax]``, not waited for.  The band
    is dropped here: the walk is queued behind the fill on the same stream,
    and the caching allocator hands the block to the next chunk in stream
    order."""
    mu1p, mu2p = stacks[:2]
    if engine == "cuda":
        fill = (cuda_dp.affine_batch_bands if affine
                else cuda_dp.nonaffine_batch_bands)
        walk = dtb.affine_walk_batch if affine else dtb.nonaffine_walk_batch
    else:
        fill = (cuda_dp.affine_batch_bands_plain if affine
                else cuda_dp.nonaffine_batch_bands_plain)
        walk = (dtb.affine_walk_batch_plain if affine
                else dtb.nonaffine_walk_batch_plain)
    bband, _scores = fill(*stacks, max_shift, *params, d_max=d_max)
    return walk(bband, *params, mu1p, mu2p)


class PendingAlignments:
    """Dispatched-but-unharvested fill-and-walk chunks (the alignments twin
    of :class:`PendingScores`); :meth:`get` waits, decodes the walks' codes
    on the host and assembles (scores, traces, complete)."""

    def __init__(self, n_pairs: int, parts):
        self._n = n_pairs
        self._parts = parts          # [(indices, affine, device_walks)]

    @property
    def n_dispatches(self) -> int:
        """Fill-and-walk dispatches issued (one per chunk of a bucket)."""
        return len(self._parts)

    def get(self):
        scores = np.zeros(self._n, dtype=np.int64)
        traces: list = [None] * self._n
        complete = [True] * self._n
        if not self._parts:
            return scores, traces, complete
        # one copy back for all chunks (see PendingScores.get)
        first = self._parts[0][2].device
        flat = torch.cat([dev.reshape(-1).to(first)
                          for _, _, dev in self._parts]).cpu().numpy()
        at = 0
        for idxs, affine, dev in self._parts:
            walks = dtb.unpack_walks(
                flat[at:at + dev.numel()].reshape(dev.shape))
            at += dev.numel()
            for idx, (codes, done, score) in zip(idxs, walks):
                traces[idx] = dtb.decode_codes(codes)
                scores[idx] = score
                # a non-affine walk has no such flag: it always completes
                if affine:
                    complete[idx] = done == 1
        return scores, traces, complete


def _auto_chunk(N: int, M: int, max_shift: int, affine: bool,
                budget: int | None = None) -> int:
    """Pairs per fill-and-walk dispatch, sized so that one chunk's band
    ``[B, N+M+1, (9,) W, W, N+1]`` int32 stays under ``budget`` bytes
    (default :data:`BAND_BUDGET`), at least one pair.  A launch takes the
    same time whatever the number of pairs under it, so every further chunk
    of a bucket costs the bucket's whole sequence of launches again: chunks
    should be as large as the band memory allows."""
    if budget is None:
        budget = BAND_BUDGET
    W2 = (2 * max_shift + 1) ** 2
    per_pair = (N + M + 1) * (N_STATES if affine else 1) * W2 * (N + 1) * 4
    return max(1, min(1024, budget // per_pair))


def _dispatch_chunks(buckets, upload, planes, places, max_shift, params,
                     affine, chunk, engine) -> list:
    """Queue the fill and walk of every chunk of every shard of every
    bucket, each shard on its device and stream (``places``), chunked
    there.  ``buckets``: {(N, M): Bucket}; ``upload(bucket, device, rows)``
    puts the inputs of a bucket's pairs ``rows`` on the device once;
    ``planes(inputs, rows, device)`` gives the stacks (mu1p, mu2p, ns, ms)
    of the chunk ``rows`` of them."""
    parts = []
    with joined(places):
        for (N, M), b in buckets.items():
            bchunk = (_auto_chunk(N, M, max_shift, affine) if chunk is None
                      else chunk)
            for rows, dev, stream in _shards_of(b, places):
                with using(stream):
                    inputs = upload(b, dev, rows)
                    for lo in range(rows.start, rows.stop, bchunk):
                        hi = min(lo + bchunk, rows.stop)
                        here = slice(lo - rows.start, hi - rows.start)
                        out = _fill_walk(planes(inputs, here, dev),
                                         _last_diagonal(b, slice(lo, hi)),
                                         max_shift, params, affine, engine)
                        parts.append((b.indices[lo:hi], affine, out))
    return parts


def dispatch_align_batch(tables, max_shift: int, params, *, affine: bool,
                         mesh=None, bucket_quantum: int = 64,
                         chunk: int | None = None, engine: str = "cuda",
                         device="cuda") -> PendingAlignments:
    """Pack and LAUNCH every chunk's fill and walk without blocking (same
    arguments as :func:`align_batch`); chunks queue on the device in
    dispatch order, so peak band memory stays one chunk's worth while the
    caller overlaps host packing of the next batch.  ``chunk=None`` sizes
    chunks per bucket from the band-memory budget (:func:`_auto_chunk`)."""
    places = _places(_resolve(engine, device, mesh), mesh)
    tables = list(tables)
    _require_int32_safe(tables, params, affine)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    parts = _dispatch_chunks(
        make_buckets_dense(tables, bucket_quantum), _upload_tables,
        lambda stacks, rows, _dev: tuple(t[rows] for t in stacks), places,
        max_shift, tuple(params), affine, chunk, engine)
    return PendingAlignments(len(tables), parts)


def align_batch(tables, max_shift: int, params, *, affine: bool, mesh=None,
                bucket_quantum: int = 64, chunk: int | None = None,
                engine: str = "cuda", device="cuda"):
    """Traces + scores for a batch of pairs, in input order.

    Returns ``(scores, traces, complete)``: int64 scores, per-pair forward
    trace lists (the (a, b, c, d) tuples of
    :meth:`bialign_tpu_torch.BiAligner.traceback`, with the reference's
    tie-breaks between co-optimal paths), and per-pair completeness flags
    (False = the reference's incomplete-traceback warning case; non-affine
    walks always complete).

    ``chunk`` caps the pairs per dispatch: a chunk's band lives in device
    memory (B * D * 9 * W^2 * (N+1) int32), so chunking bounds peak memory;
    with a mesh, each device's shard of a bucket is chunked on its own.
    ``engine``, ``device``, ``mesh`` as in :func:`score_batch`.
    """
    return dispatch_align_batch(
        tables, max_shift, params, affine=affine, mesh=mesh,
        bucket_quantum=bucket_quantum, chunk=chunk, engine=engine,
        device=device,
    ).get()


# -- codes-input serving path (tables built on the device) ---------------------
#
# The tables-input paths ship O(n*m) ints per pair to the device; the raw
# inputs are O(n) bytes.  Here each pair ships its code vectors, one
# 256 x 256 table stays on the device, and the mu tables are built there
# (ops/cuda_dp.mu_planes_from_codes).  Protein scoring only: RNA mu2 keeps
# host float64 (scoring/tables.py).

def encode_pair(seqA: str, seqB: str, strA: str, strB: str):
    """1-based uint8 code vectors (index 0 unused = 0) for the device-table
    scoring path.  A residue outside latin-1 has no code and raises
    ``KeyError``, as a residue outside the similarity matrix does on the
    tables path."""
    def enc(s):
        a = np.zeros(len(s) + 1, dtype=np.uint8)
        try:
            a[1:] = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
        except UnicodeEncodeError as e:
            raise KeyError(s[e.start]) from None
        return a

    return enc(seqA), enc(seqB), enc(strA), enc(strB)


def match_mismatch_lut(match: int, mismatch: int) -> np.ndarray:
    """256x256 LUT equivalent of the match/mismatch mu1 (tables.py
    sequence_similarity_table without a simmatrix)."""
    lut = np.full((256, 256), int(mismatch), dtype=np.int32)
    np.fill_diagonal(lut, int(match))
    return lut


def _lut_peak(lut) -> int:
    """Largest magnitude in ``lut``.  For a table on the device it is read
    once (one wait for the device) and kept on the tensor, so that later
    dispatches with the same table do not wait."""
    if not isinstance(lut, torch.Tensor):
        return int(np.abs(np.asarray(lut)).max())
    kept = getattr(lut, "_bialign_peak", None)
    if kept is None or kept[0] != lut._version:
        kept = (lut._version, int(lut.abs().max()))
        lut._bialign_peak = kept
    return kept[1]


def _require_int32_safe_codes(lut, sw, buckets, params, affine):
    """Codes-path twin of :func:`_require_int32_safe`: the mu magnitude
    bound comes from the LUT and structure weight instead of per-pair
    tables.  (The table is applied by indexing, so its entries need only
    pass this bound: there is no 2^24 limit as in the JAX package.)"""
    amax = max(_lut_peak(lut), abs(int(sw)))
    if affine:
        beta, gamma, delta = params
    else:
        beta = 0
        gamma, delta = params
    per_col = (2 * abs(int(gamma)) + 2 * abs(int(beta))
               + 2 * abs(int(delta)) + 2 * amax)
    worst = max((N + M for (N, M) in buckets), default=0)
    bound = 2 * (worst + 2) * per_col
    if not ((-(1 << 30)) - bound > np.iinfo(np.int32).min + (1 << 20)):
        raise ValueError(
            "scoring parameters/LUT exceed the certified int32 range "
            f"(value drift bound {bound}); the batched engines have no "
            "int64 path: align such a pair alone with BiAligner, which "
            "runs the int64 engine"
        )


def _code_buckets(pairs, bucket_quantum: int):
    """Bucket (ca, cb, sa, sb) code-vector pairs by quantized shape:
    {(N, M): Bucket} whose ``mu1d`` holds the bucket's four zero-padded
    uint8 stacks (ca, cb, sa, sb), ca/sa ``[B, N+1]`` and cb/sb
    ``[B, M+1]``.  No row or batch padding beyond the bucket's own."""
    buckets: dict = {}
    for idx, (ca, cb, sa, sb) in enumerate(pairs):
        n = len(ca) - 1
        m = len(cb) - 1
        if len(sa) != n + 1 or len(sb) != m + 1:
            raise ValueError(f"pair {idx}: sequence codes of lengths "
                             f"({n}, {m}), structure codes of "
                             f"({len(sa) - 1}, {len(sb) - 1})")
        N = quantize(n, bucket_quantum)
        M = quantize(m, bucket_quantum)
        b = buckets.setdefault((N, M), Bucket(N, M))
        b.indices.append(idx)
        b.mu2d.append((ca, cb, sa, sb))
        b.n.append(n)
        b.m.append(m)
    for (N, M), b in buckets.items():
        B = len(b.indices)
        stacks = [np.zeros((B, width), dtype=np.uint8)
                  for width in (N + 1, M + 1, N + 1, M + 1)]
        for pos, codes in enumerate(b.mu2d):
            for stack, vec in zip(stacks, codes):
                stack[pos, : len(vec)] = vec
        b.mu1d, b.mu2d = stacks, []
    return buckets


def _upload_codes(b: Bucket, device: torch.device,
                  rows: slice = slice(None)) -> tuple:
    """(ca, cb, sa, sb, ns, ms) of the pairs ``rows`` of a bucket of codes
    on ``device``."""
    arrays = (*(stack[rows] for stack in b.mu1d),
              np.asarray(b.n[rows], dtype=np.int32),
              np.asarray(b.m[rows], dtype=np.int32))
    return tuple(_to_device(x, device) for x in arrays)


def _device_lut(lut, device: torch.device, devices=()) -> torch.Tensor:
    """The 256 x 256 table on ``device``: a tensor there is used as it is
    (no copy), a host array goes up; a tensor on another of the call's
    ``devices`` (a mesh) is copied there."""
    if isinstance(lut, torch.Tensor):
        if lut.device != device and (lut.device.type != device.type
                                     or device.index is not None):
            if lut.device not in devices:
                raise ValueError(f"lut lies on {lut.device}, the batch runs "
                                 f"on {device}")
            return lut.to(device)
        return lut
    host = np.asarray(lut)
    if host.shape != (256, 256) or not np.issubdtype(host.dtype, np.integer):
        raise ValueError(f"lut must be an integer [256, 256] array, got "
                         f"{host.dtype} {host.shape}")
    return _to_device(np.ascontiguousarray(host, dtype=np.int32), device)


def _codes_setup(pairs, max_shift, params, affine, lut, structure_weight,
                 mesh, bucket_quantum, engine, device):
    """What both codes dispatchers start with: (pairs, buckets, planes,
    places); ``planes(codes, rows, device)`` builds the stacks of the chunk
    ``rows`` of a bucket's uploaded codes on ``device``, the table put
    there once."""
    devices = _resolve(engine, device, mesh)
    pairs = list(pairs)
    buckets = _code_buckets(pairs, bucket_quantum)
    _require_int32_safe_codes(lut, structure_weight, buckets, params, affine)
    # the table on each device once a call
    luts = {dev: _device_lut(lut, dev, devices) for dev in devices}
    sw = int(structure_weight)

    def planes(codes, rows, dev):
        ca, cb, sa, sb, ns, ms = (t[rows] for t in codes)
        mu1p, mu2p = cuda_dp.mu_planes_from_codes(luts[dev], ca, cb, sa, sb,
                                                  ns, ms, sw)
        return mu1p, mu2p, ns, ms

    return pairs, buckets, planes, _places(devices, mesh)


def dispatch_score_batch_codes(pairs, max_shift: int, params, *,
                               affine: bool, lut, structure_weight: int,
                               mesh=None, bucket_quantum: int = 64,
                               engine: str = "cuda",
                               device="cuda") -> PendingScores:
    """Launch batched scoring from code vectors (see the section's note).
    ``pairs``: list of :func:`encode_pair` tuples; ``lut``: a [256, 256]
    int32 table, a tensor on ``device`` (used as it is: keep it there across
    calls) or a host array (copied up on every call).  Then the route of
    :func:`score_batch`."""
    pairs, buckets, planes, places = _codes_setup(
        pairs, max_shift, params, affine, lut, structure_weight, mesh,
        bucket_quantum, engine, device)
    parts = []
    with joined(places):
        for b in buckets.values():
            for rows, dev, stream in _shards_of(b, places):
                with using(stream):
                    stacks = planes(_upload_codes(b, dev, rows), slice(None),
                                    dev)
                    parts.append((b.indices[rows], _bucket_scores(
                        stacks, _last_diagonal(b, rows), max_shift,
                        tuple(params), affine, engine)))
    return PendingScores(len(pairs), parts)


def dispatch_align_batch_codes(pairs, max_shift: int, params, *,
                               affine: bool, lut, structure_weight: int,
                               mesh=None, bucket_quantum: int = 64,
                               chunk: int | None = None,
                               engine: str = "cuda",
                               device="cuda") -> PendingAlignments:
    """Codes-input twin of :func:`dispatch_align_batch`: a chunk's tables
    are built on the device just before its fill."""
    pairs, buckets, planes, places = _codes_setup(
        pairs, max_shift, params, affine, lut, structure_weight, mesh,
        bucket_quantum, engine, device)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    parts = _dispatch_chunks(buckets, _upload_codes, planes, places,
                             max_shift, tuple(params), affine, chunk, engine)
    return PendingAlignments(len(pairs), parts)


class PreparedBatch:
    """Device-resident buckets built once, scored many times.

    ``score_batch`` rebuilds buckets and re-transfers every table per
    call: right for one-shot streams, wasteful for steady-state serving
    where the same corpus (or the same shapes) is scored repeatedly.
    ``PreparedBatch`` does the host-side packing and the host->device
    transfer once; :meth:`scores` then runs only the kernels.

    Accepted by :func:`score_batch` in place of ``tables``.  With a
    ``mesh``, each bucket's shards stay resident on their devices.
    """

    def __init__(self, tables, max_shift: int, params, *, affine: bool,
                 mesh=None, bucket_quantum: int = 64, engine: str = "cuda",
                 device="cuda"):
        devices = _resolve(engine, device, mesh)
        self.device = devices[0]
        self._places = _places(devices, mesh)
        tables = list(tables)
        _require_int32_safe(tables, params, affine)
        self.max_shift = max_shift
        self.params = tuple(params)
        self.affine = affine
        self.mesh = mesh
        self.bucket_quantum = bucket_quantum
        self.engine = engine
        self.n_pairs = len(tables)
        with joined(self._places):
            self._buckets = _shard_buckets(tables, bucket_quantum,
                                           self._places)

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
        buckets were built with.  With a mesh the devices are the mesh's,
        which the comparison of ``mesh`` covers: ``device`` is not used."""
        got = (max_shift, tuple(params), affine, mesh)
        have = (self.max_shift, self.params, self.affine, self.mesh)
        if got != have:
            raise ValueError(
                "PreparedBatch was built with (max_shift, params, "
                f"affine, mesh)={have} but score_batch was called with "
                f"{got}; rebuild the PreparedBatch for the new settings"
            )
        if engine != self.engine or (
                mesh is None
                and torch.device(device).type != self.device.type):
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
        with joined(self._places):
            parts = _dispatch_scores(self._buckets, self.max_shift,
                                     self.params, self.affine, self.engine)
        return PendingScores(self.n_pairs, parts)

    def scores(self) -> np.ndarray:
        """Score every pair; returns int64 scores in the original input
        order.  Only kernel dispatches and the scores' one copy back: no
        bucket rebuild, no transfer of tables."""
        return self.dispatch().get()
