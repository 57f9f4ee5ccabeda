"""Sequence split: one pair's fill with its lattice rows sharded over the
devices of a mesh axis.

Counterpart of :mod:`bialign_tpu.parallel.seqsplit`.  The rows ``0..n`` of
every diagonal's slab are split into K contiguous ranges ``[a_k, b_k]``,
as even as they divide (no padding), one a device of ``mesh.along(axis)``.
The recurrence's only dependency across rows is row i-1 of diagonals d-1
and d-2, so after each diagonal the last row of shard k goes to shard k+1:
the one-row halo that the JAX package sends by ``ppermute``.

* Shard k's slabs have lines of ``P_k = b_k - a_k + 2`` rows: slot 0 holds
  the halo (row ``a_k - 1``; shard 0's, row -1, is never read), then its
  own rows.  Its ring is ``[3, (9,) W, W, P_k]``, its checkpoints
  ``[NB, 2, (9,) W, W, P_k]``.  The tables ``mu1``, ``mu2`` are whole on
  every device (one copy a device), read by absolute row.
* The kernels (``csrc/seqsplit.cu``, the tile kernel of
  ``csrc/tile_diag.cuh`` in its row-shard form) take one of two routes
  (:func:`split_route`; ``route=`` forces one).  Route ``"resident"``: one
  cooperative launch a device for the whole call, every CTA resident at
  once and owning fixed rows, progress flags in device memory between
  neighbouring CTAs, the halo pulled by the next shard's first CTA (a load
  through peer memory between cards).  Route ``"streams"``: one C host
  loop over the diagonals and, inside it, over the shards, each shard on a
  stream of its own, the halo copied by ``cudaMemcpy2DAsync`` on the
  receiving shard's stream between events.  :data:`LAUNCHES` counts a call
  of each route's entry points under names of their own:
  ``seqsplit_[resident_]score_*`` the score-only ring fill (K1/K2
  score-only, split), ``seqsplit_[resident_]ckpt_*`` the checkpointed fill
  (K9/K11), ``seqsplit_[resident_]block_*`` one block of C diagonals into
  a window from its checkpoint (K10/K12).
* ``*_plain`` are their twins: the per-diagonal steps of
  :mod:`~bialign_tpu_torch.ops.cuda_dp` over a ``_Geometry`` of each
  shard's rows, the halo copied after each diagonal as the kernels copy
  it.  A wrapper launches the kernels for shards on CUDA devices and runs
  the twin for shards on the CPU.
* :func:`score_seqsplit` returns the score: read from the last shard, which
  owns row n.  :func:`fill_seqsplit` returns a :class:`SeqsplitBand`, a
  :class:`~bialign_tpu_torch.ops.checkpoint_dp.CheckpointBand` with a
  checkpoint tensor a shard on its device.  Its blocks are refilled
  sharded and their rows gathered onto the first shard's device, where the
  blockwise walks (``csrc/walk.cu``) and ``cells()`` read them as any
  window, so ``affine_traceback`` / ``nonaffine_traceback`` and the
  aligner's decode path take it unchanged.

``engine="cuda"`` (default) runs the kernels and needs every device of the
axis to be a CUDA device; ``engine="torch"`` runs the twins on any devices
(the route then only checked).
Scores, checkpoints, windows and traces equal the single-device paths'
(tests/test_torch_seqsplit.py, tests/test_torch_tile_emulation.py,
tests/test_torch_seqsplit_resident.py).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..convert import tables_to_torch
from ..ops import cuda_dp
from ..ops.band import INVALID
from ..ops.cases import N_STATES
# the fault word (one a process) is shared with the other kernels whose
# CTAs wait on progress flags
from ..ops.cuda_dp import fault_word
from ..ops.checkpoint_dp import (
    CheckpointBand,
    _block_size,
    _check_block,
    _check_ring,
)
from .mesh import joined, mesh_devices, shard_stream, split

ENGINES = ("cuda", "torch")
ROUTES = ("resident", "streams")
# the most shards of a call on route "resident" (csrc/seqsplit.cu
# kMaxResident: the shards go by value in the kernel's arguments)
RESIDENT_MAX_SHARDS = 32

# Calls of each entry point: one a call of a route "streams" host loop, or
# of a route "resident" launcher (one cooperative launch a device).
LAUNCHES = {f"seqsplit_{route}{what}_{kind}": 0
            for route in ("", "resident_")
            for what in ("score", "ckpt", "block")
            for kind in ("affine", "nonaffine")}


@dataclass(frozen=True)
class Shard:
    """Rows ``a..b`` of one pair on ``device``, the pair's whole tables
    there, and the CUDA stream its diagonals run on (None off CUDA)."""

    device: torch.device
    a: int
    b: int
    mu1: torch.Tensor
    mu2: torch.Tensor
    stream: object = None

    @property
    def rows(self) -> int:
        """P: the halo row a-1, then a..b."""
        return self.b - self.a + 2


def _check_engine(engine: str, devices) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "cuda" and (not torch.cuda.is_available() or any(
            d.type != "cuda" for d in devices)):
        raise RuntimeError(
            f"engine='cuda' needs CUDA devices, got {[str(d) for d in devices]}"
            f" (CUDA available: {torch.cuda.is_available()}); engine='torch' "
            "runs the plain PyTorch twins on any device")


def make_shards(mu1, mu2, devices, rows=None) -> tuple:
    """The shards of a pair over ``devices``: rows ``0..n`` split as even as
    they divide (``rows``: the (a, b) ranges instead), a device given no
    row left out; the tables (host arrays or tensors) copied once to each
    device."""
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    n = np.shape(mu1)[0] - 1
    if rows is None:
        rows = [(lo, hi - 1) for lo, hi in split(n + 1, len(devices))]
    if len(rows) != len(devices):
        raise ValueError(f"{len(rows)} row ranges for {len(devices)} devices")
    host = None
    tables, out = {}, []
    for dev, (a, b) in zip(devices, rows):
        if b < a:
            continue
        if dev not in tables:
            if isinstance(mu1, torch.Tensor):
                tables[dev] = (mu1.to(dev), mu2.to(dev))
            else:
                host = host or tables_to_torch(mu1, mu2, "cpu")
                tables[dev] = tuple(t.to(dev) for t in host)
        out.append(Shard(dev, a, b, *tables[dev], stream=shard_stream(dev)))
    want = 0
    for s in out:
        if s.a != want:
            raise ValueError(f"row ranges {rows} do not cover 0..{n} in order")
        want = s.b + 1
    if want != n + 1:
        raise ValueError(f"row ranges {rows} do not cover 0..{n} in order")
    return tuple(out)


def _states(affine: bool) -> tuple:
    return (N_STATES,) if affine else ()


def _slab(s: Shard, S: int, affine: bool) -> tuple:
    W = 2 * S + 1
    return (*_states(affine), W, W, s.rows)


def _memory(shards, shape_of, given, plain: bool, what: str) -> list:
    """A tensor ``shape_of(shard)`` a shard on its device: ``given`` checked,
    else fresh (INVALID for a twin, uninitialised for a kernel)."""
    if given is not None:
        if len(given) != len(shards):
            raise ValueError(f"{len(given)} {what} for {len(shards)} shards")
        for s, t in zip(shards, given):
            _check_ring(t, shape_of(s), s.mu1, what)
        return list(given)
    if plain:
        return [torch.full(shape_of(s), INVALID, dtype=torch.int32,
                           device=s.device) for s in shards]
    return [torch.empty(shape_of(s), dtype=torch.int32, device=s.device)
            for s in shards]


def _check_shards(shards, S: int) -> tuple:
    """(n, m) of the pair the shards hold."""
    if not shards:
        raise ValueError("no shards")
    for s in shards:
        cuda_dp._check_tables(s.mu1, s.mu2, S)
    n, m = shards[0].mu1.shape[0] - 1, shards[0].mu1.shape[1] - 1
    if shards[-1].b != n:
        raise ValueError(f"the last shard ends at row {shards[-1].b}, not {n}")
    return n, m


def _on_cpu(shards) -> bool:
    types = {s.device.type for s in shards}
    if len(types) != 1:
        raise ValueError(f"shards on devices of types {sorted(types)}")
    return types == {"cpu"}


# -- the routes --------------------------------------------------------------

def split_route(shards) -> str:
    """``"resident"`` when every two neighbouring shards lie on one device
    or on CUDA devices that reach each other's memory
    (``torch.cuda.can_device_access_peer``) and there are at most
    :data:`RESIDENT_MAX_SHARDS`; else ``"streams"``.  Each device's grid is
    then resident at once: its rows a CTA default to the fewest whole tiles
    that keep it so (``csrc/seqsplit.cu``)."""
    if len(shards) > RESIDENT_MAX_SHARDS:
        return "streams"
    for up, down in zip(shards, shards[1:]):
        if up.device == down.device:
            continue
        if (up.device.type != "cuda" or down.device.type != "cuda"
                or not torch.cuda.can_device_access_peer(up.device.index,
                                                         down.device.index)
                or not torch.cuda.can_device_access_peer(down.device.index,
                                                         up.device.index)):
            return "streams"
    return "resident"


def _route(shards, route, rows=None) -> str:
    """``route`` checked against the shards (and ``rows``, a CTA's rows,
    which only route "resident" takes), or their own route."""
    if route is None:
        route = split_route(shards)
    if rows is not None and (route != "resident" or rows < 1):
        raise ValueError(f"rows={rows}: a CTA's rows (>= 1) on route "
                         f"'resident' only, not on {route!r}")
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got "
                         f"{route!r}")
    if route == "resident" and split_route(shards) != "resident":
        raise ValueError(
            f"route 'resident' cannot run on shards of "
            f"{[str(s.device) for s in shards]}: more than "
            f"{RESIDENT_MAX_SHARDS} shards, or neighbouring devices without "
            "peer access; route 'streams' runs there")
    return route


# -- the kernels -------------------------------------------------------------

def shard_table(shards, slabs, extras, *, streams=None, flags=None,
                rows: int = 0, fault=None) -> torch.Tensor:
    """The int64 ``[K, 11]`` host table of the split's C entry points
    (``csrc/seqsplit.cu`` ``ShardField``): a shard's slabs (ring or window),
    tables, ``extras`` (its checkpoints, or None), rows a and b, device
    index and stream handle (``streams``, else the shard's: a CUDA
    stream's, or an int); for route "resident" also its progress
    ``flags`` (an int32 tensor a shard), its ``rows`` a CTA (0: the
    default) and the ``fault`` word."""
    K = len(shards)
    streams = streams or [s.stream for s in shards]
    flags = flags or [None] * K
    return torch.tensor(
        [[sl.data_ptr(), s.mu1.data_ptr(), s.mu2.data_ptr(),
          0 if ex is None else ex.data_ptr(), s.a, s.b, s.device.index or 0,
          getattr(st, "cuda_stream", st or 0),
          0 if fl is None else fl.data_ptr(), rows,
          0 if fault is None else fault.data_ptr()]
         for s, sl, ex, st, fl in zip(shards, slabs, extras, streams, flags)],
        dtype=torch.int64)


def _launch(name: str, shards, slabs, extras, *ints) -> None:
    """The C host loop ``bialign_<name>`` over the shards, ordered after
    the work queued on their devices' current streams and before what is
    queued there next."""
    table = shard_table(shards, slabs, extras)
    with joined((s.device, s.stream) for s in shards):
        _build.call(f"bialign_{name}", table, len(shards), *ints)
    LAUNCHES[name] += 1


def flag_memory(shards) -> list:
    """Zeroed progress flags on each shard's device, an int32 a row of the
    shard (enough for a CTA a row): one tensor a device, a view a shard."""
    sizes = {}
    for s in shards:
        sizes[s.device] = sizes.get(s.device, 0) + s.b - s.a + 1
    whole = {dev: torch.zeros(size, dtype=torch.int32, device=dev)
             for dev, size in sizes.items()}
    at, out = dict.fromkeys(sizes, 0), []
    for s in shards:
        out.append(whole[s.device][at[s.device]:at[s.device] + s.b - s.a + 1])
        at[s.device] += s.b - s.a + 1
    return out


@contextmanager
def _in_step(devices):
    """Over several CUDA devices, their current streams wait for each other
    before the body and after it: launches that read each other's memory
    (flags, the halo) start after what every device queued before them
    (the flags' zeroing, the slabs' contents) and end before what any
    queues next (which may reuse that memory)."""
    streams = ([torch.cuda.current_stream(d) for d in devices]
               if len(devices) > 1 else [])

    def meet():
        for s in streams:
            for other in streams:
                if other is not s:
                    s.wait_stream(other)
    meet()
    yield
    meet()


def _launch_resident(name: str, shards, slabs, extras, *ints,
                     rows=None) -> None:
    """The launcher ``bialign_<name>``: one cooperative launch a device on
    its current stream, the devices' streams in step (:func:`_in_step`);
    raises if an earlier launch faulted."""
    fault = fault_word()
    if int(fault[0]):
        raise RuntimeError(
            f"{name}: an earlier route 'resident' launch trapped: CTA "
            f"{int(fault[1])} waited out its budget for its neighbour "
            f"{'above' if int(fault[3]) == 1 else 'below'} at diagonal "
            f"{int(fault[2])}")
    streams = [torch.cuda.current_stream(s.device) for s in shards]
    table = shard_table(shards, slabs, extras, streams=streams,
                        flags=flag_memory(shards), rows=rows or 0,
                        fault=fault)
    with _in_step(list(dict.fromkeys(s.device for s in shards))):
        _build.call(f"bialign_{name}", table, len(shards), *ints)
    LAUNCHES[name] += 1


def _launch_route(route: str, what: str, affine: bool, shards, slabs,
                  extras, *ints, rows=None) -> None:
    kind = "affine" if affine else "nonaffine"
    if route == "resident":
        _launch_resident(f"seqsplit_resident_{what}_{kind}", shards, slabs,
                         extras, *ints, rows=rows)
    else:
        _launch(f"seqsplit_{what}_{kind}", shards, slabs, extras, *ints)


# -- the twins ---------------------------------------------------------------

def _steps(shards, S: int, params, affine: bool) -> list:
    step = cuda_dp._affine_step if affine else cuda_dp._nonaffine_step
    return [step(cuda_dp._Geometry(s.mu1, s.mu2, S, rows=(s.a, s.b)),
                 *params) for s in shards]


def _diagonals_plain(shards, steps, n: int, m: int, slab_of, first: int,
                     last: int, before=None) -> None:
    """Diagonals ``first..last`` over the shards as the kernels run them:
    ``before(d)`` (the checkpoints), then each shard's step on its live
    rows of d, writing ``slab_of(k, d)`` from ``slab_of(k, d-1)`` and
    ``slab_of(k, d-2)``; then, where row b_k lies on d, that row into slot
    0 of shard k+1's slab of d."""
    for d in range(first, last + 1):
        if before is not None:
            before(d)
        for k, s in enumerate(shards):
            if max(0, d - m, s.a) > min(n, d, s.b):
                continue
            val, live = steps[k](d, slab_of(k, d - 1), slab_of(k, d - 2))
            out = slab_of(k, d)
            out.copy_(torch.where(live, val, out))
        for k in range(1, len(shards)):
            if d - m <= shards[k - 1].b <= d:
                slab_of(k, d)[..., 0] = slab_of(k - 1, d)[..., -1]


# -- the score-only ring fill ------------------------------------------------

def _ring_shape(s: Shard, S: int, affine: bool) -> tuple:
    return (cuda_dp.RING, *_slab(s, S, affine))


def seqsplit_last_slabs(shards, max_shift: int, params, affine: bool, *,
                        rings=None, route=None, rows=None) -> list:
    """The score-only fill over the shards (K1/K2 score-only, split): each
    shard's ring, diagonal n+m in its slab (n+m) % 3.  The kernels of
    ``route`` (None: :func:`split_route`; ``rows``: a CTA's rows on route
    "resident") for shards on CUDA devices, the twin for shards on the CPU.
    ``rings``: a ``[3, (9,) W, W, P_k]`` a shard to use, whatever it
    holds."""
    n, m = _check_shards(shards, max_shift)
    route = _route(shards, route, rows)
    if _on_cpu(shards):
        return seqsplit_last_slabs_plain(shards, max_shift, params, affine,
                                         rings=rings)
    rings = _memory(shards, lambda s: _ring_shape(s, max_shift, affine),
                    rings, False, "rings")
    _launch_route(route, "score", affine, shards, rings,
                  [None] * len(shards),
                  cuda_dp._tile_consts(affine, tuple(params), max_shift), n,
                  m, max_shift, rows=rows)
    return rings


def seqsplit_last_slabs_plain(shards, max_shift: int, params, affine: bool,
                              *, rings=None) -> list:
    """Plain twin of the split score-only fill, on the shards' devices."""
    n, m = _check_shards(shards, max_shift)
    rings = _memory(shards, lambda s: _ring_shape(s, max_shift, affine),
                    rings, True, "rings")
    _diagonals_plain(shards, _steps(shards, max_shift, params, affine), n, m,
                     lambda k, d: rings[k][d % cuda_dp.RING], 0, n + m)
    return rings


def _score_of(shards, rings, n: int, m: int, S: int, affine: bool) -> int:
    last, ring = shards[-1], rings[-1]
    slab = ring[(n + m) % cuda_dp.RING]
    at = n - last.a + 1
    return int(slab[:, S, S, at].max() if affine else slab[S, S, at])


def score_seqsplit(mu1, mu2, max_shift: int, params: tuple, *, mesh,
                   axis: str = "sp", affine: bool = True,
                   engine: str = "cuda", route=None) -> int:
    """Optimal score of one pair, its rows sharded over ``mesh.along(axis)``.
    ``params``: (beta, gamma, delta) for affine, (gamma, delta) otherwise;
    ``route``: the kernels' (None: :func:`split_route`).  Equal to
    ``cuda_dp.affine_score`` / ``nonaffine_score``."""
    devices = mesh_devices(mesh, axis)
    _check_engine(engine, devices)
    shards = make_shards(mu1, mu2, devices)
    n, m = _check_shards(shards, max_shift)
    params = tuple(int(v) for v in params)
    if affine:
        cuda_dp._require_int32_safe(shards[0].mu1, shards[0].mu2, params[1],
                                    params[2], params[0])
    else:
        cuda_dp._require_int32_safe(shards[0].mu1, shards[0].mu2, *params)
    route = _route(shards, route)
    if engine == "cuda":
        rings = seqsplit_last_slabs(shards, max_shift, params, affine,
                                    route=route)
    else:
        rings = seqsplit_last_slabs_plain(shards, max_shift, params, affine)
    return _score_of(shards, rings, n, m, max_shift, affine)


# -- the checkpointed fill ---------------------------------------------------

def _ckpts_shape(s: Shard, S: int, affine: bool, n: int, m: int,
                 C: int) -> tuple:
    return ((n + m) // C + 1, 2, *_slab(s, S, affine))


def seqsplit_checkpoints(shards, max_shift: int, params, affine: bool,
                         block: int, *, rings=None, ckpts=None, route=None,
                         rows=None) -> tuple:
    """The checkpointed fill over the shards (K9/K11, split): (rings,
    checkpoints), a ring and a ``[NB, 2, (9,) W, W, P_k]`` a shard,
    ``ckpts[b] = (diagonal b*C - 1, diagonal b*C - 2)`` for b >= 1.  The
    kernels of ``route`` for shards on CUDA devices (``route``, ``rows`` as
    in :func:`seqsplit_last_slabs`), the twin on the CPU."""
    n, m = _check_shards(shards, max_shift)
    route = _route(shards, route, rows)
    if _on_cpu(shards):
        return seqsplit_checkpoints_plain(shards, max_shift, params, affine,
                                          block, rings=rings, ckpts=ckpts)
    C = _block_size(block, n + m + 1)
    rings = _memory(shards, lambda s: _ring_shape(s, max_shift, affine),
                    rings, False, "rings")
    ckpts = _memory(shards, lambda s: _ckpts_shape(s, max_shift, affine, n,
                                                   m, C), ckpts, False,
                    "ckpts")
    _launch_route(route, "ckpt", affine, shards, rings, ckpts,
                  cuda_dp._tile_consts(affine, tuple(params), max_shift), n,
                  m, max_shift, C, rows=rows)
    return rings, ckpts


def seqsplit_checkpoints_plain(shards, max_shift: int, params, affine: bool,
                               block: int, *, rings=None,
                               ckpts=None) -> tuple:
    """Plain twin of the split checkpointed fill."""
    n, m = _check_shards(shards, max_shift)
    C = _block_size(block, n + m + 1)
    R = cuda_dp.RING
    rings = _memory(shards, lambda s: _ring_shape(s, max_shift, affine),
                    rings, True, "rings")
    ckpts = _memory(shards, lambda s: _ckpts_shape(s, max_shift, affine, n,
                                                   m, C), ckpts, True,
                    "ckpts")

    def save(d):
        if d and d % C == 0:
            for ring, ck in zip(rings, ckpts):
                ck[d // C, 0] = ring[(d - 1) % R]
                ck[d // C, 1] = ring[(d - 2) % R]
    _diagonals_plain(shards, _steps(shards, max_shift, params, affine), n, m,
                     lambda k, d: rings[k][d % R], 0, n + m, save)
    return rings, ckpts


# -- one block's window ------------------------------------------------------

def seqsplit_block(shards, max_shift: int, params, affine: bool, ckpts,
                   d0: int, C: int, *, windows=None, route=None,
                   rows=None) -> list:
    """Diagonals ``d0..min(d0+C-1, n+m)`` over the shards from their
    checkpoints ``ckpts`` (a ``[2, (9,) W, W, P_k]`` a shard: diagonals
    d0-1, d0-2) into windows ``[C+2, (9,) W, W, P_k]`` (K10/K12, split):
    slabs 0 and 1 the checkpoint's (d0-2, d0-1) unless d0 is 0, slab x+2
    diagonal d0+x.  The kernels of ``route`` on CUDA devices (``route``,
    ``rows`` as in :func:`seqsplit_last_slabs`), the twin on the CPU."""
    n, m = _check_shards(shards, max_shift)
    route = _route(shards, route, rows)
    if _on_cpu(shards):
        return seqsplit_block_plain(shards, max_shift, params, affine, ckpts,
                                    d0, C, windows=windows)
    windows = _memory(shards, lambda s: (C + 2, *_slab(s, max_shift, affine)),
                      windows, False, "windows")
    _launch_route(route, "block", affine, shards, windows, ckpts,
                  cuda_dp._tile_consts(affine, tuple(params), max_shift), n,
                  m, max_shift, d0, C, rows=rows)
    return windows


def seqsplit_block_plain(shards, max_shift: int, params, affine: bool, ckpts,
                         d0: int, C: int, *, windows=None) -> list:
    """Plain twin of the split block fill."""
    n, m = _check_shards(shards, max_shift)
    windows = _memory(shards, lambda s: (C + 2, *_slab(s, max_shift, affine)),
                      windows, True, "windows")
    if d0:
        for w, ck in zip(windows, ckpts):
            w[0] = ck[1]
            w[1] = ck[0]
    _diagonals_plain(shards, _steps(shards, max_shift, params, affine), n, m,
                     lambda k, d: windows[k][d - d0 + 2], d0,
                     min(d0 + C - 1, n + m))
    return windows


# -- the checkpointed band of a split fill -----------------------------------

@dataclass(frozen=True)
class SeqsplitBand(CheckpointBand):
    """A checkpointed band whose fill and block recomputation run sharded
    (:func:`fill_seqsplit`).  ``ckpts``: a checkpoint tensor a shard,
    ``[NB, 2, (9,) W, W, P_k]`` on its device; ``final``: each shard's slab
    of diagonal n+m; ``mu1``, ``mu2``: the tables on the first shard's
    device, where windows are gathered and walked.  ``engine``: "cuda" runs
    the block kernels on ``route``, "torch" their twins."""

    shards: tuple = ()
    engine: str = "cuda"
    route: str = "resident"

    @property
    def window_shape(self) -> tuple:
        W = 2 * self.max_shift + 1
        return (min(self.block, self.n + self.m + 1) + 2,
                *_states(self.affine), W, W, self.n + 1)

    def final_score(self) -> int:
        n, S = self.n, self.max_shift
        at = n - self.shards[-1].a + 1
        slab = self.final[-1]
        return int(slab[:, S, S, at].max() if self.affine else slab[S, S, at])

    def _check_ckpts(self) -> None:
        n, m, S = self.n, self.m, self.max_shift
        if len(self.ckpts) != len(self.shards):
            raise ValueError(f"{len(self.ckpts)} checkpoints for "
                             f"{len(self.shards)} shards")
        for s, ck in zip(self.shards, self.ckpts):
            _check_ring(ck, _ckpts_shape(s, S, self.affine, n, m, self.block),
                        s.mu1, "ckpts")

    def _recompute(self, b: int, *, plain: bool = False, window=None):
        """The window of block b on the first shard's device: block b
        refilled sharded (``plain``, or engine "torch": through the twin),
        then the shards' own rows (slots 1..) gathered there."""
        _check_block(self, b)
        shape = self.window_shape
        _check_ring(window, shape, self.mu1, "window")
        args = (self.shards, self.max_shift, self.params, self.affine,
                [ck[b] for ck in self.ckpts], b * self.block, shape[0] - 2)
        if plain or self.engine == "torch":
            parts = seqsplit_block_plain(*args)
        else:
            parts = seqsplit_block(*args, route=self.route)
        if window is None:
            window = torch.empty(shape, dtype=torch.int32, device=self.device)
        for s, part in zip(self.shards, parts):
            window[..., s.a:s.b + 1].copy_(part[..., 1:])
        return window


def fill_seqsplit(mu1, mu2, max_shift: int, params: tuple, *, mesh,
                  axis: str = "sp", affine: bool = True,
                  block: int | None = None,
                  engine: str = "cuda", route=None) -> SeqsplitBand:
    """Split fill of one pair that keeps checkpoints for the traceback
    (``block``: C, as in :mod:`~bialign_tpu_torch.ops.checkpoint_dp`;
    ``route``: the kernels', of the fill and of the blocks, None for
    :func:`split_route`).  Returns a :class:`SeqsplitBand`, which
    ``checkpoint_dp.affine_traceback`` / ``nonaffine_traceback`` and the
    aligner walk as any checkpointed band."""
    devices = mesh_devices(mesh, axis)
    _check_engine(engine, devices)
    shards = make_shards(mu1, mu2, devices)
    n, m = _check_shards(shards, max_shift)
    C = _block_size(block, n + m + 1)
    params = tuple(int(v) for v in params)
    route = _route(shards, route)
    if engine == "cuda":
        rings, ckpts = seqsplit_checkpoints(shards, max_shift, params, affine,
                                            C, route=route)
    else:
        rings, ckpts = seqsplit_checkpoints_plain(shards, max_shift, params,
                                                  affine, C)
    R = cuda_dp.RING
    return SeqsplitBand(
        ckpts=tuple(ckpts), final=tuple(r[(n + m) % R] for r in rings),
        mu1=shards[0].mu1, mu2=shards[0].mu2, n=n, m=m, max_shift=max_shift,
        affine=affine, params=params, block=C, shards=shards, engine=engine,
        route=route)
