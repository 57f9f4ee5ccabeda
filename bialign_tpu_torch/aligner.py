"""BiAligner on PyTorch: one pair, band filled and walked on the device.

Counterpart of :class:`bialign_tpu.aligner.BiAligner` for the single-pair
path, on the port's own layers: host preprocessing
(:mod:`bialign_tpu_torch.models.molecule`), score tables
(:mod:`bialign_tpu_torch.scoring.tables`), the band fill
(:mod:`bialign_tpu_torch.ops.cuda_dp`), the final score, the walk on the
device (:mod:`bialign_tpu_torch.ops.device_traceback`) and the host decode
(:mod:`bialign_tpu_torch.render.decode`).  With ``lowmem=True`` the band is
a checkpointed one (:mod:`bialign_tpu_torch.ops.checkpoint_dp`): the fill
keeps two slabs every ``checkpoint_block`` diagonals and the traceback
recomputes the band block by block, for pairs whose band the device cannot
hold; score, trace and lines are the band path's.  With
``seqsplit_mesh=`` (a :class:`~bialign_tpu_torch.parallel.mesh.Mesh`) the
pair's rows are split over the devices of its axis ``seqsplit_axis``
(:mod:`bialign_tpu_torch.parallel.seqsplit`), checkpointed the same way,
whatever ``lowmem`` says.  Nothing is imported from ``bialign_tpu``.

Engines (``engine=``; the device is explicit, ``device=``):

* ``"cuda"`` (default): the hand-written CUDA kernels.  Needs a CUDA
  device; raises otherwise.
* ``"torch"``: the plain PyTorch twins of the kernels, on any device.

The score tables ``mu1``/``mu2`` (int32 ``[n+1, m+1]``) are built where
the fill reads them.  For a protein pair on a CUDA device, without
``seqsplit_mesh`` and with a rectangular similarity matrix (or match and
mismatch), the device builds them from the pair's residue and structure
codes (:mod:`bialign_tpu_torch.scoring.pair_codes`), with the host tables'
``KeyError`` and int32 verdict; ``BiAligner.mu1``/``mu2`` are then their
copies on the host, made on first read.  Everything else builds them on
the host (:func:`~bialign_tpu_torch.scoring.tables.build_score_tables`)
and uploads them in ``optimize()``.

The stages are timed in spans (:mod:`bialign_tpu_torch.utils.profiling`):
``pair.setup`` (the constructor: ``pair.molecules``, ``pair.tables``; on
the device route ``pair.tables`` holds ``pair.encode``, the codes, their
checks and the tables' peak, and ``pair.planes``, the tables queued on
the device), ``pair.fill`` (``optimize()``: ``pair.check``, the int32
check; ``pair.upload``, host tables to the device; ``pair.launch``, the
fill's call, which queues its kernels; ``pair.score``, the final score,
which waits for the device), ``pair.walk`` (``traceback()``) and
``pair.decode`` (``decode_trace()``).  The count of ``pair.planes`` over
that of ``pair.tables`` is the share of pairs on the device route.

Tables and costs that fail the int32 check
(:func:`~bialign_tpu_torch.ops.cases.check_int32_safe`) take the int64
engine whichever engine was asked for, with a ``RuntimeWarning``, as the
JAX package does: the plain recurrence at int64 on the aligner's device
(``cuda_dp.fill_*_plain(dtype=torch.int64)``, a full band also with
``lowmem=True`` or ``seqsplit_mesh``), the host walk and the decode on that
band.
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from .convert import tables_to_torch
from .models.molecule import MoleculeError, preprocess_molecule
from .ops import checkpoint_dp, cuda_dp
from .ops import device_traceback as dtb
from .ops.cases import (
    NonAffineTables,
    affine_score_multiplicities,
    check_int32_safe,
)
from .render import decode as render_decode
from .scoring import pair_codes
from .scoring.tables import build_score_tables
from .utils.profiling import span

ENGINES = ("cuda", "torch")

# Reference parameter defaults (bialign.py:25-96).  The reference requires
# every key to be present in **params (KeyError otherwise); missing keys
# default to the CLI defaults, a strict superset of accepted inputs.
PARAM_DEFAULTS = {
    "type": "RNA",
    "sequence_match_similarity": 100,
    "sequence_mismatch_similarity": 0,
    "structure_weight": 400,
    "gap_opening_cost": 0,
    "gap_cost": -200,
    "shift_cost": -250,
    "max_shift": 2,
    "simmatrix": None,
    "nameA": "A",
    "nameB": "B",
    # the checkpointed band: two slabs kept every checkpoint_block
    # diagonals (None: sqrt(2 (n+m+1))), blocks recomputed in the traceback
    "lowmem": False,
    "checkpoint_block": None,
    # the sequence split: one pair's rows over the devices of a mesh axis
    # (parallel/seqsplit.py); implies the checkpointed band and traceback
    "seqsplit_mesh": None,
    "seqsplit_axis": "sp",
}


def _builds_on_device(device: torch.device) -> bool:
    """Whether ``device`` builds a pair's tables from codes: a CUDA device,
    which host tables reach only through an O(n*m) check and upload; on
    the CPU the host tables are already the device's."""
    return device.type == "cuda"


def _code_table(device: torch.device, params: dict):
    """The route of a pair's tables: the
    :class:`~bialign_tpu_torch.scoring.pair_codes.CodeTable` they are built
    from on ``device``, or ``None`` for host tables (RNA, whose mu2 is
    float64 math; the sequence split, which places host tables itself; a
    ragged matrix; a device that does not build them)."""
    if (not _builds_on_device(device) or params["type"] != "Protein"
            or params.get("seqsplit_mesh") is not None):
        return None
    return pair_codes.code_table(params)


class BiAligner:
    """Bi-alignment of two molecules (sequences + secondary structures),
    with the public surface of :class:`bialign_tpu.BiAligner`:
    ``optimize()``, ``traceback()``, ``decode_trace()``,
    ``decode_trace_full()``, ``eval_trace()``, ``mu1_at()``, ``mu2_at()``.
    """

    nl = render_decode.NL_ROW
    outmodes = render_decode.OUTMODES

    def __init__(self, seqA, seqB, strA, strB, *, engine: str = "cuda",
                 device="cuda", **params):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self._engine = engine
        self.device = torch.device(device)
        if engine == "cuda" and (self.device.type != "cuda"
                                 or not torch.cuda.is_available()):
            raise RuntimeError(
                f"engine='cuda' needs a CUDA device, got device={device!r} "
                f"(CUDA available: {torch.cuda.is_available()}); "
                "engine='torch' runs the plain PyTorch twins on any device"
            )
        self._params = dict(PARAM_DEFAULTS)
        self._params.update(params)

        # the constructor's work: molecules and score tables
        with span("pair.setup"):
            try:
                with span("pair.molecules"):
                    self.molA = preprocess_molecule(seqA, strA,
                                                    is_rna=self._is_rna)
                    self.molB = preprocess_molecule(seqB, strB,
                                                    is_rna=self._is_rna)
            except MoleculeError as e:
                self.error(str(e))

            self.gamma = int(self._params["gap_cost"])
            self.beta = int(self._params["gap_opening_cost"])
            self.delta = int(self._params["shift_cost"])
            self.max_shift = int(self._params["max_shift"])

            # _peak: the tables' peak magnitude where the device built them
            # (then _mu, their host copies, is made on first read)
            self._mu, self._peak = None, None
            with span("pair.tables"):
                table = _code_table(self.device, self._params)
                if table is not None:
                    self._tables_from_codes(table)
                if self._peak is None:
                    self._mu = list(build_score_tables(
                        self.molA, self.molB, self._params,
                        is_rna=self._is_rna))
        self._band = None
        self._int64 = False     # the band is the int64 engine's

    def _tables_from_codes(self, table):
        """The device route: the tables on the device from the pair's codes;
        leaves ``_peak`` None for a character outside latin-1, which the
        host tables then report."""
        sw = int(self._params["structure_weight"])
        with span("pair.encode"):
            codes = pair_codes.encode(self.molA, self.molB, table, sw)
        if codes is None:
            return
        with span("pair.planes"):
            self._mu1_t, self._mu2_t = pair_codes.planes(codes, table, sw,
                                                         self.device)
        self._peak = codes.peak

    def _host_tables(self) -> list:
        if self._mu is None:
            # one copy back each, kept
            self._mu = [t.cpu().numpy() for t in (self._mu1_t, self._mu2_t)]
        return self._mu

    def _set_host_table(self, k: int, mu) -> None:
        # tables set by hand are host tables: checked and uploaded by the fill
        self._host_tables()[k] = mu
        self._peak = None

    @property
    def mu1(self) -> np.ndarray:
        """Sequence scores, int32 ``[n+1, m+1]`` (1-based; row and column 0
        are 0).  Where the device built the tables this is their copy: to
        change what the fill reads, assign a table (``mu1``, ``mu2``)."""
        return self._host_tables()[0]

    @mu1.setter
    def mu1(self, mu):
        self._set_host_table(0, mu)

    @property
    def mu2(self) -> np.ndarray:
        """Structure scores, int32 ``[n+1, m+1]``."""
        return self._host_tables()[1]

    @mu2.setter
    def mu2(self, mu):
        self._set_host_table(1, mu)

    @property
    def _is_rna(self) -> bool:
        return self._params["type"] == "RNA"

    @property
    def _affine(self) -> bool:
        return int(self._params["gap_opening_cost"]) != 0

    @staticmethod
    def error(text):
        print("ERROR:", text)
        sys.exit(-1)

    # -- scoring accessors (1-based, reference pyx:435-440) ----------------

    def mu1_at(self, i: int, j: int) -> int:
        return int(self.mu1[i, j])

    def mu2_at(self, k: int, l: int) -> int:
        return int(self.mu2[k, l])

    # -- fill, score, walk -------------------------------------------------

    def _fill(self):
        costs = ((self.beta, self.gamma, self.delta) if self._affine
                 else (self.gamma, self.delta))
        with span("pair.check"):
            if self._peak is None:
                safe = check_int32_safe(self.mu1, self.mu2, self._params)
            else:
                safe = pair_codes.int32_safe(
                    self.molA["len"], self.molB["len"], self._peak,
                    self._params)
        if not safe:
            # the int32 range cannot be certified: the int64 engine, as the
            # JAX package's aligner runs its int64 XLA fill
            warnings.warn(
                "scoring parameters exceed the certified int32 range; using "
                "the int64 engine (the plain PyTorch recurrence at int64 on "
                f"{self.device}, slower than the int32 kernels)",
                RuntimeWarning, stacklevel=3)
            with span("pair.upload"):
                mu1, mu2 = (
                    torch.from_numpy(np.ascontiguousarray(mu, np.int64))
                    .to(self.device) for mu in (self.mu1, self.mu2))
            self._mu1_t, self._mu2_t = mu1, mu2
            fill = (cuda_dp.fill_affine_plain if self._affine
                    else cuda_dp.fill_nonaffine_plain)
            with span("pair.launch"):
                self._band = fill(mu1, mu2, self.max_shift, *costs,
                                  dtype=torch.int64)
            self._int64 = True
            return
        if self._params.get("seqsplit_mesh") is not None:
            from .parallel.seqsplit import fill_seqsplit

            # the split puts the tables on its devices itself
            with span("pair.launch"):
                self._band = fill_seqsplit(
                    self.mu1, self.mu2, self.max_shift, costs,
                    mesh=self._params["seqsplit_mesh"],
                    axis=self._params.get("seqsplit_axis", "sp"),
                    affine=self._affine,
                    block=self._params.get("checkpoint_block") or None,
                    engine=self._engine,
                    route=self._params.get("seqsplit_route"))
            self._mu1_t, self._mu2_t = self._band.mu1, self._band.mu2
            return
        if self._peak is None:
            with span("pair.upload"):
                self._mu1_t, self._mu2_t = tables_to_torch(
                    self.mu1, self.mu2, self.device)
        mu1, mu2 = self._mu1_t, self._mu2_t
        cuda = self._engine == "cuda"
        more = {}
        if self._params.get("lowmem"):
            # a CheckpointBand in place of the band; 0 as None, as in the
            # JAX package
            more["block"] = self._params.get("checkpoint_block") or None
            fills = ((checkpoint_dp.fill_affine_checkpoint,
                      checkpoint_dp.fill_affine_checkpoint_plain),
                     (checkpoint_dp.fill_nonaffine_checkpoint,
                      checkpoint_dp.fill_nonaffine_checkpoint_plain))
        else:
            fills = ((cuda_dp.fill_affine_device, cuda_dp.fill_affine_plain),
                     (cuda_dp.fill_nonaffine_device,
                      cuda_dp.fill_nonaffine_plain))
        fill = fills[0 if self._affine else 1][0 if cuda else 1]
        with span("pair.launch"):
            self._band = fill(mu1, mu2, self.max_shift, *costs, **more)

    def optimize(self) -> int:
        """Fill the DP band; return the optimal score (pyx:443-509)."""
        with span("pair.fill"):
            self._fill()
            with span("pair.score"):
                return self._band.final_score()

    def traceback(self):
        """Trace columns of one optimal alignment (pyx:513-586)."""
        if self._band is None:
            self.optimize()
        with span("pair.walk"):
            # the CUDA walk reads int32 bands; the int64 engine's is walked
            # on the host
            cuda = self._engine == "cuda" and not self._int64
            if isinstance(self._band, checkpoint_dp.CheckpointBand):
                # the band holds its tables
                mod, tables = checkpoint_dp, ()
            else:
                mod, tables = dtb, (self._mu1_t, self._mu2_t)
            if self._affine:
                walk = (mod.affine_traceback if cuda
                        else mod.affine_traceback_plain)
                trace, complete = walk(self._band, self.beta, self.gamma,
                                       self.delta, *tables)
                if not complete:
                    print("WARNING: incomplete traceback. "
                          "Alignment could be garbage.")
                return trace
            walk = (mod.nonaffine_traceback if cuda
                    else mod.nonaffine_traceback_plain)
            return walk(self._band, self.gamma, self.delta, *tables)

    def _band_cells(self, idxs):
        """Values of band cells (i, j, k, l), for the verbose replay; a
        checkpointed band recomputes the blocks they lie in."""
        if isinstance(self._band, checkpoint_dp.CheckpointBand):
            return self._band.cells(idxs, plain=self._engine != "cuda")
        return self._band.cells(idxs)

    # -- decoding ----------------------------------------------------------

    def decode_trace_full(self, trace=None):
        if trace is None:
            trace = self.traceback()
        return render_decode.decode_trace_full(
            trace, self.molA, self.molB,
            nameA=self._params["nameA"], nameB=self._params["nameB"],
            is_rna=self._is_rna,
        )

    def decode_trace(self, trace=None):
        with span("pair.decode"):
            return render_decode.decode_trace(
                self.decode_trace_full(trace),
                outmode=self._params.get("outmode") or "default",
                nodescription=bool(self._params.get("nodescription")),
            )

    # -- verbose evaluation (CLI -v; pyx:745-832) ---------------------------

    def eval_trace(self, trace=None):
        if self._affine:
            yield from self._eval_affine_trace(trace)
            return
        if trace is None:
            trace = self.traceback()

        tab = NonAffineTables(self.gamma, self.delta)
        cols = [tuple(int(v) for v in c) for c in tab.cols]

        # pass 1: per-column case scores and predecessor cells
        rows = []
        pred_idx = []
        idx = [0] * 4
        for y in trace:
            for k in range(4):
                idx[k] += y[k]
            i, j, k, l = idx
            for ci, col in enumerate(cols):
                if col == tuple(y):
                    case_score = (
                        int(tab.const[ci])
                        + int(tab.mu1_coef[ci]) * self.mu1_at(i, j)
                        + int(tab.mu2_coef[ci]) * self.mu2_at(k, l)
                    )
                    rows.append((list(idx), tuple(y), case_score))
                    pred_idx.append(
                        (i - col[0], j - col[1], k - col[2], l - col[3])
                    )
                    break

        # pass 2: one gather on the band's device for all predecessors
        if not pred_idx:
            return
        preds = self._band_cells(np.asarray(pred_idx, dtype=np.int64))
        for (row_idx, y, case_score), pred in zip(rows, preds):
            yield " ".join(
                str(item)
                for item in [row_idx, y, case_score, "-->",
                             int(pred) + case_score]
            )

    def _eval_affine_trace(self, trace=None):
        """Replay an affine trace, yielding debug lines (pyx:745-800)."""
        if trace is None:
            trace = self.traceback()

        def update_state(x, y):
            y = list(y)
            if y[0] == 0 and y[1] == 0:
                y[0], y[1] = x[0], x[1]
            if y[2] == 0 and y[3] == 0:
                y[2], y[3] = x[2], x[3]
            return y

        total_score = 0
        state = [1, 1, 1, 1]
        idx = [0] * 4
        for y in trace:
            for k in range(4):
                idx[k] += y[k]
            i, j, k, l = idx
            mu1c, mu2c, ng, nb, nd = affine_score_multiplicities(state, y)
            score = (
                ng * self.gamma + nb * self.beta + nd * self.delta
                + mu1c * self.mu1_at(i, j) + mu2c * self.mu2_at(k, l)
            )
            total_score += score
            state = update_state(state, y)
            yield " ".join(
                str(item)
                for item in [idx, list(y), score, "-->", total_score]
            )
