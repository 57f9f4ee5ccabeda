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

The stages are timed in spans (:mod:`bialign_tpu_torch.utils.profiling`):
``pair.setup`` (the constructor: ``pair.molecules``, ``pair.tables``),
``pair.fill`` (``optimize()``: ``pair.check``, the int32 check;
``pair.upload``, the tables to the device; ``pair.launch``, the fill's call,
which queues its kernels; ``pair.score``, the final score, which waits for
the device), ``pair.walk`` (``traceback()``) and ``pair.decode``
(``decode_trace()``).

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

            with span("pair.tables"):
                self.mu1, self.mu2 = build_score_tables(
                    self.molA, self.molB, self._params, is_rna=self._is_rna
                )
        self._band = None
        self._int64 = False     # the band is the int64 engine's

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
            safe = check_int32_safe(self.mu1, self.mu2, self._params)
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
        with span("pair.upload"):
            mu1, mu2 = tables_to_torch(self.mu1, self.mu2, self.device)
        self._mu1_t, self._mu2_t = mu1, mu2
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
