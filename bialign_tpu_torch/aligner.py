"""BiAligner on PyTorch: one pair, band filled and walked on the device.

Counterpart of :class:`bialign_tpu.aligner.BiAligner` for the single-pair
path: host preprocessing and score tables (reused from ``bialign_tpu``),
the band fill (:mod:`bialign_tpu_torch.ops.cuda_dp`), the final score, the
walk on the device (:mod:`bialign_tpu_torch.ops.device_traceback`) and the
host decode (:mod:`bialign_tpu.render.decode`).

Engines (``engine=``; the device is explicit, ``device=``):

* ``"cuda"`` (default): the hand-written CUDA kernels.  Needs a CUDA
  device; raises otherwise.
* ``"torch"``: the plain PyTorch twins of the kernels, on any device.

Not in this port yet, and refused with ``NotImplementedError`` rather than
run some other way: ``lowmem`` (ROADMAP P13), ``seqsplit_mesh`` (P15) and
the int64 engine for tables that fail the int32 check (P2).
"""

from __future__ import annotations

import torch

from bialign_tpu.aligner import PARAM_DEFAULTS
from bialign_tpu.aligner import BiAligner as _JaxAligner
from bialign_tpu.models.molecule import MoleculeError, preprocess_molecule
from bialign_tpu.ops.cases import check_int32_safe
from bialign_tpu.render import decode as render_decode
from bialign_tpu.scoring.tables import build_score_tables

from .convert import tables_to_torch
from .ops import cuda_dp
from .ops import device_traceback as dtb

ENGINES = ("cuda", "torch")


class BiAligner:
    """Bi-alignment of two molecules (sequences + secondary structures),
    with the public surface of :class:`bialign_tpu.BiAligner`:
    ``optimize()``, ``traceback()``, ``decode_trace()``,
    ``decode_trace_full()``, ``eval_trace()``, ``mu1_at()``, ``mu2_at()``.
    """

    nl = render_decode.NL_ROW
    outmodes = render_decode.OUTMODES

    # Methods of the JAX package's class that touch no JAX, shared as they
    # are: the decode, the verbose replay (through self.traceback and
    # self._band_cells below) and the table accessors.
    _is_rna = _JaxAligner._is_rna
    _affine = _JaxAligner._affine
    error = staticmethod(_JaxAligner.error)
    mu1_at = _JaxAligner.mu1_at
    mu2_at = _JaxAligner.mu2_at
    decode_trace_full = _JaxAligner.decode_trace_full
    decode_trace = _JaxAligner.decode_trace
    eval_trace = _JaxAligner.eval_trace
    _eval_affine_trace = _JaxAligner._eval_affine_trace

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

        try:
            self.molA = preprocess_molecule(seqA, strA, is_rna=self._is_rna)
            self.molB = preprocess_molecule(seqB, strB, is_rna=self._is_rna)
        except MoleculeError as e:
            self.error(str(e))

        self.gamma = int(self._params["gap_cost"])
        self.beta = int(self._params["gap_opening_cost"])
        self.delta = int(self._params["shift_cost"])
        self.max_shift = int(self._params["max_shift"])

        self.mu1, self.mu2 = build_score_tables(
            self.molA, self.molB, self._params, is_rna=self._is_rna
        )
        self._band = None

    def _fill(self):
        if self._params.get("lowmem"):
            raise NotImplementedError(
                "lowmem (the checkpointed band) is not ported yet: "
                "ROADMAP.md Queue 1 P13"
            )
        if self._params.get("seqsplit_mesh") is not None:
            raise NotImplementedError(
                "seqsplit_mesh (one pair over several devices) is not "
                "ported yet: ROADMAP.md Queue 1 P15"
            )
        if not check_int32_safe(self.mu1, self.mu2, self._params):
            raise NotImplementedError(
                "these scores exceed the certified int32 range and need the "
                "int64 engine, which is not ported yet: ROADMAP.md Queue 1 P2"
            )
        mu1, mu2 = tables_to_torch(self.mu1, self.mu2, self.device)
        self._mu1_t, self._mu2_t = mu1, mu2
        cuda = self._engine == "cuda"
        if self._affine:
            fill = (cuda_dp.fill_affine_device if cuda
                    else cuda_dp.fill_affine_plain)
            self._band = fill(mu1, mu2, self.max_shift, self.beta,
                              self.gamma, self.delta)
        else:
            fill = (cuda_dp.fill_nonaffine_device if cuda
                    else cuda_dp.fill_nonaffine_plain)
            self._band = fill(mu1, mu2, self.max_shift, self.gamma,
                              self.delta)

    def optimize(self) -> int:
        """Fill the DP band; return the optimal score (pyx:443-509)."""
        self._fill()
        return self._band.final_score()

    def traceback(self):
        """Trace columns of one optimal alignment (pyx:513-586)."""
        if self._band is None:
            self.optimize()
        cuda = self._engine == "cuda"
        if self._affine:
            walk = (dtb.affine_traceback if cuda
                    else dtb.affine_traceback_plain)
            trace, complete = walk(self._band, self.beta, self.gamma,
                                   self.delta, self._mu1_t, self._mu2_t)
            if not complete:
                print("WARNING: incomplete traceback. "
                      "Alignment could be garbage.")
            return trace
        walk = (dtb.nonaffine_traceback if cuda
                else dtb.nonaffine_traceback_plain)
        return walk(self._band, self.gamma, self.delta, self._mu1_t,
                    self._mu2_t)

    def _band_cells(self, idxs):
        """Values of band cells (i, j, k, l), for the verbose replay."""
        return self._band.cells(idxs)
