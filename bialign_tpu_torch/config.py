"""Typed alignment configuration.

The reference passes a flat argparse namespace as ``**params`` kwargs into
``BiAligner`` and reads them by string key (bialign.py:25-96 →
bialignment.pyx:179-197).  SURVEY.md §5 calls for a typed dataclass config
mirroring the same flag names for CLI parity — this is it.  ``BiAligner``
continues to accept raw kwargs (reference API); ``AlignConfig`` is the
validated front door for programmatic users and batch front ends.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from .aligner import ENGINES, BiAligner


@dataclass
class AlignConfig:
    """All alignment parameters, named exactly like the reference CLI flags."""

    type: str = "RNA"
    sequence_match_similarity: int = 100
    sequence_mismatch_similarity: int = 0
    structure_weight: int = 400
    gap_opening_cost: int = 0
    gap_cost: int = -200
    shift_cost: int = -250
    max_shift: int = 2
    simmatrix: str | None = None
    nameA: str = "A"
    nameB: str = "B"
    outmode: str = "default"
    nodescription: bool = False
    # extensions over the reference: DP engine and torch device; the
    # low-memory band mode (checkpoint_block: diagonals per checkpoint,
    # None for sqrt(2 (n+m+1))); and the cross-device sequence-split fill
    # of the JAX package, which the port's BiAligner refuses until ported
    engine: str = "cuda"
    device: str = "cuda"
    lowmem: bool = False
    checkpoint_block: int | None = None
    seqsplit_mesh: object | None = None
    seqsplit_axis: str = "sp"

    def __post_init__(self):
        if self.type not in ("RNA", "Protein"):
            raise ValueError(
                f"type must be 'RNA' or 'Protein', got {self.type!r}"
            )
        if self.max_shift < 0:
            raise ValueError(f"max_shift must be >= 0, got {self.max_shift}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")

    @property
    def affine(self) -> bool:
        """Non-zero gap opening switches the whole engine to the affine DP
        (reference ``_affine`` property, bialignment.pyx:203-205)."""
        return int(self.gap_opening_cost) != 0

    @classmethod
    def from_params(cls, params: dict) -> "AlignConfig":
        """Build from a reference-style params dict, ignoring unknown keys."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in params.items() if k in names})

    def to_params(self) -> dict:
        """Flat dict in the shape ``BiAligner(**params)`` expects.

        Shallow copy on purpose: ``seqsplit_mesh`` may hold a live device
        mesh, which must not be deep-copied.
        """
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def aligner(self, seqA, seqB, strA=None, strB=None):
        """Construct a :class:`bialign_tpu_torch.BiAligner` from this
        config."""
        params = self.to_params()
        engine = params.pop("engine")
        device = params.pop("device")
        return BiAligner(seqA, seqB, strA, strB, engine=engine,
                         device=device, **params)
