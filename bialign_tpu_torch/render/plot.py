"""Graphical alignment rendering (matplotlib, host-side).

A copy of :mod:`bialign_tpu.render.plot`.

Visual-parity target: ``plot_alignment`` in the reference
(``bialignment_nonpyx.py:144-367``) — per-block rows of the four
alignment strings, secondary-structure glyphs per run (zigzag helix,
sheet arrow, thick turn line, coil line), bold / dark-red residue
identity marks, boxed shift columns, red/blue incongruence rails whose
line count tracks the running net shift, and block-edge position
numbers.

The implementation is this package's own design: a ``_Figure`` renderer
class owns all layout state (track y-positions, helix zigzag phase,
running residue offsets, net-shift accumulators) and a declarative
``SS_GLYPHS`` table maps secondary-structure classes to glyph kind and
colour.  The reference's accepted-but-misspelled ``show_inconcruence``
keyword is kept as a documented alias of ``show_incongruence``.

matplotlib is imported lazily so the compute path never depends on it.
"""

from __future__ import annotations

from dataclasses import dataclass


def breaklines(alilines, width: int):
    """Split named alignment rows into blocks of ``width`` columns
    (behavioural parity: reference nonpyx:98-114)."""
    length = len(alilines[0][1]) if alilines else 0
    return [
        [(name, row[lo:lo + width]) for name, row in alilines]
        for lo in range(0, length, width)
    ]


def runs(s: str):
    """Run-length encode a string: yields (char, start, end_exclusive)
    (behavioural parity: reference nonpyx:117-128)."""
    start = 0
    for pos in range(1, len(s) + 1):
        if pos == len(s) or s[pos] != s[start]:
            yield (s[start], start, pos)
            start = pos


def fourway_from_full(alilines):
    """Reduce the 14-row full alignment to the default 6-row view
    (rows A, B, A-strcopy, B-strcopy, A-shifts, B-shifts)."""
    return [alilines[i] for i in (1, 3, 6, 8, 12, 13)]


# Secondary-structure glyph table: class char -> (kind, colour, linewidth).
# Kinds: "helix" (zigzag), "sheet" (bar + arrowhead), "bar" (plain line).
# Gaps draw nothing; unknown classes fall back to a grey bar.
SS_GLYPHS = {
    "H": ("helix", "red", 6),
    "E": ("sheet", "green", 8),
    "T": ("bar", "blue", 8),
    "C": ("bar", "orange", 4),
    "-": (None, None, 0),
}
SS_FALLBACK = ("bar", "grey", 4)


@dataclass(frozen=True)
class _Tracks:
    """Vertical layout of one alignment block (axes coordinates).

    Values define the visual spec shared with the reference rendering;
    every consumer reads them by name from this one place.
    """

    seq_a: float = 0.2          # residue row, molecule A
    seq_b: float = 0.1          # residue row, molecule B
    str_a: float = 0.3          # structure glyph row, A
    str_b: float = 0.025        # structure glyph row, B
    shift_a: float = 0.375      # shift-string row, A
    shift_b: float = -0.075     # shift-string row, B
    glyph_lift: float = 0.025   # glyph centreline offset above its track
    zigzag: float = 0.0075      # helix zigzag amplitude
    rail_a: float = 0.405       # incongruence rail, A side
    rail_b: float = -0.0425     # incongruence rail, B side
    rail_spread: float = 0.02   # spread of stacked rail lines
    box_bottom: float = -0.022  # shift-column box bottom
    box_height: float = 0.4
    pos_a: float = 0.435        # position-number rows
    pos_b: float = -0.12
    y_min: float = -0.175       # block axes limits
    y_max: float = 0.425
    col_width: float = 0.18     # figure inches per column
    block_height: float = 2.0   # figure inches per block


class _Figure:
    """Stateful renderer for one multi-block alignment figure.

    State that must flow across blocks lives here: the helix zigzag
    phase per molecule (so a helix split by a block boundary continues
    its zigzag), the 1-based residue offsets for position numbers, and
    the running net-shift counters behind the incongruence rails.
    """

    def __init__(self, blocks, width, *, name_offset, tracks=None):
        import matplotlib.pyplot as plt

        self.t = tracks or _Tracks()
        self.width = width
        self.name_offset = name_offset
        self.blocks = blocks
        self.fig, axs = plt.subplots(
            len(blocks), 1,
            figsize=(self.t.col_width * width, self.t.block_height * len(blocks)),
        )
        self.axs = list(axs) if len(blocks) > 1 else [axs]
        plt.rc("font", family="monospace", weight="normal", size=16.0)
        self.zig_phase = {"A": self.t.zigzag, "B": self.t.zigzag}
        self.res_offset = {"A": 1, "B": 1}
        self.net_shift = {"A": 0, "B": 0}

    # -- residue rows ------------------------------------------------------

    def residues(self, ax, y, named_row, partner=None):
        """One residue row; identity vs ``partner`` drawn bold, aligned
        mismatches dark red."""
        name, seq = named_row
        ax.text(-self.name_offset, y, name)
        for x, ch in enumerate(seq):
            style = dict(weight="normal", color="black")
            if partner is not None and ch != "-" and partner[x] != "-":
                style["color"] = "darkred"
            if partner is not None and ch == partner[x]:
                style = dict(weight="bold", color="black")
            ax.text(x, y, ch, **style)

    # -- secondary-structure glyph rows ------------------------------------

    def structure(self, ax, y, named_row, mol):
        """Glyphs for one structure string; right-to-left run order so a
        helix's zigzag phase is consumed in the same column order as the
        reference rendering."""
        base = y + self.t.glyph_lift
        for ch, s, e in reversed(list(runs(named_row[1]))):
            kind, colour, lw = SS_GLYPHS.get(ch, SS_FALLBACK)
            if kind == "helix":
                self._helix(ax, s, e, base, colour, lw, mol)
            elif kind == "sheet":
                self._sheet(ax, s, e, base, colour, lw)
            elif kind == "bar":
                ax.plot([s, e], [base, base], linewidth=lw, color=colour,
                        solid_capstyle="butt")

    def _sheet(self, ax, s, e, y, colour, lw):
        if e - s > 1:
            ax.plot([s, e - 1], [y, y], linewidth=lw, color=colour,
                    solid_capstyle="butt")
        # arrowhead: matplotlib right-triangle marker at the run end
        ax.plot([e - 0.05], [y], linewidth=0, color=colour, marker=5,
                markersize=13)

    def _helix(self, ax, s, e, y, colour, lw, mol):
        phase = self.zig_phase[mol]
        xs, ys = [], []
        for x in range(e, s - 1, -1):     # right to left
            xs.append(x)
            ys.append(y + phase)
            if x > s:
                phase = -phase
        self.zig_phase[mol] = phase
        ax.plot(xs, ys, linewidth=lw, color=colour, solid_capstyle="butt",
                solid_joinstyle="round")

    # -- shift annotations --------------------------------------------------

    def shift_boxes(self, ax, shifts_a, shifts_b):
        """Outline every column where either shift string marks < or >."""
        from matplotlib.patches import Rectangle

        for x, pair in enumerate(zip(shifts_a, shifts_b)):
            if any(c in "<>" for c in pair):
                ax.add_patch(Rectangle(
                    (x, self.t.box_bottom), 1, self.t.box_height,
                    edgecolor="black", fill=False, lw=0.5,
                ))

    def incongruence(self, ax, shifts_a, shifts_b):
        """Rails counting the running net shift between shift marks.

        A segment between consecutive marks gets |net| parallel lines —
        dark red for positive net shift, dark blue for negative — on the
        A rail (above) and B rail (below).  Counters persist across
        blocks.
        """
        rows = (("A", shifts_a, self.t.rail_a), ("B", shifts_b, self.t.rail_b))
        seg_start = {"A": 0, "B": 0}
        x = -1
        for x, pair in enumerate(zip(shifts_a, shifts_b)):
            for (mol, _s, rail_y), c in zip(rows, pair):
                if c in "<>":
                    self._rail(ax, rail_y, seg_start[mol], x - 1,
                               self.net_shift[mol])
                    seg_start[mol] = x + 1
                    self.net_shift[mol] += 1 if c == ">" else -1
        for mol, _s, rail_y in rows:
            self._rail(ax, rail_y, seg_start[mol], x, self.net_shift[mol])

    def _rail(self, ax, y, s, e, net):
        if net == 0 or s > e:
            return
        colour = "darkred" if net > 0 else "darkblue"
        lanes = abs(net)
        for lane in range(lanes):
            off = 0.0
            if lanes > 1:
                off = (lane / (lanes - 1) - 0.5) * self.t.rail_spread
            ax.plot([s, e + 1], [y + off, y + off], linewidth=1,
                    color=colour, solid_capstyle="butt")

    # -- block assembly -----------------------------------------------------

    def position_numbers(self, ax, block):
        ncols = len(block[0][1])
        for mol, named_row, y in (
            ("A", block[0], self.t.pos_a), ("B", block[1], self.t.pos_b)
        ):
            first = self.res_offset[mol]
            self.res_offset[mol] += len(named_row[1]) - named_row[1].count("-")
            ax.text(0, y, first, fontsize=10)
            ax.text(ncols, y, self.res_offset[mol] - 1, fontsize=10,
                    ha="right")

    def render(self, *, show_position_numbers, show_structure_strings,
               show_incongruence):
        for ax, block in zip(self.axs, self.blocks):
            ax.set_xlim(-0.5, self.width + 0.5)
            ax.set_ylim(self.t.y_min, self.t.y_max)
            ax.axis("off")

            if show_position_numbers:
                self.position_numbers(ax, block)

            self.residues(ax, self.t.seq_a, block[0], block[1][1])
            self.residues(ax, self.t.seq_b, block[1], block[0][1])
            self.structure(ax, self.t.str_a, block[2], "A")
            self.structure(ax, self.t.str_b, block[3], "B")
            if show_structure_strings:
                self.residues(ax, self.t.str_a, ("", block[2][1]))
                self.residues(ax, self.t.str_b - self.t.glyph_lift,
                              ("", block[3][1]))

            if len(block) > 4:   # shift rows present
                sa, sb = block[4][1], block[5][1]
                self.residues(ax, self.t.shift_a, ("", sa.replace(".", " ")))
                self.residues(ax, self.t.shift_b, ("", sb.replace(".", " ")))
                self.shift_boxes(ax, sa, sb)
                if show_incongruence:
                    self.incongruence(ax, sa, sb)
        return self.fig


def plot_alignment(
    alilines,
    width,
    *,
    show_structure_strings=False,
    name_offset=12,
    show_position_numbers=True,
    show_incongruence=True,
    outname=None,
    **legacy,
):
    """Plot a bi-alignment; optionally write to ``outname``.

    ``alilines``: named alignment rows; a full 14-row alignment is
    reduced to the default 6-row view first.  ``show_inconcruence`` (the
    reference API's spelling, nonpyx:151) is accepted as an alias of
    ``show_incongruence``.
    """
    import matplotlib.pyplot as plt

    if "show_inconcruence" in legacy:
        show_incongruence = legacy.pop("show_inconcruence")
    if legacy:
        raise TypeError(f"unexpected keyword arguments: {sorted(legacy)}")

    if len(alilines) >= 13:
        alilines = fourway_from_full(alilines)

    fig = _Figure(
        breaklines(alilines, width), width, name_offset=name_offset,
    ).render(
        show_position_numbers=show_position_numbers,
        show_structure_strings=show_structure_strings,
        show_incongruence=show_incongruence,
    )
    if outname is not None:
        plt.savefig(outname)
    plt.show()
    return fig
