"""Inputs and expected outputs the benchmark's tests share: upstream's
README examples and the DNA Polymerase I prefix anchor (scores of the
upstream algorithm, upstream README.md:81-152)."""

TOY_RNA = ("GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
           "...(((.....))).....", ".(((.....)))....")
TOY_RNA_AFFINE = dict(type="RNA", structure_weight=400, gap_opening_cost=-200,
                      gap_cost=-50, max_shift=1, shift_cost=-150)
TOY_RNA_AFFINE_SCORE = 6800
TOY_RNA_AFFINE_LINES = [
    "A               GCGGGGGAUAUCCCC-AUCG",
    "B               G---GGGAUAUCCCC-AUCG",
    "A ss            ...-(((.....))).....",
    "B ss            .---(((.....)))-....",
    "A shifts        ...<...........>....",
    "B shifts        ....................",
]
TOY_RNA_DEFAULTS = dict(type="RNA", structure_weight=400, gap_opening_cost=0,
                        gap_cost=-200, max_shift=2, shift_cost=-250)
TOY_RNA_DEFAULTS_SCORE = 6300
TOY_RNA_DEFAULTS_LINES = [
    "A               GCGGGGGAUAUCCCCAUCG",
    "B               --GGGGAUAUCCCC-AUCG",
    "A ss            ...(((.....))).....",
    "B ss            --.(((.....)))-....",
    "A shifts        ...................",
    "B shifts        ...................",
]

TOY_PROTEIN = ("RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR",
               "KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAYFR",
               "CHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC",
               "HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEECC")
TOY_PROTEIN_PARAMS = dict(type="Protein", shift_cost=-150,
                          structure_weight=800, simmatrix="BLOSUM62",
                          gap_opening_cost=-150, gap_cost=-50, max_shift=1)
TOY_PROTEIN_SCORE = 48500
TOY_PROTEIN_SORTED = [
    "A ss            -CHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEEC-CC",
    "A               -RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYAR-FR",
    "consensus       -.AKLPLKEKKLT.TANYHPGIRYIMTGYSAK.IYSSTYA.-FR",
    "B               -KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAY-FR",
    "B ss            -HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEE-CC",
    "consensus ss    -.HHHHHHHHHHH..CCCCTCEEEEEEECC.C.EEEEEEE.-CC",
    "",
]

# the DNA Polymerase I pair's first 150 residues, gap -200/-50, shift -210
DNAPOL_PREFIX_PARAMS = dict(type="Protein", shift_cost=-210,
                            structure_weight=800, simmatrix="BLOSUM62",
                            gap_opening_cost=-200, gap_cost=-50, max_shift=1)
DNAPOL_PREFIX_SCORE = 117180
