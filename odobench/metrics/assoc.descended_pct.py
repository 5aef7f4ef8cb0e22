"""The share (%) of the certified rounds' (keyframe, leaf) entries that
descend: 100 x the step's descents over (rounds x valid keyframes x
valid leaves), the mean over every sequence-scan of the span sub-window
(``spans.py``; the program's counts, read with its stamps)."""

from odobench import spans


def read(run):
    return spans.descended_pct(spans.summary(run))
