"""CPU tests of the reader of ``terms.walked_pct``: on a fake ``Run``
whose span sub-window is made by hand, with the program's count of the
walked leaf slots, without it (a program that records the other counts
only) and with no sub-window at all (a program without the trace)."""

from __future__ import annotations

import pytest

from odobench.loader import Loader
from test_spans import fake_run, fake_window


def read(summary):
    return Loader().reader("terms.walked_pct")(fake_run(summary))


def test_the_reader_reads_the_walked_slots():
    summ = fake_window()
    c0, c1 = summ["drained"]["counters"]
    c0.update(terms_walked=[16 * 59000], terms_slots=[16 * 131072])
    c1.update(terms_walked=[16 * 28000], terms_slots=[16 * 131072])
    assert read(summ) == pytest.approx(100.0 * (59000 + 28000) / 2 / 131072)
    for c in (c0, c1):  # a batch of two sequences
        c.update(terms_walked=c["terms_walked"] * 2, terms_slots=[0, 4 * 100])
    assert read(summ) == pytest.approx(100.0 * (16 * 59000 + 16 * 28000) / 2 / 400)


def test_the_reader_is_null_without_the_count():
    assert read(fake_window()) is None  # the counters without terms_walked
    assert read(None) is None  # no sub-window: a program without the trace


def test_the_metric_is_declared_for_every_cell():
    b = Loader().benchmark()
    entry, = (m for m in b["per_layer"] if m["name"] == "terms.walked_pct")
    assert entry["layer"] == "step: terms+solve" and entry["source"] == "program_counter"
    assert entry["moves"] == "scans_per_s" and entry["better"] == "lower"
    assert entry["workloads"] == [w["name"] for w in b["workloads"]]
