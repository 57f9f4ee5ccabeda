"""The yardstick's arithmetic: the bounds, the percentile, the union of the
device's intervals and the labels of its gaps."""

import pytest

from portbench import bounds, devtrace, harness


def test_dp_bound_dnapol():
    # one pair's band fill, DNA Polymerase I at max_shift 1: bytes bound it
    # (two tables, 1,862 slabs of 9 states x 9 shifts x 929 rows, int32)
    n, m = 928, 933
    cells = (n + 1) * (m + 1)
    nbytes = 2 * cells * 4 + (n + m + 1) * 9 * 9 * (n + 1) * 4
    ops = cells * 9 * 9 * 15 * 2
    want = max(nbytes / 3.35e12, ops / (132 * 64 * 1.98e9))
    assert want == nbytes / 3.35e12
    assert bounds.dp_bound(n, m, 1, 15, 9, band=True) == pytest.approx(want)
    assert bounds.dp_bound(n, m, 1, 15, 9, band=True) * 1e3 == \
        pytest.approx(0.169, abs=5e-4)


def test_batch_and_band_bounds_add_pairs():
    one = bounds.batch_bound([(100, 90)], 1, 15, 9)
    assert bounds.batch_bound([(100, 90)] * 3, 1, 15, 9) == \
        pytest.approx(3 * one)
    assert bounds.band_bound([(100, 90)], 1, 15, 9) >= one
    assert bounds.walk_bound(1000, 15) == pytest.approx(
        max(1000 * (18 * 4 + 4) / 3.35e12, 1000 * 30 / bounds.
            PEAK_INT32_OPS_PER_S))


def test_percentile_reader(tmp_path):
    read = harness.reader(harness.ROOT, "pair_ms_p95.host")

    class R:
        request_s = [k / 1000 for k in range(1, 101)]     # 1..100 ms
    # linear between ranks: 95.05 ms
    assert read(R) == pytest.approx(95.05)
    R.request_s = []
    assert read(R) is None


def test_union_and_gaps():
    covered, gaps = devtrace.union([(10, 20), (15, 30), (40, 50), (0, 5)],
                                   0, 60)
    assert covered == 5 + 20 + 10
    assert gaps == [(5, 10), (30, 40), (50, 60)]
    covered, gaps = devtrace.union([(-10, 5), (55, 70)], 0, 60)
    assert covered == 10 and gaps == [(5, 55)]


def test_gap_labels_innermost_span():
    spans = [(0, 100, "pb.stream"), (20, 40, "pb.decode"), (25, 30, "pb.x")]
    assert devtrace.label_at(spans, 10) == "pb.stream"
    assert devtrace.label_at(spans, 22) == "pb.decode"
    assert devtrace.label_at(spans, 27) == "pb.x"
    assert devtrace.label_at(spans, 100) == devtrace.SLICE


class _Ev:
    def __init__(self, name, a, b, dev):
        self.v = (name, a, b, dev)


def test_reduce_leaves_out_annotations(monkeypatch):
    monkeypatch.setattr(devtrace, "_fields", lambda ev: ev.v)
    evs = [_Ev("pb.slice", 0, 1000, False), _Ev("pb.slice", 0, 1000, True),
           _Ev("pb.fill", 100, 400, False), _Ev("pb.fill", 100, 400, True),
           _Ev("kern", 200, 300, True), _Ev("kern", 350, 450, True),
           _Ev("Memcpy HtoD", 600, 700, True)]
    t = devtrace.reduce(evs)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(300e-9)
    assert t.ops == {"kern": pytest.approx(200e-9),
                     "Memcpy HtoD": pytest.approx(100e-9)}
    # gaps 700-1000, 0-200 (the middle in pb.fill), 450-600, 300-350
    assert t.gaps == [("pb.slice", pytest.approx(300e-9)),
                      ("pb.fill", pytest.approx(200e-9)),
                      ("pb.slice", pytest.approx(150e-9)),
                      ("pb.fill", pytest.approx(50e-9))]


@pytest.mark.parametrize("name", ["fill_roofline.pair",
                                  "bucket_roofline.scores",
                                  "band_roofline.align", "device_idle.pair"])
def test_trace_readers_silent_without_trace(name):
    cell = harness.Cell("x", {"params": {"gap_opening_cost": -1,
                                         "max_shift": 1}}, {}, [], [])
    run = harness.Run(cell=cell)
    assert harness.reader(harness.ROOT, name)(run) is None
    run.trace = devtrace.Trace(window_s=1.0)
    run.traced_pairs = [(10, 10)]
    assert harness.reader(harness.ROOT, name)(run) is None


@pytest.mark.parametrize("name, file", [
    ("device_idle.scores", "device_idle"), ("device_idle.align", "device_idle"),
    ("dispatch_share.align", "dispatch_share"),
    ("fill_ms.pair", "fill_ms.pair")])
def test_reader_falls_back_to_the_name_before_the_group(name, file):
    from portbench import generator

    want = generator.load_file(harness.ROOT, "metrics", file).read
    assert harness.reader(harness.ROOT, name).__code__.co_code == \
        want.__code__.co_code


def test_reader_of_no_file_raises():
    with pytest.raises(FileNotFoundError):
        harness.reader(harness.ROOT, "no_such_metric.pair")
