"""The metric arithmetic: percentiles with their sample counts, spreads,
the union of device intervals over overlapping streams and a trace's idle
gaps named by the host."""

import pytest

from fusion_bench.arith import gaps, percentile, spread, union_length
from fusion_bench.tracefile import Trace


def test_p99_and_samples_beyond():
    vals = list(range(1, 1001))           # 1..1000
    v, beyond = percentile(vals, 99)
    assert v == 990 and beyond == 10
    v, beyond = percentile([5.0] * 50 + [20.0], 99)
    assert v == 20.0 and beyond == 0


def test_spread_is_iqr_over_median():
    assert spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_union_counts_overlap_once():
    # two streams: [0, 10) and [5, 12) overlap, [20, 25) apart
    assert union_length([(0, 10), (20, 25), (5, 12)]) == 17
    assert union_length([]) == 0
    assert gaps([(0, 10), (5, 12), (20, 25)], 0, 30) == [(12, 20), (25, 30)]


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_trace_idle_share_over_two_streams_and_gap_names():
    events = [_ev("kernel", "k1", 0, 40), _ev("kernel", "k2", 20, 40),     # overlap
              _ev("gpu_memcpy", "copy", 70, 10),
              _ev("cuda_runtime", "cudaStreamSynchronize", 55, 20),
              _ev("cuda_runtime", "cudaLaunchKernel", 82, 5),
              _ev("kernel", "k1", 90, 10)]
    tr = Trace(events)
    assert tr.busy_s == pytest.approx(80e-6)
    assert 1 - tr.busy_s / tr.window_s == pytest.approx(0.2)
    idle = dict(tr.idle_by_host())
    assert idle["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(10e-6)
    top = tr.top_device_ops()
    assert top[0] == ["k1", pytest.approx(50e-6)]


def test_rows_pair_by_box_key():
    """One box missing from a cloud pairs the rest by key, not by position."""
    import torch

    from fusion_bench.check import align_rows, frontend_numbers

    ref_keys = torch.tensor([3, 5, 8, 9, -1])
    got_keys = torch.tensor([3, 8, 9, 11, -1])       # 5 missing, 11 extra
    ia, ib, mism = align_rows(got_keys, ref_keys)
    assert ia.tolist() == [0, 1, 2] and ib.tolist() == [0, 2, 3] and mism == 2
    pts = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    ref = (pts, torch.zeros(5, 3), ref_keys >= 0)
    got = (pts[[0, 2, 3, 4, 4]], torch.zeros(5, 3), got_keys >= 0)
    out = frontend_numbers(got, ref, keys=(got_keys, ref_keys))
    assert out["frontend_point_gap"] == 0.0 and out["frontend_row_mismatch"] == 2.0
    # by position the same clouds read the shift of every later row
    assert frontend_numbers(got, ref)["frontend_point_gap"] > 0


def test_trace_keeps_streams_and_reads_their_overlap():
    """The loop's stream 7 runs 0-40 and 60-100 us, a worker's stream 20 runs
    30-70 us: 20 of the worker's 40 us overlap the loop's work; busy time
    stays the union over both streams."""
    def kernel(ts, dur, stream):
        return dict(_ev("kernel", "k", ts, dur), tid=stream, args={"stream": stream})

    tr = Trace([kernel(0, 40, 7), kernel(60, 40, 7), kernel(30, 40, 20),
                _ev("cuda_runtime", "cudaLaunchKernel", 0, 2)])
    assert tr.streams == [7, 7, 20] and tr.first_stream == 7
    assert tr.overlap_share(7) == pytest.approx(0.5)
    assert tr.overlap_share(20) == pytest.approx(20 / 80)
    assert tr.busy_s == pytest.approx(100e-6)
    assert Trace([kernel(0, 40, 7)]).overlap_share(7) is None
