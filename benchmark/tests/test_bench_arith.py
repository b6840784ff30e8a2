"""The benchmark's arithmetic on made-up inputs: the rate, the streams'
size, the union of device intervals, the aggregate roofline and the
trace's summary."""

import pytest

from benchmark import spec, yardstick
from benchmark.devtrace import MARK_NAME, DeviceTrace
from benchmark.record import Record, share_pct


def read(name, run):
    return spec.reader(name).read(run)


def test_rate_is_all_bytes_over_all_time():
    run = Record(t_start=0.0, window=(10.0, 40.0), pcm_bytes=3_000_000_000)
    assert read("encode_MBps", run) == pytest.approx(100.0)
    assert read("setup_s", run) == pytest.approx(10.0)
    assert read("encode_MBps", Record(t_start=0.0, window=(1.0, 2.0))) is None


def test_size_is_all_stream_bytes_over_all_pcm_bytes():
    run = Record(t_start=0.0, window=(10.0, 40.0), pcm_bytes=3_000_000_000, stream_bytes=1_650_000_000)
    assert read("encoded_size_pct", run) == pytest.approx(55.0)
    assert read("encoded_size_pct", Record(t_start=0.0, window=(1.0, 2.0))) is None


def test_union_and_span_shares():
    assert yardstick.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert yardstick.union_s([]) == 0.0
    assert share_pct([(0, 2), (1, 3), (9, 12)], (1.0, 11.0)) == pytest.approx(100 * 4 / 10)
    run = Record(t_start=0.0, window=(0.0, 10.0), spans={"wave": [(1, 4), (3, 6)], "finish": [(6, 7)]})
    assert read("pool.wave_pct", run) == pytest.approx(50.0)
    assert read("pool.finish_pct", run) == pytest.approx(10.0)


def test_least_time_is_the_function_s():
    # (2816, 16384) codes: 184.5 MB read, bytes-bound
    nbytes, ops = yardstick.work("k_cost_sums", 2816, 16384, 256)
    assert nbytes == 4 * 2816 * 16384 + 2 * 4 * 17 * 2816 and ops == 35 * 2816 * 16384
    assert yardstick.least_s("k_cost_sums", 2816, 16384, 256) == pytest.approx(nbytes / 3.35e12)
    # kernel 10 at (256, 16384), orders 1..8: 17 operations a sample and order bound it
    assert yardstick.least_s("partition_cost_sums", 256, 16384, 8) == pytest.approx(
        17 * 256 * 16384 * 8 / (132 * 128 * 1.98e9))
    assert yardstick.least_s("k_after_stateful_fused", 2816, 16384) == pytest.approx(8 * 2816 * 16384 / 3.35e12)
    assert yardstick.least_s("no_such_kernel", 1, 1) is None
    assert yardstick.kernel_of("void row_scan_long<SplitAddU32, false, true>(...)") == "split_cumsums_u32"
    assert yardstick.kernel_of("void row_scan_warp<AddU32, false>(...)") == "cumsum_u32"
    assert yardstick.kernel_of("ampere_sgemm") is None


def test_roofline_is_one_share_over_the_window():
    trace = {"kernel_device_s": 0.004, "busy_s": 0.5, "window_s": 2.0}
    run = Record(t_start=0.0, window=(0.0, 2.0), least_s=0.003, trace=trace, pcm_bytes=10**9)
    assert read("kernels_roofline", run) == pytest.approx(75.0)
    assert read("device.busy_ms_per_GB", run) == pytest.approx(500.0)
    assert read("device.idle_pct.batch", run) == pytest.approx(75.0)
    assert read("kernels_roofline", Record(t_start=0.0, window=(0.0, 1.0), least_s=1.0)) is None


def test_trace_summary_on_made_up_events():
    tr = DeviceTrace([0])
    tr.host0 = 100.0  # host clock of the first marker's launch; the device clock runs 50 s ahead
    tr.events = [
        (MARK_NAME, 0, 150.0, 150.001),
        ("void k_after_kernel(...)", 0, 150.010, 150.110),
        ("void mode_cost_rows(...)", 0, 150.100, 150.200),
        ("Memcpy HtoD (Pinned -> Device)", 0, 150.500, 150.600),
        (MARK_NAME, 0, 151.001, 151.002),
    ]
    s = tr.summary([("finish", [(100.2, 100.45)]), ("wave", [(100.0, 101.0)])])
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.29)
    assert s["kernel_device_s"] == pytest.approx(0.2)
    assert dict(s["device_ops"])["k_after_stateful_fused"] == pytest.approx(0.1)
    gaps = s["idle_gaps"]
    assert gaps[0][0] == "wave" and gaps[0][1] == pytest.approx(0.401)
    assert gaps[1][0] == "finish" and gaps[1][1] == pytest.approx(0.3)
