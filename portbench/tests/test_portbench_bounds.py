"""The yardstick: the stage bounds, the sampler and the reduction of a
profiler timeline to busy time, idle share and gaps."""

import json

import numpy as np
import pytest

from portbench import bounds, harness, timeline

UHD = {"width": 3840, "height": 2160, "batch": 1, "quality": 90,
       "subsampling": "420"}


def test_pixel_bound_at_4k_420_q90():
    """4.74 GFLOP of the factored operator over 67 TFLOP/s: 0.070750 ms,
    the bound the port's kernel table gives its pixel kernels."""
    m, _ = bounds.tables.mcu_operator(90, "420")
    flops = 2.0 * 32400 * bounds.operator_fmas(m, "420")
    assert round(flops / 1e9, 2) == 4.74
    assert round(bounds.pixel_bound_s(UHD) * 1e3, 6) == 0.070750


def test_pixel_bound_scales_with_the_batch():
    fhd = dict(UHD, width=1920, height=1080, batch=8)
    # 8 x 68 x 120 MCUs (the last MCU row padded) against 135 x 240.
    assert bounds.pixel_bound_s(fhd) == pytest.approx(
        bounds.pixel_bound_s(UHD) * 8 * 68 * 120 / 32400)


def test_entropy_bound_counts_each_byte_once():
    scan = 3_000_000
    want = (32400 * 384 * 4 + bounds.LUT_BYTES + scan + 8) / 3.35e12
    assert bounds.entropy_bound_s(UHD, scan) == pytest.approx(want)


def test_reservoir_is_seeded_and_uniform():
    def draw(seed, n=1000):
        r = harness.Reservoir(8, seed)
        for i in range(n):
            r.offer(i, i)
        return sorted(r.items)
    assert draw(5) == draw(5) and draw(5) != draw(6)
    hits = np.zeros(10)
    for seed in range(400):
        for i in draw(seed, 100):
            hits[i // 10] += 1
    assert hits.min() > 0.7 * hits.mean()      # each decile about 320


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return timeline.parse(str(path), calls=2)


def test_timeline_union_idle_and_gaps(tmp_path):
    host = {"ph": "X", "tid": 1, "pid": 1}
    dev = {"ph": "X", "tid": 7, "pid": 0}
    sl = _trace(tmp_path, [
        dict(host, cat="user_annotation", name=timeline.SLICE, ts=0,
             dur=100),
        dict(host, cat="cpu_op", name="aten::copy_", ts=0, dur=30),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=50,
             dur=10),
        dict(host, cat="cpu_op", name="aten::empty", ts=80, dur=15),
        dict(dev, cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> Device)",
             ts=10, dur=20),
        dict(dev, cat="kernel", name="void (anonymous namespace)::"
             "pixel_mma_kernel<16>(unsigned char const*)", ts=40, dur=25),
        dict(dev, cat="kernel", name="other_kernel", ts=55, dur=10),
        dict(dev, cat="gpu_memset", name="Memset (Device)", ts=120, dur=5),
        dict(dev, cat="gpu_user_annotation", name=timeline.SLICE, ts=0,
             dur=100),
    ])
    assert len(sl.device) == 3                   # the memset is outside
    assert sl.window_s == pytest.approx(100e-6)
    assert sl.busy_s() == pytest.approx(45e-6)   # 10-30, 40-65
    assert sl.busy_s(sl.ops_of("pixel_mma")) == pytest.approx(25e-6)
    assert sl.device_ops_top()[:2] == [
        ["pixel_mma_kernel<16>", pytest.approx(25e-6)],
        ["Memcpy HtoD (Pageable -> Device)", pytest.approx(20e-6)]]
    gaps = dict(sl.idle_gaps_top())
    # 0-10 under aten::copy_, 30-40 under none, 65-100: aten::empty at
    # its middle (82.5).
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["host: untraced"] == pytest.approx(10e-6)
    assert gaps["aten::empty"] == pytest.approx(35e-6)


def _staged_run(tmp_path):
    dev = {"ph": "X", "tid": 7, "pid": 0, "cat": "kernel"}
    sl = _trace(tmp_path, [
        {"ph": "X", "tid": 1, "pid": 1, "cat": "user_annotation",
         "name": timeline.SLICE, "ts": 0, "dur": 100},
        dict(dev, name="void at::native::_scatter_gather_elementwise_kernel"
             "<128, 8>(int)", ts=0, dur=10),
        dict(dev, name="void pixel_mma_kernel<16>(int)", ts=10, dur=20),
        dict(dev, name="void block_pack_mcu_kernel<true, 6>(int)", ts=30,
             dur=10),
        dict(dev, name="void renamed_kernel(int)", ts=40, dur=7)])
    return harness.Run("uhd_420_q90.device_ring", {}, {}, harness.Bench(),
                       trace=sl)


def test_unstaged_ops_are_the_ones_no_stage_names(tmp_path):
    """Device time that no stage file claims is read apart: torch glue,
    such as a padding gather, and a kernel no file names are nobody's."""
    run = _staged_run(tmp_path)
    assert run.trace.busy_s(run.stage_ops("pixel")) == pytest.approx(20e-6)
    assert [op.name for op in run.unstaged_ops()] == [
        "void at::native::_scatter_gather_elementwise_kernel<128, 8>(int)",
        "void renamed_kernel(int)"]
    assert run.bench.reader("unstaged_ms.device")(run) == pytest.approx(
        17e-3 / 2)


def test_idle_share_is_at_the_untraced_pace(tmp_path):
    """The slice's busy time per call (47 us over 2 calls) against the
    pace of the window before it (1000 calls in 0.1 s): 23.5% busy."""
    run = _staged_run(tmp_path)
    read = run.bench.reader("idle_share.device")
    assert read(run) is None                     # no untraced lead
    run.lead = (1000, 0.1)
    assert read(run) == pytest.approx(1 - 23.5e-6 * 1000 / 0.1)
