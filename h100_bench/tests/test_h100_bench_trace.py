"""The device's busy time (the result's `busy_s`) as the union of its
operation intervals, on synthetic overlapping intervals."""
from h100_bench import registry
from h100_bench.harness import Run
from h100_bench.trace import Trace, gaps, union


def test_union_merges_overlaps_once():
    assert union([(0, 10), (5, 15), (20, 30), (30, 31), (40, 40)]) == [(0, 15), (20, 31)]
    assert union([(5, 6), (0, 10)]) == [(0, 10)]
    assert gaps([(2, 4), (6, 8)], 0, 10) == [(0, 2), (4, 6), (8, 10)]


def test_busy_time_counts_overlapping_kernels_once():
    ops = [("kernel", "a", 100, 200), ("kernel", "b", 150, 250), ("kernel", "c", 150, 180),
           ("gpu_memcpy", "Memcpy HtoD", 300, 350), ("kernel", "late", 990, 1100)]
    t = Trace(steps=2, window=(100, 1000), ops=ops, host=[("cudaGraphLaunch", 240, 320), ("python", 0, 2000)])
    # summed kernel times would read 100 + 100 + 30 + 50 + 10 = 290; the union is 150 + 50 + 10 = 210
    assert t.busy_ns() == 210
    run = Run({}, {}, 1, 2, 2, [], trace=t)
    assert registry.metric_reader("kernels_per_step.enc")(run) == 2.0  # 4 kernels start inside the window
    first = t.idle_gaps()[0]
    assert first == ["python", 640e-9]  # 350 .. 990
    assert ["cudaGraphLaunch", 50e-9] in t.idle_gaps()
    assert t.top_ops()[0] == ["b", 100e-9] or t.top_ops()[0] == ["a", 100e-9]


def test_rooflines_from_trace():
    cfg = registry.config("gmix-ref")
    ops = [("kernel", "void gmix::fused_substeps_kernel<4, true, false>(gmix::Dims, FusedIO)", 0, 90_000),
           ("kernel", "gather_rows_many_kernel", 90_000, 93_000), ("kernel", "scatter_rows_many_kernel", 93_000, 95_000)]
    t = Trace(steps=1, window=(0, 100_000), ops=ops)
    run = Run(cfg, {}, 54, 2000, 108000, [], peaks=registry.peaks("NVIDIA H100 80GB HBM3"), trace=t)
    c = cfg["counts_per_stream"]
    fused = registry.metric_reader("fused_roofline.enc")(run)
    want = 100 * max((c["fused"]["bytes"] * 54 + c["fused"]["bytes_const"]) / 3.35e12,
                     c["fused"]["float_ops"] * 54 / 67e12) / 90e-6
    assert abs(fused - want) < 1e-9 and 0 < fused < 100
    movers = registry.metric_reader("movers_roofline.enc")(run)
    assert abs(movers - 100 * c["movers"]["bytes"] * 54 / 3.35e12 / 5e-6) < 1e-9
