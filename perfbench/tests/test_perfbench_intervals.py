"""The timeline's interval arithmetic, on synthetic traces."""
from perfbench.trace import DeviceOp, Timeline, length, minus, union


def test_union_merges_overlaps_and_touching():
    assert union([(5, 9), (0, 3), (2, 4), (9, 10), (12, 12)]) == [(0, 4),
                                                                  (5, 10)]


def test_minus():
    a = [(0, 10), (20, 30)]
    b = [(2, 4), (8, 22), (25, 26)]
    assert minus(a, b) == [(0, 2), (4, 8), (22, 25), (26, 30)]
    assert minus(a, []) == a
    assert minus(a, [(0, 40)]) == []


def _overlapping() -> Timeline:
    """A 100 ns window: kernels on one stream busy 0-60, copies on another
    busy 0-90 (overlapping the kernels for 60 ns); their summed durations
    (150 ns) exceed the window, so ``1 - sum / wall`` would read 0."""
    ops = [DeviceOp("gemm_a", 0, 30, "gemm"),
           DeviceOp("elem", 30, 60, "elementwise"),
           DeviceOp("Memcpy HtoD (Pinned -> Device)", 0, 50, "copy_h2d"),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", 40, 90, "copy_d2h"),
           ]
    host = [("aten::copy_", 80, 100), ("cudaStreamSynchronize", 85, 99),
            ("cudaLaunchKernel", 10, 12)]
    return Timeline(0, 100, ops, host, 1)


def test_idle_share_is_a_union():
    from perfbench.metrics import idle_share
    tl = _overlapping()
    assert sum(o.end - o.start for o in tl.ops) >= tl.end - tl.start
    assert length(tl.busy()) == 90
    assert abs(idle_share.read(tl, None) - 10.0) < 1e-12


def test_copy_exposed_share():
    from perfbench.metrics import copy_exposed_share
    tl = _overlapping()
    assert tl.copy_only() == [(60, 90)]
    assert abs(copy_exposed_share.read(tl, None) - 30.0) < 1e-12


def test_no_copies_reads_nothing():
    from perfbench.metrics import copy_exposed_share
    tl = Timeline(0, 10, [DeviceOp("k", 0, 5, "gemm")], [], 1)
    assert copy_exposed_share.read(tl, None) is None


def test_elementwise_share_leaves_copies_out():
    from perfbench.metrics import elementwise_share
    assert abs(elementwise_share.read(_overlapping(), None) - 50.0) < 1e-12


def test_breakdown_names_gaps_by_host_range():
    got = _overlapping().breakdown()
    assert got["idle_gaps"] == [["cudaStreamSynchronize", 10 / 1e9]]
    assert got["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", 50 / 1e9]


def test_breakdown_takes_the_innermost_open_range():
    ops = [DeviceOp("k", 0, 10, "gemm"), DeviceOp("k", 20, 30, "gemm"),
           DeviceOp("k", 40, 50, "gemm")]
    host = [("step", 0, 60), ("aten::mm", 11, 19), ("cudaFree", 33, 38),
            ("late", 45, 70)]
    got = dict(Timeline(0, 60, ops, host, 1).breakdown()["idle_gaps"])
    # gaps 10-20 (aten::mm), 30-40 (cudaFree), 50-60 (late, inside step)
    assert got == {"aten::mm": 10e-9, "cudaFree": 10e-9, "late": 10e-9}
