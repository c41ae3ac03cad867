"""The metric arithmetic against hand-made traces and runs: the device's busy
union and idle share, idle gaps labelled by the open span, the program's
kernels picked out of the profiler's names."""

import os

import pytest

from zkbench import harness, trace

NAMES = {"fold_kernel", "product_evals_kernel", "product_evals_any_kernel",
         "gruen_round_kernel", "row_msm_kernel"}


def _trace():
    # window 0-10 s; two proves; the device busy 1-2, 1.5-3 (overlap), 6-6.5
    return trace.Trace(
        window=(0.0, 10.0),
        device=[("void (anonymous namespace)::fold_kernel(Batch)", 1.0, 2.0),
                ("void at::native::copy_kernel", 1.5, 3.0),
                ("(anonymous namespace)::product_evals_kernel<2>(Batch)",
                 6.0, 6.5),
                ("void (anonymous namespace)::row_msm_kernel(int)", 11.0, 12.0)],
        spans=[("commitments", 0.5, 4.0), ("commit_rows", 0.8, 1.2),
               ("stage2", 4.0, 7.0)],
        proves=2)


class _Run:
    def __init__(self, tr, cell="jolt_compat.mem_t14"):
        self.trace, self.kernels = tr, NAMES
        self.cell = {"name": cell}


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    tr = _trace()
    assert trace.busy_intervals(tr) == [(1.0, 3.0), (6.0, 6.5)]
    assert trace.busy_s(tr) == pytest.approx(2.5)
    assert harness.read_metric("device_idle_pct", _Run(tr)) == \
        pytest.approx(75.0)


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    gaps = trace.idle_gaps(_trace())
    assert gaps == [("outside_spans", pytest.approx(3.5)),
                    ("stage2", pytest.approx(3.0)),
                    ("commitments", pytest.approx(1.0))]
    assert trace.span_at(_trace(), 1.0) == "commit_rows"
    assert trace.span_at(_trace(), 3.5) == "commitments"


def test_device_ops_sum_by_name_within_the_window():
    ops = dict(trace.device_ops(_trace()))
    assert ops["void at::native::copy_kernel"] == pytest.approx(1.5)
    assert "void (anonymous namespace)::row_msm_kernel(int)" not in ops


def test_only_the_programs_kernels_count_as_its_launches():
    tr = _trace()
    ev = trace.kernel_events(tr, NAMES)
    assert [k for k, _, _ in ev] == ["fold_kernel", "product_evals_kernel"]
    assert trace.kernel_of("void x::product_evals_any_kernel(A)", NAMES) \
        == "product_evals_any_kernel"
    assert trace.kernel_of("void at::native::fold_kernel_impl(A)", NAMES) \
        is None
    assert harness.read_metric("launches_per_prove", _Run(tr)) == 1.0
    assert harness.read_metric("kernel_ms_per_prove", _Run(tr)) == \
        pytest.approx(750.0)


def test_kernel_names_come_from_the_programs_sources(tmp_path):
    (tmp_path / "a.cu").write_text(
        "__global__ void __launch_bounds__(THREADS)\nfoo_kernel(int x) {}\n"
        "__global__ void\nbar_kernel(const Batch b) {}\n__device__ void baz(){}")
    assert trace.kernel_names(str(tmp_path)) == {"foo_kernel", "bar_kernel"}


def test_span_means_take_the_completed_proves_that_opened_them():
    run = harness.Run({"name": "c"})
    run.proves = [{"blob": b"x", "timings": {"stage3": 1.0, "stage4": 2.0}},
                  {"blob": b"y", "timings": {"stage3": 2.0, "stage4": 1.0}},
                  {"blob": None, "timings": {"stage3": 9.0}}]
    assert run.mean_span_s(("stage3", "stage4")) == 3.0
    assert run.mean_span_s(("batch_opening",)) is None
    assert harness.read_metric("stages3_4_s", run) == 3.0
    assert harness.read_metric("stage2_s", run) is None


def test_each_cell_reports_setup_and_another_end_to_end_and_a_layer_metric():
    bench = harness.load_bench()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], "per_layer")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(harness.ZKBENCH, "metrics",
                                           f"{m['name']}.py"))
