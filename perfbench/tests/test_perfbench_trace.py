"""The trace reduction on a synthetic timeline: the busy union, the idle
gaps and their labels, the attribution of kernels to convolutions, the
norm kernels, and the metric readers on the result."""
import pytest

from perfbench.lib import spec, trace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


EVENTS = [
    _ev("user_annotation", trace.WINDOW, 0.0, 100.0),
    _ev("cpu_op", "aten::convolution", 5.0, 7.0),           # 5 .. 12
    _ev("cuda_runtime", "cudaLaunchKernel", 6.0, 1.0, correlation=1),
    _ev("cpu_op", "aten::add", 13.0, 1.0),
    _ev("cuda_runtime", "cudaLaunchKernel", 13.5, 0.2, correlation=2),
    _ev("cpu_op", "de_i2i_gan_torch::modulated_instance_norm_fwd", 40.0, 5.0),
    _ev("cuda_runtime", "cudaLaunchKernel", 41.0, 1.0, correlation=3),
    _ev("cpu_op", "aten::copy_", 65.0, 30.0),
    _ev("kernel", "cudnn_conv", 10.0, 10.0, tid=7, correlation=1),   # 10 .. 20
    _ev("kernel", "add_kernel", 15.0, 15.0, tid=7, correlation=2),   # 15 .. 30
    _ev("kernel", "void modulated_instance_norm_fwd_kernel<bf16>", 50.0, 10.0,
        tid=7, correlation=3),                                         # 50 .. 60
    _ev("gpu_memset", "Memset", 70.0, 1.0, tid=7, correlation=4),
    _ev("kernel", "outside", 150.0, 5.0, tid=7, correlation=5),
]


def test_summary():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(31e-6)  # 10..30, 50..60, 70..71
    assert s["launches"] == 3
    assert s["kernel_s"] == pytest.approx(35e-6)
    assert s["non_gemm_s"] == pytest.approx(25e-6)  # the add and the norm
    assert s["norm_kernel_s"] == pytest.approx(10e-6)
    assert s["device_ops"][0] == ["add_kernel", pytest.approx(15e-6)]
    gaps = s["idle_gaps"]
    assert [g[1] for g in gaps] == [pytest.approx(v * 1e-6) for v in (29, 20, 10, 10)]
    assert gaps[0][0] == "aten::copy_"  # open at 71
    assert gaps[1][0] == "(no host op open)"  # 30


def test_readers():
    t = trace.summarize(EVENTS)
    summary = {"mode": "train", "steps": 10, "seconds": 2.0,
               "flops_per_step": 1e12, "norm_bound_s_per_step": 4e-6,
               "peak_flops_per_s": 1e15, "trace": t, "traced_steps": 2}
    want = {"step.mfu.train": 100 * 1e12 * 10 / 2.0 / 1e15,
            "model.non_gemm_ms.train": 1e3 * 25e-6 / 2,
            "kernel.norm_roofline_pct.train": 100 * 4e-6 * 2 / 10e-6,
            "host.launches_per_step.train": 1.5,
            "device.idle_pct.train": 69.0}
    for name, value in want.items():
        assert spec.metric_reader(name)(summary) == pytest.approx(value)
        # a serving run's summary has nothing for a training metric
        assert spec.metric_reader(name)(dict(summary, mode="serve")) is None
    no_norm = dict(t, norm_kernel_s=0.0)
    assert spec.metric_reader("kernel.norm_roofline_pct.train")(
        dict(summary, trace=no_norm)) is None
