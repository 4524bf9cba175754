"""The trace reduction on synthetic profiler events, kernel names, and
the roofline bound's arithmetic."""
import types

import pytest

from portbench import roofline, tracing


@pytest.mark.parametrize("name, base", [
    ("refine_nn_kernel(float const*, float const*, int)", "refine_nn_kernel"),
    ("void knn_moments_kernel<8>(float const*)", "knn_moments_kernel"),
    ("void at::native::(anonymous namespace)::f<float, 4>(int)", "f"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl<at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&)"
     "::{lambda(int)#1}>(int, int)", "elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
    ("Memset (Device)", "Memset (Device)"),
])
def test_kernel_base(name, base):
    assert tracing.kernel_base(name) == base


class _E:
    def __init__(self, name, start, dur, cuda, thread=1, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._t, self._a = cuda, thread, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_summarize_busy_union_kernels_and_idle_labels():
    ev = [
        _E(tracing.WINDOW, 0, 10_000, False, annotation=True),
        _E("k1(int)", 100, 400, True), _E("k1(int)", 300, 400, True),
        _E("k2(int)", 2000, 1000, True),
        _E("gpu_user_annotation", 0, 9000, True, annotation=True),
        _E("aten::nonzero", 600, 1500, False),
        _E("cudaStreamSynchronize", 900, 1000, False),
        _E("aten::sort", 3100, 500, False, thread=2),
        _E("k3(int)", 5000, 100, True),
    ]
    s = tracing.summarize(_prof(ev), 1e-5)
    assert s.busy_s == pytest.approx((600 + 1000 + 100) / 1e9)
    assert s.kernels == {"k1": pytest.approx(800e-9),
                         "k2": pytest.approx(1e-6),
                         "k3": pytest.approx(100e-9)}
    assert s.launches == {"k1": 2, "k2": 1, "k3": 1}
    # the gap 700..2000 (mid 1350) falls in the sync inside nonzero; the
    # gap 3000..5000 in no operation of the main thread
    assert s.idle == {"cudaStreamSynchronize": pytest.approx(1300e-9),
                      "python": pytest.approx(2000e-9)}


def test_roofline_counts_work_from_sizes_only():
    opts = {"point_to_plane": True}
    sweeps = roofline.pair_sweeps(1000, 400, opts, True, False, True)
    assert [(s.layer, s.n_query, s.n_search) for s in sweeps] == [
        ("nn", 1000, 400), ("nn", 400, 1000), ("nn", 1000, 1000),
        ("knn", 400, 400)]
    assert roofline.ops_and_bytes(sweeps[0]) == (9000, 12 * 1400 + 8000)
    assert roofline.ops_and_bytes(sweeps[2]) == (9000, 12 * 1000 + 8000)
    assert roofline.ops_and_bytes(sweeps[3]) == (25 * 30 * 400,
                                                 12 * 400 + 12 * 400)
    peak = {"fp32_flops": 1e9, "bytes_per_s": 1e9}
    assert roofline.bound_seconds(sweeps, "knn", peak) == pytest.approx(
        300000 / 1e9)
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert roofline.peaks("Some Other Card") is None
