"""The traced sub-window's reading, on stub profiler events: busy time is
the union of device operations inside the window (the window's own
annotation on the device's timeline is not one), port kernels are counted
by name and held to the launch counters, idle gaps are named by the host
operation that overlapped them most."""
from types import SimpleNamespace

import pytest
import torch

from irli_bench import tracing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA):
    tr = SimpleNamespace(start=start, end=end,
                         elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, time_range=tr)


def events():
    return [
        ev(tracing.WINDOW, 0, 1000, CPU),
        ev(tracing.WINDOW, 10, 990),                  # the annotation
        ev("spin_kernel", -50, -10),                  # lead-in
        ev("void mega_query_kernel<signed char>", 100, 400),
        ev("void irli_topk_kernel<float>", 350, 500),
        ev("Memcpy DtoH (Device -> Pageable)", 700, 800),
        ev("cudaStreamSynchronize", 500, 700, CPU),
        ev("aten::copy_", 800, 1000, CPU),
    ]


def test_busy_is_the_union_of_device_operations():
    s = tracing.summarize(events(), 1000e-6,
                          {"mega_query": 1, "irli_topk": 1}, 0)
    assert s["busy_s"] == pytest.approx(500e-6)       # 100-500, 700-800
    assert s["kernels"]["mega_query"] == {"launches": 1,
                                          "seconds": 300e-6}
    assert tracing.WINDOW not in dict(s["device_ops"])
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)


def test_a_lost_kernel_fails_the_run():
    with pytest.raises(RuntimeError, match="lost kernels"):
        tracing.summarize(events(), 1000e-6,
                          {"mega_query": 2, "irli_topk": 1}, 0)
    tracing.summarize(events(), 1000e-6, {"mega_query": 2, "irli_topk": 1},
                      1)
