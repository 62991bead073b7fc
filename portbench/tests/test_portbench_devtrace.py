"""The traced run's reduction on a made-up profile: busy time is the union
of device operations (not the device-side copies of host ranges), kernel
times by name, idle gaps named by the innermost host range open."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import devtrace


def ev(name, a, b, dev=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=dev,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=a, end=b))


K1 = "void (anonymous namespace)::window_sweep_kernel<8, short, true>(int*)"
K2 = "void (anonymous namespace)::align_wavefront_kernel<0, int, true>(int*)"


def test_reduce_events():
    cpu = DeviceType.CPU
    events = [
        ev("portbench.job", 0, 100000, cpu),
        ev("poa.wait", 10000, 40000, cpu),
        ev("poa.wait", 10000, 40000),           # its device-side copy
        ev(K1, 0, 10000), ev(K1, 5000, 12000),  # overlapping: 12 ms busy
        ev(K2, 40000, 50000),
        ev("Memcpy HtoD (Pinned -> Device)", 50000, 50500),
        ev("align.kernel", 60000, 60100, annotation=True),
        ev(K2, 90000, 90200),
        ev(K2, 90600, 91000),                   # a gap under 1 ms
    ]
    r = devtrace.reduce_events(events, 0.2)
    assert r["window_s"] == 0.2
    assert abs(r["busy_s"] - (12000 + 10500 + 200 + 400) / 1e6) < 1e-12
    assert r["kernels"]["k1"] == (0.017, 2)
    assert r["kernels"]["k2"][1] == 3
    names = dict(r["breakdown"]["device_ops"])
    assert "void (anonymous namespace)::window_sweep_kernel<8, short, true>" \
        in names
    assert "poa.wait" not in names and "align.kernel" not in names
    idle = dict(r["breakdown"]["idle_gaps"])
    assert abs(idle["poa.wait"] - 0.028) < 1e-12      # 12 ms -> 40 ms
    assert abs(idle["portbench.job"] - 0.0395) < 1e-12  # 50.5 ms -> 90 ms
    assert abs(idle["(gaps under 1 ms)"] - 0.0004) < 1e-12


def test_short_names():
    assert devtrace.short(K1) == \
        "void (anonymous namespace)::window_sweep_kernel<8, short, true>"
    assert devtrace.short("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
