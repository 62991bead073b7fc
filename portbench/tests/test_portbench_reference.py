"""The plain reference on tiny inputs: the edit distance against a plain
DP, the breaking points' excess, and the window consensus against the
port's host and device engines (the only place it meets the program)."""

import random

import numpy as np
import pytest

from portbench import reference as R


def dp_distance(a: bytes, b: bytes) -> int:
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[-1]


def rand(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


@pytest.mark.parametrize("n", [0, 1, 5, 63, 64, 65, 200])
def test_nw_distance(n):
    rng = random.Random(n)
    for _ in range(20):
        a, b = rand(rng, n), rand(rng, rng.randrange(0, n + 8))
        assert R.nw_distance(a, b) == dp_distance(a, b)


def test_breaking_point_excess():
    rng = random.Random(1)
    t = rand(rng, 300)
    q = bytearray(t)
    del q[50:53]
    q[100] = ord("A") if q[100] != ord("A") else ord("C")
    q = bytes(q)
    # points on the alignment that keeps every matching base in place
    on = [(10, 10), (40, 40), (120, 117), (250, 247)]
    assert R.breaking_point_excess(q, t, on) == 0
    off = [(10, 10), (40, 40), (120, 119), (250, 247)]
    assert R.breaking_point_excess(q, t, off) > 0


def window(seed):
    rng = random.Random(seed)
    backbone = rand(rng, 120)
    layers = []
    for k in range(6):
        lo = rng.choice([0, 0, 10, 30])
        hi = rng.choice([119, 119, 90, 100])
        seg = bytearray(backbone[lo:hi + 1])
        for _ in range(8):
            p = rng.randrange(len(seg))
            seg[p] = rng.choice(b"ACGT")
        del seg[rng.randrange(len(seg))]
        layers.append((bytes(seg), None, lo, hi))
    return backbone, layers


@pytest.mark.parametrize("device_batches", [0, 1])
@pytest.mark.parametrize("seed", range(6))
def test_polish_window_engines(seed, device_batches):
    """device_batches 0: the host engine; 1: the session engine over K1's
    plain version."""
    from racon_tpu_torch.core.window import Window, WindowType
    from racon_tpu_torch.ops.poa import BatchPOA

    backbone, layers = window(seed)
    w = Window(0, 0, WindowType.kTGS, backbone, b"!" * len(backbone))
    for s, q, b, e in layers:
        w.add_layer(s, q, b, e)
    BatchPOA(3, -5, -4, 120, device_batches=device_batches,
             device="cpu").generate_consensus([w], True)
    assert R.polish_window(backbone, b"!" * len(backbone), layers,
                           3, -5, -4) == w.consensus


def test_control_differs():
    backbone, layers = window(0)
    full = R.polish_window(backbone, b"!" * 120, layers, 3, -5, -4)
    assert R.polish_window(backbone, b"!" * 120, layers, 3, -5, -4,
                           narrow=8) != full


def test_few_layers_keep_backbone():
    backbone, layers = window(1)
    assert R.polish_window(backbone, None, layers[:1], 3, -5, -4) == backbone


def test_graph_cycle_refused():
    g = R.Graph()
    g.add_alignment([], np.array([0, 1], dtype=np.uint8), [1, 1])
    g.add_edge(1, 0, 1)
    with pytest.raises(ValueError):
        g.topo_order()


def test_draw_takes_every_path():
    from portbench.check import draw

    labels = [()] * 40 + [("host",)] + [("k1 a",), ("k1 a", "k1 b")] * 3
    for seed in range(20):
        got = draw(random.Random(seed), labels, 6, first=0)
        assert got[0] == 0 and len(got) == len(set(got)) == 6
        have = set().union(*(labels[i] for i in got))
        assert have == {"host", "k1 a", "k1 b"}
    assert draw(random.Random(1), labels, 6, 0) == \
        draw(random.Random(1), labels, 6, 0)


def test_reference_pool_agrees_with_one_process():
    from portbench.check import _map, _overlap_task

    rng = random.Random(3)
    tasks = []
    for n in (50, 120, 300):
        t = rand(rng, n)
        q = bytes(c for c in t if rng.random() > 0.1)
        tasks.append((q, t, [(n // 2, len(q) // 2), (n // 2, len(q) // 2)],
                      n + len(q)))
    assert _map(_overlap_task, tasks, 2) == _map(_overlap_task, tasks, 0)
