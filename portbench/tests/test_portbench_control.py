"""The check refuses what it has to refuse, at a tiny size on the CPU:
the control (the reference in 8-bit cells put in the program's place) and
each fault a cell can have, planted where the program produces it. One
chip, so no exchange between chips can be left out."""

import pytest

from portbench.tests import tiny


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("pb"))


def failed(result) -> set:
    return {n for n, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads", "tiny.serve"])
def test_sound_runs_pass(base, cell):
    for seed in (11, 12):
        result, _ = tiny.run(base, cell, seed=seed, seconds=1.0)
        assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads", "tiny.serve"])
def test_control_fails(base, cell):
    result, _ = tiny.run(base, cell, seconds=1.0, control="int8")
    assert not result["correct"]
    assert "window_mismatch" in failed(result)


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "window_mismatch"),   # a step returns its state unchanged
    ("half", "window_mismatch"),        # half of each batch left out
    ("altered", "window_mismatch"),     # an answer altered where produced
    ("layers_half", "layer_mismatch"),  # half of each window's layers out
    ("bp_shift", "bp_excess"),          # the alignment's answer altered
    ("stitch_altered", "stitch_mismatch"),  # the returned bytes altered
])
@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads", "tiny.serve"])
def test_faults_fail(base, cell, fault, number):
    result, _ = tiny.run(base, cell, seconds=1.0, fault=fault)
    assert not result["correct"]
    assert number in failed(result)


@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads", "tiny.serve"])
def test_device_engines_pass(tmp_path, cell):
    """The kernels' plain versions on the CPU (the device path's
    arithmetic) held to the reference."""
    base = tiny.copy(tmp_path, device_engines=True)
    result, _ = tiny.run(base, cell, seconds=0.5)
    assert result["correct"], result["checks"]


def test_every_path_is_drawn(tmp_path, monkeypatch):
    """On the device engines' plain versions, the check's samples take a
    window of every K1 instantiation and an overlap of every K2 batch
    class the run used."""
    from portbench import check

    base = tiny.copy(tmp_path, device_engines=True)
    seen = []

    def spy(rng, labels, n, first):
        got = check_draw(rng, labels, n, first)
        seen.append((labels, got))
        return got

    check_draw = check.draw
    monkeypatch.setattr(check, "draw", spy)
    result, _ = tiny.run(base, "tiny.contig", seconds=0.5)
    assert result["correct"], result["checks"]
    (w_labels, w_got), (o_labels, o_got) = seen
    for labels, got, kind in ((w_labels, w_got, "k1 "), (o_labels, o_got,
                                                          "k2 ")):
        every = set().union(*labels)
        assert any(lab.startswith(kind) for lab in every), every
        assert set().union(*(labels[i] for i in got)) == every
