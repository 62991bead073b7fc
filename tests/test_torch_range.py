"""Range shards and the stitch split of the port's Polisher against the
JAX package.

  - `window_range`: 2 and 3 shards of the 3 kb draft (8x, 2 kb reads,
    seed 7) and of its two-contig twin, split points off the w = 500
    grid: each shard's segments and `segment_meta` equal the JAX
    polisher's, the segments concatenate to the whole run's contigs, and
    the LN / RC / XC tags re-derived from `segment_meta` equal the whole
    run's names; each shard aligns as many pairs as JAX's shard, none
    more than the whole run and one shard fewer (with the device
    aligner's plain version too);
  - `target_range`: fragment-correction shards of the small kF set
    (seed 7, 3 kb, 5x, 1.5 kb reads) equal JAX's shards and concatenate
    to the whole kF run; an empty selection raises;
  - ContigStreamer and FragmentStreamer fed the consensus pass's windows
    in a shuffled order write `_stitch`'s output, as the JAX streamers
    do on the same order, and the fragment groups tile [0, n).

Tolerance: zero, every value is an integer or a byte.
"""

import random

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.core import polisher as jax_polisher  # noqa: E402
from racon_tpu_torch.core.polisher import (ContigStreamer,  # noqa: E402
                                           FragmentStreamer, PolisherType,
                                           create_polisher)
from racon_tpu_torch.errors import RaconError  # noqa: E402
from racon_tpu_torch.synth import (ava_overlaps, simulate,  # noqa: E402
                                   simulate_truth, write_dataset,
                                   write_fragment_dataset)
from test_torch_reuse import write_twin  # noqa: E402

SCORES = (5, -4, -8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    _, draft, reads, paf = simulate(random.Random(7), 3000, 8, 2000, 0.12,
                                    0.10)
    _, _, freads, _ = simulate_truth(random.Random(7), 3000, 5, 1500, 0.12,
                                     0.10)
    fd = tmp_path_factory.mktemp("frag")
    return {"tiny": write_dataset(str(d), draft, reads, paf),
            "twin": write_twin(str(tmp_path_factory.mktemp("twin"))),
            "frag": write_fragment_dataset(str(fd), freads,
                                           ava_overlaps(freads))}


def port(paths, kind=PolisherType.kC, aligner=0):
    return create_polisher(*paths, kind, 500, 10.0, 0.3, True, *SCORES,
                           cuda_aligner_batches=aligner, device="cpu")


def jax_pol(paths, kind="kC", aligner=0):
    return jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType[kind], 500, 10.0, 0.3, True,
        *SCORES, tpu_aligner_batches=aligner)


def run(pol, window_range=None, target_range=None):
    pol.window_range = window_range
    pol.target_range = target_range
    pol.initialize()
    return [(s.name, s.data) for s in pol.polish()]


def derive(segments: list[list], metas: list[dict]) -> list:
    """The whole run's contigs from its shards' segments and accounting,
    as a router stitches them."""
    out = []
    for name, _ in segments[0]:
        data = b"".join(dict(seg)[name] for seg in segments)
        ms = [m[name] for m in metas]
        polished = sum(m["polished"] for m in ms)
        assert len({m["coverage"] for m in ms}) == 1
        assert sum(m["windows"] for m in ms) == ms[0]["total_windows"]
        if polished == 0:
            continue
        ratio = polished / float(ms[0]["total_windows"])
        out.append((f"{name} LN:i:{len(data)} RC:i:{ms[0]['coverage']} "
                    f"XC:f:{ratio:.6f}", data))
    return out


@pytest.mark.parametrize("which,splits,aligner", [
    ("tiny", (1250,), 0), ("tiny", (777, 2100), 0), ("twin", (1111, 2222), 0),
    ("tiny", (1250,), 1)])
def test_window_range_segments_match_jax(sets, which, splits, aligner):
    paths = sets[which]
    whole_pol = port(paths, aligner=aligner)
    whole = run(whole_pol)
    bounds = list(zip((0,) + splits, splits + (10**9,)))
    segments, metas, pairs = [], [], []
    for lo, hi in bounds:
        pol = port(paths, aligner=aligner)
        got = run(pol, window_range=(lo, hi))
        jpol = jax_pol(paths, aligner=aligner)
        assert got == run(jpol, window_range=(lo, hi)), (lo, hi)
        assert pol.segment_meta == jpol.segment_meta
        assert pol.n_aligner_pairs == jpol.n_aligner_pairs
        if aligner:
            assert pol.n_aligner_device == pol.n_aligner_pairs > 0
        pairs.append(pol.n_aligner_pairs)
        segments.append(got)
        metas.append(pol.segment_meta)
    assert derive(segments, metas) == whole
    assert len(whole) == (2 if which == "twin" else 1)
    # a shard skips the overlaps outside its windows' region
    assert max(pairs) <= whole_pol.n_aligner_pairs
    assert min(pairs) < whole_pol.n_aligner_pairs


def test_target_range_fragment_shards_match_jax(sets):
    paths = sets["frag"]
    whole = run(port(paths, PolisherType.kF))
    assert whole == run(jax_pol(paths, "kF"))
    parts = []
    for lo, hi in ((0, 4), (4, 7), (7, 100)):
        got = run(port(paths, PolisherType.kF), target_range=(lo, hi))
        assert got == run(jax_pol(paths, "kF"), target_range=(lo, hi))
        parts += got
    assert parts == whole and len(whole) > 5
    with pytest.raises(RaconError, match="selects no targets"):
        run(port(paths, PolisherType.kF), target_range=(10, 20))


def test_target_range_device_aligner_matches_jax(sets):
    paths = sets["frag"]
    got = run(port(paths, PolisherType.kF, aligner=1), target_range=(2, 6))
    assert got == run(jax_pol(paths, "kF", aligner=1), target_range=(2, 6))
    names = [name.split()[0] for name, _ in got]
    assert names and set(names) <= {f"read{i}r" for i in range(2, 6)}


def stream(pol, mod_streamer, order, drop=True, **kw):
    """The consensus pass, then the windows fed to a streamer in `order`,
    four at a time."""
    pol.initialize()
    pol._consensus_pass()
    seen = []
    if mod_streamer.__name__ == "FragmentStreamer":
        st = mod_streamer(pol, drop, lambda g, lo, hi: seen.append(
            ([s.name for s in g], lo, hi)), **kw)
    else:
        st = mod_streamer(pol, drop, lambda s: seen.append(s.name))
    wins = [pol.windows[i] for i in order]
    for k in range(0, len(wins), 4):
        st.on_windows(wins[k:k + 4])
    out = [(s.name, s.data) for s in st.finish()]
    want = [(s.name, s.data) for s in pol._stitch(drop)]
    assert out == want
    return out, seen


@pytest.mark.parametrize("which", ["twin", "frag"])
def test_streamers_match_stitch_and_jax(sets, which):
    kind = "kF" if which == "frag" else "kC"
    probe = port(sets[which], PolisherType[kind])
    probe.initialize()
    order = list(range(len(probe.windows)))
    random.Random(3).shuffle(order)
    out, parts = stream(port(sets[which], PolisherType[kind]),
                        ContigStreamer, order)
    jout, jparts = stream(jax_pol(sets[which], kind),
                          jax_polisher.ContigStreamer, order)
    assert out == jout and parts == jparts
    assert parts == [name for name, _ in out]
    if which != "frag":
        return
    for size in (1, 3, 64):
        fout, groups = stream(port(sets[which], PolisherType.kF),
                              FragmentStreamer, order, group_size=size)
        jfout, jgroups = stream(jax_pol(sets[which], "kF"),
                                jax_polisher.FragmentStreamer, order,
                                group_size=size)
        assert fout == jfout == out and groups == jgroups
        n = probe.n_targets
        assert [lo for _, lo, _ in groups] == list(range(0, n, size))
        assert [hi for _, _, hi in groups] == (
            list(range(size, n, size)) + [n])
        assert sum((g for g, _, _ in groups), []) == parts


def test_streamer_swallows_callback_errors(sets):
    def boom(*_):
        raise RuntimeError("part sink failed")

    pol = port(sets["twin"])
    pol.initialize()
    pol._consensus_pass()
    st = ContigStreamer(pol, True, boom)
    st.on_windows(list(reversed(pol.windows)))
    assert [(s.name, s.data) for s in st.finish()] == [
        (s.name, s.data) for s in pol._stitch(True)]
    frag = port(sets["frag"], PolisherType.kF)
    frag.initialize()
    frag._consensus_pass()
    fs = FragmentStreamer(frag, True, boom, group_size=2)
    fs.on_windows(frag.windows)
    assert len(fs.finish()) == frag.n_targets - frag.n_dropped
