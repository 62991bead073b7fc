"""On contig jobs the check that holds read-correction jobs reads the same
four numbers as the check before it (check_before_kf.py), on the same
finished jobs: sound runs, the control and each fault, for range shards
and for whole contigs served."""

import pytest

from portbench import check, gen
from portbench.capture import FAULTS
from portbench.tests import check_before_kf, tiny


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("kw", [{}, {"control": "int8"}]
                         + [{"fault": f} for f in FAULTS])
@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.serve"])
def test_same_numbers(base, monkeypatch, cell, kw):
    calls = []
    real = check.check

    def spy(jobs, inputs, cfg, spec, seed, control=None):
        got = real(jobs, inputs, cfg, spec, seed, control=control)
        calls.append((jobs, cfg, spec, seed, control, got))
        return got

    monkeypatch.setattr(check, "check", spy)
    tiny.run(base, cell, seconds=1.0, **kw)
    assert calls
    for jobs, cfg, spec, seed, control, (correct, numbers) in calls:
        before = {k: check_before_kf.Inputs(
            gen.from_config(cfg, seed, stream=k), cfg["contig_name"],
            cfg["racon"]["error_threshold"])
            for k in {j["dataset"] for j in jobs}}
        assert check_before_kf.check(jobs, before, cfg, spec, seed,
                                     control=control) == (correct, numbers)
