"""The traffic generator: a seed repeats its run; seeds share the
arrivals and the sizes and differ only in the prompts' tokens; the
lengths keep the file's medians and clips."""

import json
import numpy as np
import pytest

from bench.spec import BENCH
from bench.traffic import lengths, schedule

MIXES = ["chat"]


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_run(mix):
    tr = _traffic(mix)
    a = schedule(tr, 2**31 + 12345, 20.0, 32768)
    b = schedule(tr, 2**31 + 12345, 20.0, 32768)
    assert [(x.due, x.prompt, x.max_new, x.segment) for x in a] == \
        [(x.due, x.prompt, x.max_new, x.segment) for x in b]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_work(mix):
    """Two seeds: the same arrivals with the same sizes, in the same
    order; only the prompts' tokens differ."""
    tr = _traffic(mix)
    a = schedule(tr, 1, 20.0, 32768)
    b = schedule(tr, 98765432101, 20.0, 32768)
    assert [(x.due, len(x.prompt), x.max_new, x.segment) for x in a] == \
        [(x.due, len(x.prompt), x.max_new, x.segment) for x in b]
    for seg, length in (("lead", tr["lead_in_s"]), ("window", 20.0),
                        ("tail", tr["drain_s"])):
        assert sum(x.segment == seg for x in a) == max(1, round(
            tr["arrivals"]["rate"] * length))
    assert [x.prompt for x in a] != [x.prompt for x in b]


@pytest.mark.parametrize("mix", MIXES)
def test_window_holds_its_arrivals(mix):
    tr = _traffic(mix)
    runs = schedule(tr, 5, 51.0, 65536)
    win = [x.due for x in runs if x.segment == "window"]
    lead = tr["lead_in_s"]
    assert all(lead <= t < lead + 51.0 for t in win)
    assert all(a <= b for a, b in zip([x.due for x in runs],
                                      [x.due for x in runs][1:]))
    assert all(1 <= t < 65536 for x in runs for t in x.prompt)


@pytest.mark.parametrize("mix,which", [(m, w) for m in MIXES
                                       for w in ("prompt", "output")])
def test_lengths_keep_medians_and_clips(mix, which):
    law = _traffic(mix)[which]
    x = lengths(law, 20000, np.random.default_rng(0))
    assert x.min() >= law["min"] and x.max() <= law["max"]
    assert abs(np.median(x) / law["median"] - 1) < 0.03


def test_bursts_keep_their_shape():
    tr = _traffic("chat")
    tr["arrivals"] = {"process": "burst", "rate": 2.0, "burst_size": 8,
                      "spacing": 0.01, "jitter": 0.2}
    runs = [x for x in schedule(tr, 3, 40.0, 1000) if x.segment == "window"]
    assert len(runs) % 8 == 0
    due = np.array([x.due for x in runs])
    inside = np.diff(due).reshape(-1)
    assert np.sum(inside < 0.05) >= len(runs) - len(runs) // 8
    assert abs(len(runs) / 40.0 - 2.0) < 0.25
