"""The traffic generator: the same seed gives the same schedule, another
seed another order of the same sizes."""
import collections
import json
from pathlib import Path

import numpy as np
import pytest

from cmpibench import generate

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
SEEDS = (0, 7, 2 ** 31 + 12345, 3 * 10 ** 9 + 1)


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["pingpong-small", "stream-large"])
def test_message_plan_repeats_for_a_seed_and_differs_across_seeds(name):
    t = mix(name)
    n = 3 * len(t["sizes"]) * t["per_block"]
    plans = {s: [generate.MessagePlan(t, s)(i) for i in range(n)]
             for s in SEEDS}
    for s in SEEDS:
        assert plans[s] == [generate.MessagePlan(t, s)(i) for i in range(n)]
    assert len({tuple(p) for p in plans.values()}) == len(SEEDS)
    # every seed sends the same sizes in each block, in another order
    block = len(t["sizes"]) * t["per_block"]
    for s in SEEDS:
        for b in range(3):
            sizes = [p[0] for p in plans[s][b * block:(b + 1) * block]]
            assert collections.Counter(sizes) == collections.Counter(
                {x: t["per_block"] for x in t["sizes"]})
        for size, o0, o1, _ in plans[s]:
            for o in (o0, o1):
                assert o % t["align"] == 0
                assert 0 <= o and o + size <= t["payload_bytes"]


def test_keep_share_draws_about_its_share():
    t = mix("stream-large")
    plan = generate.MessagePlan(t, 99)
    kept = np.mean([plan(i)[3] for i in range(20000)])
    assert abs(kept - t["keep_share"]) < 0.005


def test_payload_and_prompts_repeat_for_a_seed():
    t = mix("pingpong-small")
    a, b = generate.payload(t, 5), generate.payload(t, 5)
    assert np.array_equal(a, b) and a.size == t["payload_bytes"]
    assert not np.array_equal(a, generate.payload(t, 6))
    d = mix("decode-chat")
    p = generate.prompts(d, 2 ** 31 + 3, 4, 49155)
    assert p.shape == (d["rows"], d["prompt_len"])
    assert np.array_equal(p, generate.prompts(d, 2 ** 31 + 3, 4, 49155))
    assert not np.array_equal(p, generate.prompts(d, 2 ** 31 + 3, 5, 49155))
    assert p.min() >= 0 and p.max() < 49155


def test_sample_is_seeded_and_keeps_what_it_must():
    a = generate.sample(11, "check", 50, 5, must=[49])
    assert a == generate.sample(11, "check", 50, 5, must=[49])
    assert 49 in a and len(a) == 5 and a == sorted(set(a))
    assert generate.sample(11, "check", 3, 5) == [0, 1, 2]
