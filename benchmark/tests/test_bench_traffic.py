"""The traffic generator: its distributions for a fixed seed, the same
sizes for every seed, and the same files for the same seed."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH


def _load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def meta_pools(tmp_path_factory):
    import corpus

    config = _load("configs", "flagship")
    traffic = _load("traffic", "meta_k3x8x8")
    out = {}
    for seed in (7, 2 ** 31 + 11):
        root = str(tmp_path_factory.mktemp(f"c{seed}"))
        out[seed] = corpus.make_corpus(root, config, traffic, seed)
    return config, traffic, out


def test_sizes_and_distributions(meta_pools):
    config, traffic, pools = meta_pools
    a, b = pools.values()
    for script, task_a, task_b in zip(traffic["tasks"], a["utterances"],
                                      b["utterances"]):
        assert len(task_a) == traffic["utterances_per_task"]
        # the same multiset of sizes, in another order
        assert sorted(u[3] for u in task_a) == sorted(u[3] for u in task_b)
        assert sorted(len(u[4]) for u in task_a) == sorted(
            len(u[4]) for u in task_b)
        assert [u[4] for u in task_a] != [u[4] for u in task_b]
        secs = np.array([u[2] for u in task_a])
        assert 1.0 <= secs.min() and secs.max() <= 7.99
        assert 3.9 <= np.median(secs) <= 4.1
        rate = np.array([len(u[4]) for u in task_a]) / secs
        r = traffic["labels_per_s"][script]
        assert rate.min() >= r["min"] - 0.5 and rate.max() <= r["max"] + 0.5
        assert np.median(rate) == pytest.approx((r["min"] + r["max"]) / 2,
                                                rel=0.05)
    # every utterance fits the 800-frame bucket: 1 + samples // 160
    assert max(1 + u[3] // 160 for t in a["utterances"] for u in t) <= 800


def test_scripts_and_labels(meta_pools):
    config, _, pools = meta_pools
    pool = pools[7]
    with open(pool["labels"], encoding="utf-8") as f:
        labels = json.load(f)
    assert len(labels) == len(set(labels)) == config["labels"] == 3761
    assert "".join(labels[:28]) == " 'abcdefghijklmnopqrstuvwxyz"
    assert all(0x4E00 <= ord(ch) <= 0x9FFF for ch in labels[28:])
    latin, cjk, mixed = ([u[4] for u in t] for t in pool["utterances"])
    assert all(set(t) <= set(labels[:28]) for t in latin)
    assert all(not set(t) & set(labels[2:28]) for t in cjk)
    assert all(set(t) & set(labels[2:28]) and set(t) & set(labels[28:])
               for t in mixed if len(t) > 40)  # longer than one run
    assert all(t == t.strip() for t in latin + cjk + mixed)


def test_same_seed_same_corpus(tmp_path):
    import corpus

    config = _load("configs", "flagship")
    traffic = dict(_load("traffic", "greedy_b8"), utterances_per_task=8)
    a = corpus.make_corpus(str(tmp_path / "a"), config, traffic, 5)
    b = corpus.make_corpus(str(tmp_path / "b"), config, traffic, 5)
    for ua, ub in zip(a["utterances"][0], b["utterances"][0]):
        assert ua[2:] == ub[2:]
        with open(ua[0], "rb") as fa, open(ub[0], "rb") as fb:
            assert fa.read() == fb.read()


def test_served_batches_have_the_same_sizes_for_every_seed(tmp_path):
    import corpus

    config = _load("configs", "flagship")
    traffic = dict(_load("traffic", "greedy_b8"), utterances_per_task=32)
    sizes = []
    for seed in (3, 4):
        utts = corpus.make_corpus(str(tmp_path / str(seed)), config, traffic,
                                  seed)["utterances"][0]
        b = traffic["batch"]
        sizes.append(sorted((max(u[3] for u in utts[i:i + b]),
                             max(len(u[4]) for u in utts[i:i + b]))
                            for i in range(0, len(utts), b)))
    assert sizes[0] == sizes[1]
