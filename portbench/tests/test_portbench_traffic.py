"""The traffic generator: the same seed gives the same requests and
inputs, every seed the same sizes in the same proportions, and large
seeds work."""

from __future__ import annotations

import itertools

import numpy as np

from portbench import traffic, weights

MIX = dict(sizes=[dict(h=24, w=32, weight=2), dict(h=16, w=16, weight=1)],
           pool=3, content=dict(grid=8, shapes=4, texture=0.05),
           degrade=dict(blur=[3, 7], noise=0.01))
BIG = 2 ** 33 + 12345


def take(seed, n, ends=False):
    reqs = list(itertools.islice(traffic.schedule(MIX, seed), n))
    return [r if ends else r[:2] for r in reqs]


def test_same_seed_same_traffic():
    assert take(BIG, 30) == take(BIG, 30)
    a, b = traffic.make_pool(MIX, BIG, "cpu"), traffic.make_pool(MIX, BIG,
                                                                 "cpu")
    for hw in a:
        for x, y in zip(a[hw], b[hw]):
            assert x.dtype == np.float32 and x.shape == (*hw, 3)
            assert np.array_equal(x, y)
            assert 0.0 <= x.min() and x.max() <= 1.0 and x.std() > 0.02
    assert not np.array_equal(a[(24, 32)][0], a[(24, 32)][1])


def test_seeds_change_the_order_not_the_mix():
    one, two = take(BIG, 30), take(7, 30)
    assert one != two
    for s in (one, two):
        for deck in range(10):
            hws = [hw for hw, _ in s[3 * deck:3 * deck + 3]]
            assert sorted(hws) == [(16, 16), (24, 32), (24, 32)]
    assert [e for _, _, e in take(BIG, 9, ends=True)] == [False, False,
                                                         True] * 3
    # each size walks its pool in turn
    ks = [k for hw, k in one if hw == (24, 32)]
    assert all((b - a) % 3 == 1 for a, b in zip(ks, ks[1:]))


def test_open_loop_arrivals_are_seeded_poisson():
    mix = dict(MIX, arrivals=dict(loop="open", rate_per_s=50.0))
    a = list(itertools.islice(traffic.arrivals(mix, BIG), 2000))
    assert a == list(itertools.islice(traffic.arrivals(mix, BIG), 2000))
    assert all(x < y for x, y in zip(a, a[1:]))
    assert abs(a[-1] / len(a) - 1 / 50.0) < 0.002
    closed = list(itertools.islice(traffic.arrivals(MIX, BIG), 5))
    assert closed == [0.0] * 5


def test_weights_are_seeded_and_scaled():
    shapes = {"a.weight": (8, 4, 3, 3), "a.bias": (8,), "n.weight": (4,),
              "b.relative_position_bias_table": (9, 2),
              "c.temperature": (2, 1, 1), "out.weight": (3, 8, 3, 3)}
    s1 = weights.make_state(shapes, {"out.weight": 0.1}, BIG, "cpu")
    s2 = weights.make_state(shapes, {"out.weight": 0.1}, BIG, "cpu")
    assert all(np.array_equal(s1[k], s2[k]) for k in shapes)
    assert list(s1) == list(shapes)
    assert all(tuple(s1[k].shape) == v for k, v in shapes.items())
    big = weights.make_state({"w": (256, 1024)}, {}, 3, "cpu")["w"]
    assert abs(float(big.std()) - 1024 ** -0.5) < 0.002
    assert abs(float(s1["n.weight"].mean()) - 1.0) < 0.2
    assert float(s1["out.weight"].abs().max()) < 0.1 * 72 ** -0.5 * 6
