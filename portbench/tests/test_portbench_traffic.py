"""The traffic generator: the same seed gives the same stream (pool
sizes, user ids, feature sets, offsets, arrivals, the sample checked)
and the same feature rows; another seed gives another."""
import numpy as np
import pytest
import torch

from portbench import inputs, traffic

SEED = 2**31 + 12345          # seeds reach past 32 signed bits


def _mix(name):
    return traffic.load_mix(name)


# the open-loop arrivals at the served cell's pools (no cell runs one yet)
OPEN = {"driver": "served",
        "arrivals": {"kind": "poisson", "rate_per_s": 420},
        "pool": {"kind": "log_uniform", "lo": 1000, "hi": 5000},
        "users": {"kind": "fresh"}, "user_feature_sets": 1024,
        "candidate_rows": 320000, "check_sample": 48}
MIXES = {"fresh_pool": _mix("fresh_pool"), "open_r420": OPEN,
         "open_small": dict(OPEN, arrivals={"kind": "poisson",
                                            "rate_per_s": 40},
                            pool={"kind": "log_uniform", "lo": 20,
                                  "hi": 300}, candidate_rows=2000)}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_stream(name):
    mix = MIXES[name]
    a = traffic.served_stream(mix, SEED, 3.0)
    b = traffic.served_stream(mix, SEED, 3.0)
    c = traffic.served_stream(mix, SEED + 1, 3.0)
    for f in ("due", "pool", "offset", "user_id", "user_set", "check"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.pool[:50], c.pool[:50])
    assert not np.array_equal(a.offset[:50], c.offset[:50])
    # another seed: the same work in another order
    assert len(c) == len(a)
    np.testing.assert_array_equal(np.sort(a.pool), np.sort(c.pool))
    np.testing.assert_allclose(np.sort(np.diff(a.due, prepend=0)),
                               np.sort(np.diff(c.due, prepend=0)))
    lo, hi = mix["pool"]["lo"], mix["pool"]["hi"]
    assert a.pool.min() >= lo and a.pool.max() <= hi
    assert (a.offset + a.pool <= mix["candidate_rows"]).all()
    assert int(np.argmax(a.pool)) in a.check
    assert len(np.unique(a.user_id)) == len(a)        # fresh users
    arr = mix["arrivals"]
    if arr["kind"] == "poisson":
        assert (np.diff(a.due) > 0).all() and a.due[-1] < 3.0
        rate = arr["rate_per_s"]
        assert abs(len(a) / 3.0 - rate) < 5 * np.sqrt(rate / 3.0)
    else:
        # a closed loop: the clients pace it, the stream only bounds it
        assert len(a) == arr["max_requests"] and not a.due.any()


def test_served_cell_is_the_closed_loop_of_its_issue():
    mix = _mix("fresh_pool")
    assert mix["arrivals"]["kind"] == "closed_loop"
    assert mix["arrivals"]["clients"] == 32
    assert (mix["pool"]["lo"], mix["pool"]["hi"]) == (1000, 5000)
    assert mix["users"] == {"kind": "fresh"}
    s = traffic.served_stream(mix, SEED, 51.0)
    # a window sends far fewer requests than the stream holds
    assert len(s) >= 100_000


def test_unknown_kinds_are_refused():
    mix = _mix("fresh_pool")
    for key, bad in (("arrivals", {"kind": "bursty"}),
                     ("pool", {"kind": "fixed"}),
                     ("users", {"kind": "zipf"})):
        with pytest.raises(ValueError):
            traffic.served_stream(dict(mix, **{key: bad}), SEED, 3.0)


def test_log_uniform_mean():
    rng = traffic.rng_for(SEED, 1)
    x = traffic.log_uniform_ints(rng, 1000, 5000, 200_000)
    # mean of log-uniform on [1000, 5001): 4001 / ln(5.001) = 2485.6
    assert x.mean() == pytest.approx(2485.6, rel=0.01)
    assert x.min() >= 1000 and x.max() <= 5000


def test_feature_rows_follow_the_seed():
    dev = torch.device("cpu")
    spec = {"ids": ((), "int32", 1000), "x": ((4,), "float32", None)}
    a = inputs.draw_rows(spec, 64, inputs.generator(SEED, 12, dev))
    b = inputs.draw_rows(spec, 64, inputs.generator(SEED, 12, dev))
    c = inputs.draw_rows(spec, 64, inputs.generator(SEED + 1, 12, dev))
    for k in spec:
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert a["ids"].dtype == np.int32 and a["ids"].max() < 1000


def test_reservoir_is_seeded():
    def pick(seed):
        r = traffic.Reservoir(4, seed)
        for i in range(500):
            k = r.slot()
            if k is not None:
                r.items[k] = i
        return r.items
    assert pick(SEED) == pick(SEED)
    assert pick(SEED) != pick(SEED + 1)
    assert len(set(pick(SEED))) == 4
