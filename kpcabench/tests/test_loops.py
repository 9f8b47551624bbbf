"""The serving loads against a stand-in engine that answers at once: the
closed loop keeps one request a client outstanding and cycles the list;
the open loop sends on its Poisson schedule and times from when each
request was due."""

import threading

import numpy as np

from kpcabench.runners import serve


class Done:
    def __init__(self, rid, rows):
        self.request_id, self.rows = rid, rows

    def result(self, timeout=None):
        return np.zeros((self.rows.shape[0], 1), np.float32)


class Engine:
    def __init__(self):
        self.sent = []
        self.lock = threading.Lock()

    def submit(self, x):
        with self.lock:
            self.sent.append(x.shape[0])
            return Done(len(self.sent), x)


TRAFFIC = dict(requests=16, min_rows=4, max_rows=64, pool_rows=512)


def test_sizes_are_the_same_for_every_seed():
    a = sorted(q for _, q in serve.requests(TRAFFIC, 1))
    b = sorted(q for _, q in serve.requests(TRAFFIC, 2 ** 31 + 9))
    assert a == b == sorted(serve.sizes(TRAFFIC).tolist())
    assert min(a) >= 4 and max(a) <= 64
    assert [q for _, q in serve.requests(TRAFFIC, 1)] != \
        [q for _, q in serve.requests(TRAFFIC, 2)]


def test_closed_loop():
    eng, reqs = Engine(), serve.requests(TRAFFIC, 3)
    pool = np.zeros((512, 8), np.float32)
    t0, t_end, records, errors = serve.closed_loop(eng, reqs, pool, 4, 0.2)
    assert not errors and len(records) == len(eng.sent) > 16
    assert all(r.done >= r.sent for r in records)
    assert [reqs[r.index][1] for r in records] == eng.sent


def test_open_loop():
    eng, reqs = Engine(), serve.requests(TRAFFIC, 3)
    pool = np.zeros((512, 8), np.float32)
    t0, t_end, records, errors, late = serve.open_loop(
        eng, reqs, pool, rate=200.0, seconds=0.5, seed=7)
    assert not errors and 50 <= len(records) <= 160
    assert len(late) == len(records) and min(late) >= 0.0
    due = [r.sent for r in records]
    assert due == sorted(due) and due[0] >= t0 and due[-1] < t_end
