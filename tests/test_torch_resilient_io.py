"""The port's ``io.ResilientIter`` against the JAX package's, on the CPU.

Each scenario of the reference's ``tests/test_resilient_io.py`` that
concerns ``ResilientIter`` runs once on each package, over the same data
(a shuffled ``NDArrayIter`` of 48 rows in batches of 8, or an indexed
record reader over one RecordIO file, damaged in place) and under the
same injected faults of each package's ``parallel.fault_injection``:
``flaky_reads``, ``slow_reads``, ``kill_worker``, ``truncate_record``
and the skip budget.  The two runs must see the same batches, the same
quarantine entries (sequence, epoch, file offset, path, error) and equal
``state_dict()`` s; a mid-epoch state of either package resumes the
other's iterator at the same next batch.  The thread and timeout drills
(no leaked worker, ``next()`` after the end, an abandoned iterator
reaped, a hung read and a hung resume replay surfaced as
``DataTimeoutError``, a worker that cannot be joined warned about) run
on both packages with the same outcome.
"""
import gc
import json
import threading
import time
import types
import warnings
import weakref

import numpy as np
import pytest

import incubator_mxnet_tpu.io as jio
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.parallel import fault_injection as jfi

import incubator_mxnet_tpu_torch.io as tio
from incubator_mxnet_tpu_torch import cpu
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.parallel import fault_injection as tfi

FEAT = 8
N = 48
BATCH = 8

PKGS = {"jax": types.SimpleNamespace(io=jio, rec=jrec, fi=jfi, ctx={}),
        "port": types.SimpleNamespace(io=tio, rec=trec, fi=tfi,
                                      ctx={"ctx": cpu()})}

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _data():
    rng = np.random.RandomState(3)
    return (rng.rand(N, FEAT).astype(np.float32),
            (np.arange(N) % 4).astype(np.float32))


def _make_iter(P, np_seed, **kw):
    X, Y = _data()
    np.random.seed(np_seed)
    return P.io.ResilientIter(P.io.NDArrayIter(X, Y, batch_size=BATCH,
                                               shuffle=True, **P.ctx), **kw)


def _both(scenario, *args):
    """``scenario(P, *args)`` on each package; returns both results."""
    return [scenario(PKGS[name], *args) for name in ("jax", "port")]


def _same(scenario, *args):
    got_j, got_t = _both(scenario, *args)
    assert _canon(got_j) == _canon(got_t)
    return got_t


def _canon(obj):
    """Comparable form: arrays as (dtype, shape, bytes)."""
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    return obj


def _record_iter(P, idx_path, rec_path):
    """The reference's indexed record reader, one record per ``next()``:
    a bad record raises with the cursor already past it."""

    class RecordIter(P.io.DataIter):
        def __init__(self):
            super().__init__(1)
            self._reader = P.rec.MXIndexedRecordIO(idx_path, rec_path, "r")
            self._k = 0

        def reset(self):
            self._k = 0

        def next(self):  # noqa: A003
            if self._k >= len(self._reader.keys):
                raise StopIteration
            key = self._reader.keys[self._k]
            self._k += 1
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # torn-record warning
                payload = self._reader.read_idx(key)
            if payload is None:  # a torn final record reads as EOF
                err = IOError("torn record %r" % key)
                err.offset = self._reader.idx[key]
                err.path = self._reader.uri
                raise err
            return np.frombuffer(payload, np.float32)

    return RecordIter()


def _write_records(tmp_path, n=10, bad=(), tear=None):
    """``n`` records of 4 floats (record i is all i), the records in
    ``bad`` with a broken magic, the last torn ``tear`` bytes in."""
    rec = str(tmp_path / "drill.rec")
    idx = str(tmp_path / "drill.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, np.full(4, i, np.float32).tobytes())
    w.close()
    reader = trec.MXIndexedRecordIO(idx, rec, "r")
    offs = dict(reader.idx)
    reader.close()
    with open(rec, "r+b") as f:
        for k in bad:
            f.seek(offs[k])
            f.write(b"\xde\xad\xbe\xef")
    if tear is not None:
        tfi.truncate_record(rec, offs[n - 1] + tear)
    return idx, rec, offs


def _state(it):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # inner w/o state
        state = it.state_dict()
    json.dumps(state)
    return state


# ---------------------------------------------------------------------------
# fault drills
# ---------------------------------------------------------------------------

def _flaky(P):
    with P.fi.flaky_reads(every_k=3) as stats:
        it = _make_iter(P, 1, retries=2, backoff=0.001)
        got = [b.index.copy() for b in it]
    out = {"batches": got, "quarantine": it.quarantine,
           "failed": stats.failed, "state": it.state_dict()}
    it.close()
    with P.fi.flaky_reads(every_k=1) as stats:
        it = _make_iter(P, 1, retries=1, backoff=0.001)
        with pytest.raises(OSError, match="injected flaky read"):
            it.next()
    out["exhausted_failed"] = stats.failed
    it.close()
    return out


def test_flaky_reads_absorbed_by_retry():
    out = _same(_flaky)
    assert len(out["batches"]) == N // BATCH and not out["quarantine"]
    assert out["failed"] >= 1 and out["exhausted_failed"] >= 2


def _timeout(P):
    with P.fi.slow_reads(0.3):
        it = _make_iter(P, 1, timeout=0.05)
        with pytest.raises(P.io.DataTimeoutError, match="no batch within"):
            for _ in range(N // BATCH + 1):
                it.next()
    it.close(join_timeout=1)
    time.sleep(0.4)  # let the stalled worker drain off
    return True


def test_timeout_surfaced_as_error():
    _same(_timeout)


def _worker_death(P):
    it = _make_iter(P, 1, max_respawns=2)
    with P.fi.kill_worker(at=2, count=1) as stats:
        it.reset()
        got = [b.index.copy() for b in it]
    out = {"batches": got, "killed": stats.killed, "state": it.state_dict()}
    it.close()
    with P.fi.kill_worker(at=0, count=100):
        it = _make_iter(P, 1, max_respawns=1)
        with pytest.raises(P.io.WorkerDiedError, match="respawn budget"):
            it.next()
    it.close()
    return out


def test_worker_death_detected_and_respawned():
    out = _same(_worker_death)
    assert len(out["batches"]) == N // BATCH and out["killed"] == 1


def _new_threads(baseline):
    """Threads started since ``baseline`` was taken and still alive
    (identities, not counts: a thread of an earlier test may end
    meanwhile)."""
    return [t for t in threading.enumerate() if t not in baseline]


def _combined(P, idx, rec, qlog):
    baseline = set(threading.enumerate())
    with P.fi.flaky_reads(every_k=3) as fstats, \
            P.fi.kill_worker(at=7, count=1) as kstats:
        it = P.io.ResilientIter(_record_iter(P, idx, rec),
                                on_bad_record="skip", skip_budget=3,
                                quarantine_log=qlog, retries=2,
                                backoff=0.001)
        got = [float(a[0]) for a in it]
    out = {"got": got, "quarantine": it.quarantine,
           "log": [json.loads(line) for line in open(qlog)],
           "flaky": fstats.failed >= 2, "killed": kstats.killed,
           "state": _state(it)}
    it.close()
    time.sleep(0.05)
    out["threads_back"] = not _new_threads(baseline)
    return out


def test_skip_budget_and_quarantine_under_combined_faults(tmp_path):
    """Flaky reads every 3rd record, a corrupt record (4), a torn final
    record (9) and a worker death in one epoch: the epoch ends within the
    budget with both skips logged (offset, path, error) and no thread
    left behind."""
    idx, rec, offs = _write_records(tmp_path, bad=(4,), tear=10)
    runs = [_combined(PKGS[name], idx, rec,
                      str(tmp_path / ("q_%s.jsonl" % name)))
            for name in ("jax", "port")]
    assert _canon(runs[0]) == _canon(runs[1])
    out = runs[1]
    assert out["got"] == [0, 1, 2, 3, 5, 6, 7, 8]
    assert sorted(q["offset"] for q in out["quarantine"]) == \
        sorted([offs[4], offs[9]])
    assert all(q["path"] == rec and q["error"] for q in out["quarantine"])
    assert out["log"] == out["quarantine"] and len(out["log"]) == 2
    assert out["flaky"] and out["killed"] == 1 and out["threads_back"]


def _budget(P, idx, rec):
    it = P.io.ResilientIter(_record_iter(P, idx, rec), on_bad_record="skip",
                            skip_budget=2)
    with pytest.raises(P.io.SkipBudgetExceeded, match="budget is 2"):
        list(it)
    out = {"skip": it.quarantine}
    it.close()
    it = P.io.ResilientIter(_record_iter(P, idx, rec),
                            on_bad_record="raise")
    with pytest.raises(IOError):
        list(it)
    out["raise"] = it.quarantine
    it.close()
    return out


def test_skip_budget_exhaustion_raises(tmp_path):
    idx, rec, _ = _write_records(tmp_path, bad=(1, 3, 5))
    out = _same(_budget, idx, rec)
    assert len(out["skip"]) == 3 and len(out["raise"]) == 1


def _continue_after_error(P, idx, rec):
    it = P.io.ResilientIter(_record_iter(P, idx, rec),
                            on_bad_record="raise")
    got, errors = [], 0
    while True:
        try:
            got.append(int(it.next()[0]))
        except StopIteration:
            break
        except IOError:
            errors += 1
    it.close()
    return {"got": got, "errors": errors, "quarantine": it.quarantine}


def test_epoch_continues_after_propagated_error(tmp_path):
    idx, rec, _ = _write_records(tmp_path, bad=(4,))
    out = _same(_continue_after_error, idx, rec)
    assert out["errors"] == 1 and len(out["quarantine"]) == 1
    assert out["got"] == [0, 1, 2, 3, 5, 6, 7, 8, 9]


# ---------------------------------------------------------------------------
# resume: the iterator-state protocol
# ---------------------------------------------------------------------------

def _force_skip(P, idx, rec, state=None):
    if state is None:
        it = P.io.ResilientIter(_record_iter(P, idx, rec),
                                on_bad_record="raise")
        got = []
        while len(got) < 4:
            try:
                got.append(int(it.next()[0]))
            except IOError:
                pass
        state = _state(it)
        it.close()
    else:
        got = None
    it2 = P.io.ResilientIter(_record_iter(P, idx, rec),
                             on_bad_record="raise")
    it2.load_state_dict(state)
    rest = [int(x[0]) for x in it2]
    it2.close()
    return {"head": got, "state": state, "rest": rest,
            "quarantine": it2.quarantine}


def test_resume_after_propagated_error_force_skips(tmp_path):
    """A raise-policy run that went on past a corrupt record stays
    resumable: the replay skips the quarantined record without raising
    or logging it again; each package's state resumes the other's."""
    idx, rec, _ = _write_records(tmp_path, bad=(2,))
    out_j, out_t = _both(_force_skip, idx, rec)
    assert _canon(out_j) == _canon(out_t)
    assert out_t["head"] == [0, 1, 3, 4]
    assert [q["seq"] for q in out_t["state"]["quarantine"]] == [2]
    assert out_t["rest"] == [5, 6, 7, 8, 9] and len(out_t["quarantine"]) == 1
    crossed = [_force_skip(PKGS["port"], idx, rec, out_j["state"]),
               _force_skip(PKGS["jax"], idx, rec, out_t["state"])]
    assert all(c["rest"] == out_t["rest"] and
               c["quarantine"] == out_t["quarantine"] for c in crossed)


def _replay_skips(P, idx, rec):
    it1 = P.io.ResilientIter(_record_iter(P, idx, rec), on_bad_record="skip",
                             skip_budget=3)
    head = [float(it1.next()[0]) for _ in range(4)]
    state = _state(it1)
    it2 = P.io.ResilientIter(_record_iter(P, idx, rec), on_bad_record="skip",
                             skip_budget=3)
    it2.load_state_dict(state)
    out = {"head": head, "state": state,
           "rest1": [float(a[0]) for a in it1],
           "rest2": [float(a[0]) for a in it2],
           "quarantine": it2.quarantine}
    it1.close()
    it2.close()
    return out


def test_resume_replays_skips_deterministically(tmp_path):
    idx, rec, offs = _write_records(tmp_path, bad=(2,))
    out = _same(_replay_skips, idx, rec)
    assert out["head"] == [0, 1, 3, 4]
    assert out["rest1"] == out["rest2"] == [5, 6, 7, 8, 9]
    assert [q["offset"] for q in out["quarantine"]] == [offs[2]]


def _batch_error_iter(P, fail=True):
    """An errno-carrying error flagged ``_mxtpu_batch_error`` after the
    slot was consumed (the threaded record iterator's per-batch decode
    error); it happens once."""

    class BatchErrorIter(P.io.DataIter):
        def __init__(self):
            super().__init__(1)
            self.n, self.bad, self._fail, self.k = 6, 2, fail, 0

        def reset(self):
            self.k = 0

        def next(self):  # noqa: A003
            if self.k >= self.n:
                raise StopIteration
            k = self.k
            self.k += 1
            if k == self.bad and self._fail:
                self._fail = False
                e = OSError(5, "transient decode fault mid-batch")
                e._mxtpu_batch_error = True
                raise e
            return k

    return BatchErrorIter()


def _batch_error(P):
    it = P.io.ResilientIter(_batch_error_iter(P), retries=3, backoff=0.001,
                            on_bad_record="skip", skip_budget=4)
    got = [it.next() for _ in range(3)]
    state = _state(it)
    it.close()
    it2 = P.io.ResilientIter(_batch_error_iter(P, fail=False), retries=3,
                             backoff=0.001, on_bad_record="skip",
                             skip_budget=4)
    it2.load_state_dict(state)
    rest = list(it2)
    it2.close()
    return {"got": got, "state": state, "rest": rest}


def test_batch_error_never_retried_and_resume_stays_aligned():
    out = _same(_batch_error)
    assert out["got"] == [0, 1, 3] and out["rest"] == [4, 5]
    assert out["state"]["consumed"] == 3 and out["state"]["skipped"] == 1
    assert [q["seq"] for q in out["state"]["quarantine"]] == [2]


def _readahead(P, idx, rec):
    it = P.io.ResilientIter(_record_iter(P, idx, rec), prefetch=4,
                            on_bad_record="skip", skip_budget=3)
    head = [float(it.next()[0]) for _ in range(4)]
    deadline = time.monotonic() + 2  # the read-ahead reaches record 6
    while not it.quarantine and time.monotonic() < deadline:
        time.sleep(0.01)
    seen_ahead = bool(it.quarantine)
    state = _state(it)
    it.close()
    it2 = P.io.ResilientIter(_record_iter(P, idx, rec), prefetch=4,
                             on_bad_record="skip", skip_budget=3)
    it2.load_state_dict(state)
    out = {"head": head, "ahead": seen_ahead, "state": state,
           "tail": [float(a[0]) for a in it2], "quarantine": it2.quarantine}
    it2.close()
    return out


def test_readahead_skip_not_double_counted_on_resume(tmp_path):
    idx, rec, offs = _write_records(tmp_path, bad=(6,))
    out = _same(_readahead, idx, rec)
    assert out["head"] == [0, 1, 2, 3] and out["ahead"]
    assert out["state"]["quarantine"] == [] and out["state"]["skipped"] == 0
    assert out["tail"] == [4, 5, 7, 8, 9]
    assert [q["offset"] for q in out["quarantine"]] == [offs[6]]


def _mid_epoch(P, state=None):
    it = _make_iter(P, 1)
    if state is None:
        head = [it.next().index.copy() for _ in range(2)]
        state = it.state_dict()
        ref = [b.index.copy() for b in it]
        it.close()
        it = _make_iter(P, 7)  # another ambient seed: the state wins
    else:
        head = ref = None
    it.load_state_dict(state)
    got = [b.index.copy() for b in it]
    it.reset()
    nxt = [b.index.copy() for b in it]
    it.close()
    return {"head": head, "ref": ref, "state": state, "got": got,
            "next_epoch": nxt}


def test_mid_epoch_resume_continues_at_the_same_batch():
    """A shuffled ``NDArrayIter`` under ``ResilientIter``: the state after
    2 batches resumes at batch 3 in a fresh iterator of either package
    (their states are equal JSON), and the next epoch shuffles as the
    uninterrupted run's would."""
    out_j, out_t = _both(_mid_epoch)
    assert _canon(out_j) == _canon(out_t)
    assert out_t["state"]["consumed"] == 2 and "inner" in out_t["state"]
    assert len(out_t["got"]) == N // BATCH - 2
    assert _canon(out_t["got"]) == _canon(out_t["ref"])
    for writer, reader in (("jax", "port"), ("port", "jax")):
        crossed = _mid_epoch(PKGS[reader], (out_j, out_t)[
            writer == "port"]["state"])
        assert _canon(crossed["got"]) == _canon(out_t["got"])
        assert _canon(crossed["next_epoch"]) == _canon(out_t["next_epoch"])


def _fast_forward(P, rec, idx):
    def make(seed):
        return P.io.ImageRecordIter(
            path_imgrec=rec, path_imgidx=idx, data_shape=(3, 8, 8),
            batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
            preprocess_threads=2, prefetch_buffer=2, seed=seed, **P.ctx)

    ref = P.io.ResilientIter(make(5))
    seq = [b.data[0].asnumpy() for b in ref]
    ref.close()
    it = P.io.ResilientIter(make(5))
    got = [it.next().data[0].asnumpy() for _ in range(2)]
    state = it.state_dict()
    it.close()
    inner2 = make(17)
    loaded = {}
    orig_load = inner2.load_state_dict
    inner2.load_state_dict = lambda st: (loaded.update(st), orig_load(st))
    it2 = P.io.ResilientIter(inner2)
    it2.load_state_dict(state)
    got += [b.data[0].asnumpy() for b in it2]
    it2.close()
    return {"seq": seq, "got": got, "state": state,
            "delegated": loaded.get("batch")}


def test_resume_delegates_fast_forward_to_inner(tmp_path):
    """On a clean epoch the resume hands the consumed count to the
    wrapped ``ImageRecordIter``'s own fast-forward; the stream still
    matches the uninterrupted one."""
    rng = np.random.RandomState(0)
    rec = str(tmp_path / "img.rec")
    idx = str(tmp_path / "img.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(24):
        img = rng.randint(0, 255, (10, 10, 3), np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 4), i, 0),
                                     img, img_fmt=".npy"))
    w.close()
    out = _same(_fast_forward, rec, idx)
    assert out["delegated"] == 2
    assert _canon(out["got"]) == _canon(out["seq"]) and len(out["seq"]) == 6


def _replay_timeout(P, idx, rec):
    it = P.io.ResilientIter(_record_iter(P, idx, rec))
    it.next()
    it.next()
    state = _state(it)
    it.close()
    it2 = P.io.ResilientIter(_record_iter(P, idx, rec), timeout=0.05)
    time.sleep(0.3)  # let the construction-time prefetch fill its queue
    with P.fi.slow_reads(0.6, count=1):  # the first replay pull hangs
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            with pytest.raises(P.io.DataTimeoutError, match="resume replay"):
                it2.load_state_dict(state)
    warned = any("replay abandoned" in str(w.message) for w in ws)
    time.sleep(0.8)  # the abandoned replay thread wakes and exits
    consumed = it2._consumed
    it2.load_state_dict(state)
    nxt = it2.next()
    it2.close()
    return {"warned": warned, "consumed": consumed, "next": nxt}


def test_resume_replay_honors_timeout(tmp_path):
    idx, rec, _ = _write_records(tmp_path)
    out = _same(_replay_timeout, idx, rec)
    assert out["warned"] and out["consumed"] == 0
    np.testing.assert_array_equal(out["next"], np.full(4, 2, np.float32))


# ---------------------------------------------------------------------------
# the worker's lifetime
# ---------------------------------------------------------------------------

def _threads(P):
    baseline = set(threading.enumerate())
    it = _make_iter(P, 1)
    for _ in range(2):
        it.next()
    live = bool(_new_threads(baseline))
    it.close()
    time.sleep(0.05)
    back = not _new_threads(baseline)
    with pytest.raises(StopIteration):  # closed is exhausted, not a hang
        it.next()
    # after the epoch's end, next() raises again instead of polling
    it = _make_iter(P, 1)
    n = len(list(it))
    out = {}

    def probe():
        try:
            it.next()
        except StopIteration:
            out["raised"] = True

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=2)
    it.reset()
    again = len(list(it))
    it.close()
    return {"live": live, "back": back, "n": n, "again": again,
            "raised": not t.is_alive() and out.get("raised", False)}


def test_close_joins_and_exhaustion_raises():
    out = _same(_threads)
    assert out == {"live": True, "back": True, "n": N // BATCH,
                   "again": N // BATCH, "raised": True}


def _abandoned(P):
    gc.collect()
    baseline = set(threading.enumerate())
    it = _make_iter(P, 1, prefetch=1)
    it.next()  # mid-epoch: the worker waits on the full queue
    wref = weakref.ref(it)
    del it
    gc.collect()
    deadline = time.monotonic() + 3
    while _new_threads(baseline) and time.monotonic() < deadline:
        time.sleep(0.05)
    return {"collected": wref() is None,
            "leaked": len(_new_threads(baseline))}


def test_abandoned_iterator_reaped_without_close():
    assert _same(_abandoned) == {"collected": True, "leaked": 0}


def _accessors(P, qlog):
    it = _make_iter(P, 1)
    seen = 0
    while it.iter_next():
        assert it.getdata() is not None and it.getlabel() is not None
        assert it.getpad() == 0 and it.getindex() is not None
        seen += 1
    out = {"seen": seen, "consumed": it._consumed}
    it.close()
    # the quarantine log makes its directory
    it = P.io.ResilientIter(_batch_error_iter(P), on_bad_record="skip",
                            quarantine_log=qlog, backoff=0.001)
    out["got"] = [it.next() for _ in range(3)]
    it.close()
    out["log"] = [json.loads(line)["seq"] for line in open(qlog)]
    return out


def test_iter_next_accessors_and_quarantine_log(tmp_path):
    runs = [_accessors(PKGS[name], str(tmp_path / name / "sub" / "q.jsonl"))
            for name in ("jax", "port")]
    assert runs[0] == runs[1] == {"seen": N // BATCH, "consumed": N // BATCH,
                                  "got": [0, 1, 3], "log": [2]}


def _warns(P, idx, rec):
    it = P.io.ResilientIter(_record_iter(P, idx, rec))  # no state protocol
    it.next()
    with pytest.warns(RuntimeWarning, match="no state_dict"):
        state = it.state_dict()
    it.close()
    it = P.io.ResilientIter([np.zeros(2)] * 4)  # a plain iterable: no warning
    it.next()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = it.state_dict()
    it.close()
    return {"state": state, "plain": plain}


def test_state_dict_warns_when_inner_lacks_protocol(tmp_path):
    idx, rec, _ = _write_records(tmp_path)
    out = _same(_warns, idx, rec)
    assert "inner" not in out["state"] and out["state"]["consumed"] == 1


def _stale_worker(P):
    with P.fi.slow_reads(0.5):
        it = _make_iter(P, 1, timeout=10)
        time.sleep(0.1)  # the worker is inside the slow read
        with pytest.warns(RuntimeWarning, match="did not exit"):
            it.close(join_timeout=0.05)
    time.sleep(0.6)  # drain the stalled worker
    return True


def test_close_join_timeout_warns_stale_worker():
    _same(_stale_worker)
