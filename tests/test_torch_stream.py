"""Port vs JAX package: the streaming statistics (``stream/``).

The sketch, the trackers and the trigger are numpy on both sides, so the
port is held bit for bit: the same batches give equal ``state_tree``
leaves, window summaries, ``points``, ``id_weights`` and trigger events
(fires on an entropy collapse and on a head drift among them).  The
torch cell counter equals JAX's ``cell_count_fn`` and the host
``CountMinSketch.cells`` count bit for bit, and the async fold (the
tracker's own counter, a background thread) leaves the state the
synchronous fold of the step's delta leaves."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_criteo as jcfg
from repro.models import dlrm as jdlrm
from repro.stream import device as jdevice
from repro.stream import sketch as jsketch
from repro.stream import tracker as jtracker
from repro.stream import trigger as jtrigger
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.models import dlrm as tdlrm
from repro_torch.stream import device as tdevice
from repro_torch.stream import points as tpoints
from repro_torch.stream import sketch as tsketch
from repro_torch.stream import tracker as ttracker
from repro_torch.stream import trigger as ttrigger

VOCABS = (3000, 200, 40_000)
CONFIG = dict(width=1 << 9, depth=4, heavy=32, ring=256, decay=0.5, window=4)


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _shifting_batches(n_per_phase=12, batch=96, seed=0):
    """Three phases: ids spread over each vocabulary, then a collapse onto
    five ids, then a head of five other ids (drift at unchanged entropy)."""
    rng = np.random.default_rng(seed)
    out = []
    for phase in range(3):
        for _ in range(n_per_phase):
            cols = []
            for v in VOCABS:
                if phase == 0:
                    cols.append(rng.integers(0, v, batch))
                else:
                    head = np.arange(5) + (0 if phase == 1 else 100)
                    cols.append(rng.choice(head, batch))
            out.append({"sparse": np.stack(cols, 1).astype(np.int32)})
    return out


def _trackers(async_fold=False, tracked=(0, 2)):
    sc = dict(CONFIG, async_fold=async_fold)
    j = jtracker.SketchFrequencyTracker(VOCABS, jtracker.StreamConfig(**sc), tracked=tracked)
    t = ttracker.SketchFrequencyTracker(VOCABS, ttracker.StreamConfig(**sc), tracked=tracked,
                                        device="cpu")
    return j, t


def _triggers():
    kw = dict(entropy_drop=0.2, drift_threshold=0.3, warmup=1, min_windows_between=0)
    return jtrigger.ClusterTrigger(**kw), ttrigger.ClusterTrigger(**kw)


@pytest.fixture(scope="module")
def driven():
    """Both trackers and triggers after the same shifting stream (the
    host conservative-update path), window summaries kept as they close."""
    jt, tt = _trackers()
    jg, tg = _triggers()
    summaries = []
    for step, batch in enumerate(_shifting_batches(), start=1):
        jt.observe(batch)
        tt.observe(batch)
        js, ts = jt.poll_window(), tt.poll_window()
        assert (js is None) == (ts is None)
        if js is not None:
            summaries.append((js, ts))
            jg.update(js, step)
            tg.update(ts, step)
    return jt, tt, jg, tg, summaries


def test_tracker_state_trees_equal(driven):
    jt, tt, *_ = driven
    assert tt.batches_seen == jt.batches_seen == 36
    _assert_leaves_equal(tt.state_tree(), jt.state_tree())
    assert tt.nbytes == jt.nbytes
    for f in jt.tracked:
        np.testing.assert_array_equal(tt.export_heads(8)[f], jt.export_heads(8)[f])


def test_window_summaries_equal(driven):
    summaries = driven[4]
    assert len(summaries) == 9
    for js, ts in summaries:
        assert ts["entropy"] == js["entropy"] and ts["mass"] == js["mass"]
        assert ts["batches_seen"] == js["batches_seen"]
        for jh, th in zip(js["heads"], ts["heads"]):
            np.testing.assert_array_equal(th[0], jh[0])
            np.testing.assert_array_equal(th[1], jh[1])


def test_trigger_events_equal_with_collapse_and_drift_fires(driven):
    *_, jg, tg, _ = driven
    assert [e.as_dict() for e in tg.events] == [e.as_dict() for e in jg.events]
    reasons = {e.reason for e in tg.events if e.fire}
    assert reasons == {"entropy-collapse", "drift"}
    _assert_leaves_equal(tg.state_tree(), jg.state_tree())
    fresh = ttrigger.ClusterTrigger()
    fresh.load_state_tree(tg.state_tree())
    _assert_leaves_equal(fresh.state_tree(), tg.state_tree())
    _assert_leaves_equal(fresh.state_template(), jtrigger.ClusterTrigger().state_template())


@pytest.mark.parametrize("n", [16, 1000])
def test_points_and_id_weights_equal(driven, n):
    jt, tt, *_ = driven
    for f in jt.tracked:
        jp, tp = jt.counts[f].points(n, seed=3), tt.counts[f].points(n, seed=3)
        np.testing.assert_array_equal(tp[0], jp[0])
        assert tp[1].dtype == jp[1].dtype == np.float32
        np.testing.assert_array_equal(tp[1], jp[1])
        w = tt.counts[f].id_weights(VOCABS[f], chunk=1000)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, jt.counts[f].id_weights(VOCABS[f], chunk=1000))
    assert tt.counts[1] is None and jt.counts[1] is None


def test_sketch_pieces_equal_on_zipf():
    ids = np.random.default_rng(1).zipf(1.3, 20_000) % 50_000
    jc, tc = jsketch.CountMinSketch(1 << 10, 4, seed=3), tsketch.CountMinSketch(1 << 10, 4, seed=3)
    for lo in range(0, ids.size, 4096):
        u, c = np.unique(ids[lo:lo + 4096], return_counts=True)
        jc.add(u, c)
        tc.add(u, c)
    probe = np.unique(ids)
    np.testing.assert_array_equal(tc.cells(probe), jc.cells(probe))
    np.testing.assert_array_equal(tc.estimate(probe), jc.estimate(probe))
    np.testing.assert_array_equal(tc.estimate_unbiased(probe), jc.estimate_unbiased(probe))
    _assert_leaves_equal(tc.state_tree(), jc.state_tree())
    dense = np.bincount(ids, minlength=50_000)
    jf, tf = jsketch.FeatureSketch(1 << 10, 4, 64, 512), tsketch.FeatureSketch(1 << 10, 4, 64, 512)
    jf.ingest_dense(dense)
    tf.ingest_dense(dense)
    _assert_leaves_equal(tf.state_tree(), jf.state_tree())
    summ_j, summ_t = jf.summary(), tf.summary()
    assert summ_t["entropy"] == summ_j["entropy"]
    np.testing.assert_array_equal(summ_t["head_ids"], summ_j["head_ids"])


def test_dense_state_migration_equal():
    rng = np.random.default_rng(2)
    dense = [rng.poisson(0.3, v).astype(np.int64) for v in VOCABS]
    jt, tt = _trackers()
    _assert_leaves_equal(tt.state_from_dense(dense), jt.state_from_dense(dense))
    (j_old, j_new), = jt.checkpoint_migrations()
    (t_old, t_new), = tt.checkpoint_migrations()
    tmpl = {"id_counts": tt.state_template()}
    assert [a.shape for a in t_old(tmpl)["id_counts"]] == [a.shape for a in j_old(tmpl)["id_counts"]]
    _assert_leaves_equal(t_new({"id_counts": dense})["id_counts"],
                         j_new({"id_counts": dense})["id_counts"])


def test_dense_tracker_and_sampling_equal():
    batches = _shifting_batches(n_per_phase=2)
    jd, td = jtracker.IdFrequencyTracker(VOCABS), ttracker.IdFrequencyTracker(VOCABS)
    for b in batches:
        jd.observe(b)
        td.observe(b)
    _assert_leaves_equal(td.state_tree(), jd.state_tree())
    np.testing.assert_array_equal(td.sample_ids(4, 0, 50), jd.sample_ids(4, 0, 50))
    assert tpoints.sample_from_counts(np.zeros(5), 3, 0) is None


def test_make_id_tracker_tracks_the_cce_features():
    jc, tc = jcfg.reduced(cap=256), tcfg.reduced(cap=256)
    j = jdlrm.make_id_tracker(jc, jcfg.reduced_stream())
    t = tdlrm.make_id_tracker(tc, tcfg.reduced_stream(), device="cpu")
    assert t.tracked == j.tracked and len(t.tracked) > 0
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert dataclasses.asdict(tcfg.STREAM) == dataclasses.asdict(jcfg.STREAM)
    assert isinstance(tdlrm.make_id_tracker(tc), ttracker.IdFrequencyTracker)


# --- the cell counter -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_counter_equals_jax_and_host_cells(seed):
    """Ids over the whole int32 range (negative ones included, which both
    sides take mod 2^32) land in the same cells as JAX's counter and the
    host sketch's ``cells``."""
    rng = np.random.default_rng(seed)
    sketches = [jsketch.CountMinSketch(1 << 10, 4, seed=s) for s in (5, 6, 7)]
    port = [tsketch.CountMinSketch(1 << 10, 4, seed=s) for s in (5, 6, 7)]
    ids = rng.integers(-2**31, 2**31, (257, 3)).astype(np.int32)
    ids[:64] = rng.integers(0, 50, (64, 3))  # repeats, so cells count past 1
    want = np.asarray(jdevice.cell_count_fn(sketches)(jnp.asarray(ids)))
    got = tdevice.cell_count_fn(port)(torch.from_numpy(ids))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 4, 1 << 10)
    np.testing.assert_array_equal(got.numpy(), want)
    host = np.zeros_like(want)
    for f, s in enumerate(port):
        cells = s.cells(ids[:, f])
        for r in range(s.depth):
            np.add.at(host[f, r], cells[r], 1)
    np.testing.assert_array_equal(got.numpy(), host)
    assert int(got.sum()) == ids.size * 4
    standalone = tdevice.make_cell_counter(port, device="cpu")(ids)
    assert torch.equal(standalone, got)


def test_step_cell_counter_selects_tracked_columns():
    jt, tt = _trackers()
    batch = _shifting_batches(n_per_phase=1)[0]["sparse"]
    want = np.asarray(jdevice.make_step_cell_counter(jt)({"sparse": jnp.asarray(batch)}))
    got = tdevice.make_step_cell_counter(tt)({"sparse": torch.from_numpy(batch)})
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdevice.make_step_cell_counter(ttracker.IdFrequencyTracker(VOCABS)) is None


def test_async_fold_equals_sync_fold_and_jax():
    """The tracker's own counter on a background thread, the step's delta
    folded synchronously, and JAX's async tracker end in one state."""
    batches = _shifting_batches(n_per_phase=4)
    j_async, t_async = _trackers(async_fold=True)
    _, t_sync = _trackers()
    step_counter = tdevice.make_step_cell_counter(t_sync)
    for b in batches:
        j_async.observe(b)
        t_async.observe(b)
        t_sync.observe(b, delta=step_counter({"sparse": torch.from_numpy(b["sparse"])}))
    want = j_async.state_tree()
    _assert_leaves_equal(t_async.state_tree(), want)
    _assert_leaves_equal(t_sync.state_tree(), want)


def test_async_fold_surfaces_errors_on_flush():
    calls = []

    def fold(item):
        calls.append(item)
        if item == 2:
            raise ValueError("bad fold")

    folder = tdevice.AsyncFolder(fold)
    for i in range(4):
        folder.submit(i)
    with pytest.raises(ValueError, match="bad fold"):
        folder.flush()
    assert calls == [0, 1, 2]  # after the error the queue drains without work
    folder.submit(5)
    folder.flush()
    assert calls[-1] == 5
