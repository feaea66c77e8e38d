"""The port's checkpoint store (``repro_torch.checkpoint``) and its format.

Round trip with each leaf back in its template's type (tensor dtype and
device, python int, numpy), uncommitted checkpoints ignored, async saves
with retention, errors surfaced on ``wait()``, sectioned restores, and
both directions against the JAX package: a checkpoint the port writes
loads through JAX's ``load_checkpoint`` with JAX's template, and a JAX
checkpoint loads into the port, with equal leaves and ``hs`` uint32 on
disk."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import dlrm_criteo as jcfg
from repro.models import dlrm as jdlrm
from repro.optim import sgd as jsgd
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import dlrm_criteo as tcfg
from repro_torch.data.synthetic import ClickstreamConfig as TClick
from repro_torch.data.synthetic import clickstream_batches as tdata
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import sgd
from repro_torch.train import loop as tloop
from repro_torch.tree import jax_leaves, jax_leaves_with_paths


def _port_state(step=7, seed=0):
    cfg = tcfg.reduced()
    p, b = tdlrm.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = sgd(momentum=0.9)
    state = tloop.init_state(p, opt, b)._replace(step=step)
    g = torch.Generator().manual_seed(seed + 1)
    for m in jax_leaves(state.opt):
        m.copy_(torch.randn(m.shape, generator=g))
    return cfg, state


def _tree(state, **extra):
    return {"state": state._replace(step=np.int32(state.step)),
            "clusters_done": np.int32(2), **extra}


def _template(state):
    return {"state": state, "clusters_done": np.int32(0)}


def _assert_trees_equal(got, want):
    g, w = jax_leaves(convert.to_numpy(got)), jax_leaves(convert.to_numpy(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_round_trip_restores_leaf_types(tmp_path):
    _, state = _port_state()
    tree = _tree(state, trigger=[np.int64(3), np.zeros((2, 4))])
    store.save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    _, fresh = _port_state(step=0, seed=5)
    step, got, extra = store.load_checkpoint(
        str(tmp_path), template=_template(fresh) | {"trigger": [np.int64(0), np.zeros((0, 4))]})
    assert step == 7 and extra == {"note": "x"} and int(got["clusters_done"]) == 2
    assert got["state"].step == 7 and isinstance(got["state"].step, int)
    _assert_trees_equal(got["state"].params, state.params)
    _assert_trees_equal(got["state"].opt, state.opt)
    for path, leaf in jax_leaves_with_paths(got["state"].ebuf):
        want = "hs" in path and torch.int64 or ("ptr" in path or "epoch" in path) and torch.int32
        assert leaf.dtype == want and leaf.device.type == "cpu"
    _assert_trees_equal(got["state"].ebuf, state.ebuf)
    np.testing.assert_array_equal(got["trigger"][1], np.zeros((2, 4)))  # wildcard absorbed


def test_hs_is_uint32_on_disk_and_leaves_in_jax_order(tmp_path):
    _, state = _port_state()
    path = store.save_checkpoint(str(tmp_path), 1, _tree(state))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    paths = [p for p, _ in jax_leaves_with_paths(_tree(state))]
    assert man["n_leaves"] == len(paths)
    assert man["toplevel"] == [["clusters_done", 1], ["state", len(paths) - 1]]
    hs = [i for i, p in enumerate(paths) if p.endswith("['hs']")]
    assert hs and all(man["leaves"][i]["dtype"] == "uint32" for i in hs)
    step_leaf = paths.index("['state'].step")
    assert man["leaves"][step_leaf] == {"shape": [], "dtype": "int32"}
    # a buffer dict is {"ptr", "hs", "epoch"} in insertion order, stored sorted
    first_buf = [p for p in paths if "ebuf" in p][:3]
    assert [p.rsplit("[", 1)[1] for p in first_buf] == ["'epoch']", "'hs']", "'ptr']"]


def test_uncommitted_checkpoints_are_ignored(tmp_path):
    _, state = _port_state()
    store.save_checkpoint(str(tmp_path), 3, _tree(state))
    path = store.save_checkpoint(str(tmp_path), 5, _tree(state._replace(step=5)))
    os.remove(os.path.join(path, "_COMMITTED"))  # killed before the commit marker
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert [s for s, _ in store.list_checkpoints(str(tmp_path))] == [3]
    step, got, _ = store.load_checkpoint(str(tmp_path), template=_template(state))
    assert step == 3 and got["state"].step == 7
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "none"), template=_template(state))


def test_async_save_with_retention(tmp_path):
    _, state = _port_state()
    mgr = store.CheckpointManager(str(tmp_path), keep_last=2)
    for s in (2, 4, 6, 8):
        mgr.save_async(s, _tree(state._replace(step=s)))
        # the host copy was taken at enqueue: mutating the state now is safe
        state.params["top"][0]["b"].add_(1.0)
    mgr.wait()
    assert [s for s, _ in store.list_checkpoints(str(tmp_path))] == [6, 8]
    assert len(mgr.enqueue_ms) == len(mgr.write_ms) == 4
    step, got, _ = mgr.restore_latest(_template(state))
    assert step == 8 and got["state"].step == 8
    np.testing.assert_array_equal(got["state"].params["top"][0]["b"].numpy(),
                                  state.params["top"][0]["b"].numpy() - 1.0)


def test_async_save_errors_surface_on_wait(tmp_path):
    _, state = _port_state()
    mgr = store.CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    os.rmdir(tmp_path / "ck")
    (tmp_path / "ck").write_text("not a directory")
    mgr.save_async(1, _tree(state))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


def test_sectioned_restore_drops_and_defaults(tmp_path):
    _, state = _port_state()
    stored = _tree(state, id_counts=[np.arange(5)], trigger=[np.int64(4)])
    store.save_checkpoint(str(tmp_path), 1, stored)
    # the reader has no tracker (id_counts dropped) and a new section
    tmpl = _template(state) | {"trigger": [np.int64(0)], "extra": [np.float64(9.0)]}
    _, got, _ = store.load_checkpoint(str(tmp_path), template=tmpl)
    assert "id_counts" not in got and int(got["trigger"][0]) == 4
    assert float(got["extra"][0]) == 9.0
    # a candidate that migrates data wins over one that merely drops it
    migrated = _template(state) | {"id_counts": [np.zeros(0)], "trigger": [np.int64(0)]}
    _, got, _ = store.load_checkpoint(str(tmp_path), migrations=[
        (tmpl, None), (migrated, lambda t: dict(t, migrated=True))])
    assert got["migrated"] and np.array_equal(got["id_counts"][0], np.arange(5))
    with pytest.raises(ValueError):  # a section whose shapes do not fit
        store.load_checkpoint(str(tmp_path), template=_template(state) | {
            "id_counts": [np.zeros(3)], "trigger": [np.int64(0)]})


# --- both directions against the JAX package ---------------------------------------


def _jax_template():
    jc = jcfg.reduced()
    p, b = jdlrm.init(jax.random.PRNGKey(3), jc)
    opt = jsgd(momentum=0.9)
    dyn, _ = jloop.split_buffers(b)
    return {"state": jloop.init_state(p, opt, dyn), "clusters_done": np.int32(0),
            "trigger": [np.int64(0)]}


def test_port_checkpoint_loads_in_jax(tmp_path):
    _, state = _port_state()
    tree = _tree(state, trigger=[np.int64(6)])
    store.save_checkpoint(str(tmp_path), 7, tree)
    step, got, _ = jstore.load_checkpoint(str(tmp_path), template=_jax_template())
    assert step == 7 and int(got["state"].step) == 7 and int(got["clusters_done"]) == 2
    want = jax_leaves(convert.to_numpy(tree))
    leaves = jax.tree.leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hs = [x for g in got["state"].ebuf["emb"] for f in g for k, x in f.items() if k == "hs"]
    assert hs and all(np.asarray(x).dtype == np.uint32 for x in hs)


def test_jax_checkpoint_loads_in_port(tmp_path):
    jtree = _jax_template()
    jtree["state"] = jtree["state"]._replace(step=np.int32(11))
    jtree["trigger"] = [np.int64(2)]
    jstore.save_checkpoint(str(tmp_path), 11, jtree)
    with open(tmp_path / "step_000000011" / "manifest.json") as f:
        man = json.load(f)
    assert "uint32" in {leaf["dtype"] for leaf in man["leaves"]}
    _, state = _port_state(step=0)
    step, got, _ = store.load_checkpoint(str(tmp_path), template=_template(state) | {
        "trigger": [np.int64(0)]})
    assert step == 11 and got["state"].step == 11 and int(got["trigger"][0]) == 2
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtree["state"]))
    leaves = jax_leaves(convert.to_numpy(got["state"]._replace(step=np.int32(11))))
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for g in got["state"].ebuf["emb"]:
        for f in g:
            assert f["hs"].dtype == torch.int64


# --- the comparison methods: python-int hash coefficients are static leaves ----------


def _method_trainer(method, ckpt_dir, seed=0):
    """A port Trainer of ``reduced(emb_method=method)`` on CPU, its
    momenta randomised."""
    tc = tcfg.reduced(emb_method=method)
    p, b = tdlrm.init(tc, torch.Generator().manual_seed(seed), device="cpu")
    opt = sgd(momentum=0.9)
    step = tloop.make_train_step(lambda pp, bb, mb: (tdlrm.bce_loss(pp, bb, tc, mb), {}), opt,
                                 lambda s: 0.05)
    state = tloop.init_state(p, opt, b)
    g = torch.Generator().manual_seed(seed + 1)
    for m in jax_leaves(state.opt):
        m.copy_(torch.randn(m.shape, generator=g))
    return tloop.Trainer(step, state, iter(()), ckpt_dir=str(ckpt_dir), ckpt_every=1)


def _jax_method_tree(method, step, seed=3):
    """JAX's checkpoint tree of ``reduced(emb_method=method)``: the dynamic
    buffers (None at python-int leaves) in the state, the ints static."""
    import dataclasses

    jc = dataclasses.replace(jcfg.reduced(emb_method=method), emb_use_kernel=False)
    opt = jsgd(momentum=0.9)
    tc = tcfg.reduced(emb_method=method)  # JAX's own init of TT-like tables is slow: numpy
    p, _ = tdlrm.init(tc, torch.Generator().manual_seed(seed), device="cpu")
    b = jc.collection.stack_buffers([t.init_buffers() for t in jc.collection.tables])
    dyn, static = jloop.split_buffers(b)
    state = jloop.init_state(convert.to_numpy(p), opt, dyn)._replace(step=np.int32(step))
    return {"state": state, "clusters_done": np.int32(0)}, static


def _static_leaves(tree):
    return [x for x in jax.tree.leaves(tree) if isinstance(x, int)]


@pytest.mark.parametrize("method", ["hash", "ce", "dhe"])
def test_method_checkpoint_port_to_jax(tmp_path, method):
    trainer = _method_trainer(method, tmp_path)
    trainer.state = trainer.state._replace(step=5)
    trainer.ckpt.save_async(5, trainer._ckpt_tree())
    trainer.ckpt.wait()
    tmpl, static = _jax_method_tree(method, 0)
    step, got, _ = jstore.load_checkpoint(str(tmp_path), template=tmpl)
    assert step == 5 and int(got["state"].step) == 5
    want = convert.to_numpy(trainer.state)
    for part in ("params", "opt"):
        for a, w in zip(jax.tree.leaves(getattr(got["state"], part)),
                        jax.tree.leaves(getattr(want, part))):
            np.testing.assert_array_equal(np.asarray(a), w)
    # the stored buffers are JAX's dynamic part; its static ints are the port's
    buffers = jloop.merge_buffers(got["state"].ebuf, static)
    assert _static_leaves(buffers) == _static_leaves(want.ebuf)
    if method != "dhe":
        assert _static_leaves(buffers) and not jax.tree.leaves(got["state"].ebuf)
    for a, w in zip(jax.tree.leaves(buffers), jax.tree.leaves(want.ebuf)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))


@pytest.mark.parametrize("method", ["hash", "ce", "dhe"])
def test_method_checkpoint_jax_to_port(tmp_path, method):
    tree, _ = _jax_method_tree(method, 9, seed=4)
    jstore.save_checkpoint(str(tmp_path), 9, tree)
    trainer = _method_trainer(method, tmp_path, seed=8)
    live = trainer.state.ebuf
    assert trainer.restore_latest() == 9 and trainer.state.step == 9
    st = trainer.state
    for a, w in zip(jax_leaves(convert.to_numpy(st.params)), jax.tree.leaves(tree["state"].params)):
        np.testing.assert_array_equal(a, np.asarray(w))
    for a, w in zip(jax_leaves(convert.to_numpy(st.opt)), jax.tree.leaves(tree["state"].opt)):
        np.testing.assert_array_equal(a, np.asarray(w))
    # python ints back in place, arrays restored as tensors
    assert _static_leaves(st.ebuf) == _static_leaves(live)
    for x in jax_leaves(st.ebuf):
        assert isinstance(x, int) or (isinstance(x, torch.Tensor) and x.dtype == torch.int32)
    # and the restored state trains
    tc = tcfg.reduced(emb_method=method)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in next(tdata(TClick(vocab_sizes=tc.vocab_sizes), 8)).items()}
    loss = tdlrm.bce_loss(st.params, st.ebuf, tc, batch)
    assert torch.isfinite(loss)
