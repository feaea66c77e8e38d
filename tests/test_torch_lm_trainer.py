"""Port vs JAX package: LM training through ``launch.train.build_lm_trainer``
on reduced configs (2 layers, d 64, vocab 257, float32) on the CPU.

* The whole slice: both packages' ``build_lm_trainer`` from JAX's initial
  state (the JAX trainer's state crosses into the port's), 3 steps, a
  transition of the CCE token table (dense token counts, adamw moments
  remapped) and 2 more steps, on reduced qwen2-1.5b, qwen3-4b,
  xlstm-1.3b, paligemma-3b (text batches; its tied table is also the
  head, which reads the re-clustered table after the transition) and
  musicgen-medium under CCE (no tracker: its codebook
  tokens are not its table's rows, so its transition samples the rows
  uniformly), with JAX's kmeans++ seeds handed to the port (its float
  draws are not JAX's; ``test_torch_transition.py`` does the same): every
  loss within 1e-5 relative, ptr/hs/epoch and the token counts equal,
  params and moments within rtol 1e-4 / atol 1e-6 -- but the param
  entries named in ``NOISE`` whose gradients are float noise (JAX's adam
  sqrt(v) under ``NOISE_RMS``), held within lr x steps (see
  ``test_torch_lm_train.py``'s adamw test).
* JAX's LM checkpoint resumes in the port's Trainer, every leaf equal.
* A port LM Trainer crashed and resumed ends where an uninterrupted one
  ends, bit for bit.
* ``python -m repro_torch.launch.train --arch qwen2-1.5b --device cpu``
  trains, clusters and resumes, ``--arch xlstm-1.3b`` trains and clusters
  at steps 3 and 6, ``--arch musicgen-medium`` trains its reduced CCE
  model (JAX's launcher gives that table no budget and fails) and
  clusters at steps 2 and 4; an unported architecture raises and names
  its family; the options both launchers share have the same defaults."""
import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import kmeans as jkm
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import kmeans as tkm
from repro_torch.launch import train as tlaunch
from repro_torch.tree import jax_leaves, jax_leaves_with_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# QKV bias; qk_norm; mLSTM and sLSTM; a tied table, GELU, MQA; codebooks, layernorm
# and sinusoidal positions
ARCHS = ("qwen2-1.5b", "qwen3-4b", "xlstm-1.3b", "paligemma-3b", "musicgen-medium")
# musicgen-medium keeps a full table: under CCE its reduced config takes the
# budget the port's launcher gives it
OVERRIDES = {"musicgen-medium": dict(emb_method="cce", emb_budget=tlaunch.REDUCED_EMB_BUDGET)}
STEPS = 5
CLUSTER_EVERY = 3
LR = 3e-3
LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
# a param entry whose gradient RMS (JAX's adam sqrt(v)) is below this is
# float noise beside its leaf's (~1e-3 to 1e-2), and adam moves it ~lr a
# step whatever its size
NOISE_RMS = 1e-6
# arch -> {param leaf: the entries of it that may be noise}; of those, the
# ones under NOISE_RMS are held within lr x steps, every other entry of
# every leaf at STEP_TOL.  qwen2-1.5b's key bias (softmax drops a bias every
# key shares); xlstm's input-gate biases, the mLSTM's bi and the sLSTM's
# b[d:2d] (the normalisers divide a shift of every input
# gate out); one xlstm token-table entry whose gradients cancel (measured
# sqrt(v) 1.5e-7, off JAX by 1.9e-6)
_D = tconfigs.get_reduced("xlstm-1.3b").d_model
NOISE = {"qwen2-1.5b": {"['blocks']['attn']['bk']": np.s_[...]},
         "xlstm-1.3b": {"['blocks']['mlstm']['bi']": np.s_[...],
                        "['blocks']['slstm']['b']": np.s_[..., _D:2 * _D],
                        "['emb']['tables']": np.s_[1, 1, 7, 3]}}


def _reduced(configs, arch):
    return configs.get_reduced(arch, **OVERRIDES.get(arch, {}))


def _args(ckpt_dir=None, **kw):
    base = dict(seed=3, lr=LR, warmup=1, steps=STEPS, batch=2, seq=16, accum=1,
                ckpt_dir=ckpt_dir, ckpt_every=STEPS if ckpt_dir else 0,
                cluster_every=CLUSTER_EVERY, fail_at=[], emb="cce", device="cpu")
    return argparse.Namespace(**dict(base, **kw))


def _jax_seeds(key, x, k, weights=None):
    """The JAX package's kmeans++ on the port's (bit-identical) inputs."""
    return torch.from_numpy(np.array(jkm.kmeans_plus_plus(
        jnp.asarray(np.asarray(key, np.uint32)), jnp.asarray(x.numpy()), k,
        None if weights is None else jnp.asarray(weights.numpy()))))


def _np_leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module", params=ARCHS)
def both(request, tmp_path_factory):
    arch = request.param
    jdir = str(tmp_path_factory.mktemp("jax_lm_ckpt"))
    jtr = jlaunch.build_lm_trainer(_reduced(jconfigs, arch), _args(jdir))
    start = jax.tree.map(np.array, jtr.state)  # copies: the jitted step donates the state
    jtr.run(STEPS)
    ttr = tlaunch.build_lm_trainer(_reduced(tconfigs, arch), _args())
    ttr.state = convert.train_state_to_torch(start, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tkm, "kmeans_plus_plus", _jax_seeds)
        ttr.run(STEPS)
    return dict(arch=arch, jtr=jtr, ttr=ttr, jdir=jdir)


def test_slice_tracks_jax_through_a_transition(both):
    jtr, ttr = both["jtr"], both["ttr"]
    jh, th = list(jtr.history), list(ttr.history)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(STEPS))
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=LOSS_RTOL)
    assert ttr.clusters_done == jtr.clusters_done == 1
    assert ttr.state.step == int(jtr.state.step) == STEPS
    got, want = jax_leaves(convert.to_numpy(ttr.state.ebuf)), _np_leaves(jtr.state.ebuf)
    tied = _reduced(tconfigs, both["arch"]).tie_embeddings
    # ptr, hs, epoch of the token table, and of the head unless it is the table
    assert len(got) == len(want) == (3 if tied else 6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(ttr.state.ebuf["emb"]["epoch"]) == 1
    assert tied or int(ttr.state.ebuf["head"]["epoch"]) == 0
    if both["arch"] == "musicgen-medium":
        assert ttr.id_tracker is None and jtr.id_tracker is None
    else:
        np.testing.assert_array_equal(ttr.id_tracker.counts[0], jtr.id_tracker.counts[0])
        assert ttr.id_tracker.counts[0].sum() == STEPS * 2 * 16
    named = NOISE.get(both["arch"], {})
    rms = [np.sqrt(v) for v in _np_leaves(jtr.state.opt["v"])]  # in the params' leaf order
    for got, want in ((ttr.state.params, jtr.state.params), (ttr.state.opt, jtr.state.opt)):
        g, w = jax_leaves_with_paths(convert.to_numpy(got)), _np_leaves(want)
        assert len(g) == len(w)
        if got is ttr.state.params:
            assert set(named) <= {path for path, _ in g} and len(rms) == len(g)
        for i, ((path, a), b) in enumerate(zip(g, w)):
            noise = np.zeros(b.shape, bool)
            if got is ttr.state.params and path in named:
                noise[named[path]] = True
                noise &= rms[i] < NOISE_RMS
                assert noise.any(), path  # the named entries are float noise
            np.testing.assert_allclose(a[noise], b[noise], rtol=0, atol=LR * STEPS)
            np.testing.assert_allclose(a[~noise], b[~noise], **STEP_TOL)


def test_jax_lm_checkpoint_resumes_in_port(both):
    jtr, cfg = both["jtr"], _reduced(tconfigs, both["arch"])
    tr = tlaunch.build_lm_trainer(cfg, _args(both["jdir"], seed=11))
    assert tr.restore_latest() == STEPS
    assert tr.state.step == STEPS and tr.clusters_done == 1
    for got, want in ((tr.state.params, jtr.state.params), (tr.state.opt, jtr.state.opt),
                      (tr.state.ebuf, jtr.state.ebuf)):
        g, w = jax_leaves(convert.to_numpy(got)), _np_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    if tr.id_tracker is not None:
        np.testing.assert_array_equal(tr.id_tracker.counts[0], jtr.id_tracker.counts[0])
    tr.ckpt = None  # train on without writing into JAX's directory
    tr.data_iter = tlaunch.lm_data(cfg, _args())(STEPS)
    hist = tr.run(1)
    assert [h["step"] for h in hist] == [STEPS] and np.isfinite(hist[0]["loss"])


def test_port_crash_and_resume_is_bit_exact(tmp_path):
    """A crash at step 5 (after the transition at 3), a restore from the
    checkpoint at 4 and a replay to 6 end bit for bit where an
    uninterrupted run ends."""
    cfg = tconfigs.get_reduced("qwen2-1.5b")
    kw = dict(steps=6, ckpt_every=2)
    clean = tlaunch.build_lm_trainer(cfg, _args(str(tmp_path / "a"), **kw))
    clean.run(6)
    args = _args(str(tmp_path / "b"), fail_at=[5], **kw)
    tr = tlaunch.build_lm_trainer(cfg, args)
    assert tlaunch.run_with_restart(tr, 6, tlaunch.lm_data(cfg, args)) == [4]
    assert tr.clusters_done == clean.clusters_done == 2
    for got, want in ((tr.state.params, clean.state.params), (tr.state.opt, clean.state.opt),
                      (tr.state.ebuf, clean.state.ebuf)):
        assert all(torch.equal(a, b) for a, b in zip(jax_leaves(got), jax_leaves(want)))
    np.testing.assert_array_equal(tr.id_tracker.counts[0], clean.id_tracker.counts[0])
    clean_loss = {h["step"]: h["loss"] for h in clean.history}
    assert sorted({h["step"] for h in tr.history}) == list(range(6))
    assert all(h["loss"] == clean_loss[h["step"]] for h in tr.history)


def test_main_trains_clusters_and_resumes_on_cpu(tmp_path, capsys):
    tr = tlaunch.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "6",
                       "--batch", "4", "--seq", "16", "--cluster-every", "3",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--fail-at", "5"])
    assert tr.state.step == 6 and tr.clusters_done == 2
    assert int(tr.state.ebuf["emb"]["epoch"]) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    out = capsys.readouterr().out
    assert "resumed from the checkpoint at step 4" in out and "clusterings 2" in out
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--trigger"])


def test_main_trains_xlstm_and_clusters_twice_on_cpu(capsys):
    """``--arch xlstm-1.3b`` trains the reduced xlstm (an mLSTM and an sLSTM
    block) and re-clusters its token table at steps 3 and 6."""
    tr = tlaunch.main(["--arch", "xlstm-1.3b", "--device", "cpu", "--steps", "6",
                       "--cluster-every", "3"])
    assert tr.state.step == 6 and tr.clusters_done == 2
    assert int(tr.state.ebuf["emb"]["epoch"]) == 2 and int(tr.state.ebuf["head"]["epoch"]) == 0
    assert set(tr.state.params["blocks"]) == {"mlstm", "slstm", "norms"}
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert "xlstm-1.3b on cpu: step 6" in capsys.readouterr().out


def test_main_trains_musicgen_under_cce_and_clusters_twice_on_cpu(capsys):
    """``--arch musicgen-medium`` under the default ``--emb cce``: JAX's
    reduced config has no budget for the table there (its launcher fails),
    the port's launcher gives it ``REDUCED_EMB_BUDGET``; no tracker, the
    transitions at steps 2 and 4 sample the 4 x 257 rows uniformly."""
    with pytest.raises(TypeError):
        jlm.make_emb(jconfigs.get_reduced("musicgen-medium", emb_method="cce"))
    tr = tlaunch.main(["--arch", "musicgen-medium", "--device", "cpu", "--steps", "4",
                       "--cluster-every", "2"])
    assert tr.id_tracker is None and tr.state.step == 4 and tr.clusters_done == 2
    assert int(tr.state.ebuf["emb"]["epoch"]) == 2 and int(tr.state.ebuf["head"]["epoch"]) == 0
    assert tuple(tr.state.ebuf["emb"]["ptr"].shape) == (4, 4 * 257)
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert "musicgen-medium on cpu: step 4" in capsys.readouterr().out


def test_unported_arch_raises_and_names_its_family(monkeypatch):
    """Every configuration of the JAX package is ported (``UNPORTED`` is
    empty): the launcher trains reduced command-r-35b, the last one ported;
    a name put in ``UNPORTED`` raises with its family."""
    assert set(tconfigs.ARCHS) | set(tconfigs.UNPORTED) == set(jconfigs.ARCHS)
    assert not set(tconfigs.ARCHS) & set(tconfigs.UNPORTED) and not tconfigs.UNPORTED
    tr = tlaunch.main(["--arch", "command-r-35b", "--device", "cpu", "--steps", "2"])
    assert tr.state.step == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    monkeypatch.setitem(tconfigs.UNPORTED, "command-r-35b", "dense")
    with pytest.raises(NotImplementedError, match="dense family"):
        tconfigs.get_reduced("command-r-35b")


def test_launcher_defaults_match_jax(monkeypatch):
    """Every option the two launchers share has the JAX package's default
    (JAX's ``main`` parses ``sys.argv``: its DLRM builder is stubbed to hand
    back what it parsed)."""

    class Parsed(Exception):
        pass

    def capture(args):
        raise Parsed(args)

    monkeypatch.setattr(jlaunch, "build_dlrm_trainer", capture)
    monkeypatch.setattr(sys, "argv", ["train"])
    with pytest.raises(Parsed) as parsed:
        jlaunch.main()
    jargs = vars(parsed.value.args[0])
    targs = vars(tlaunch.parser().parse_args([]))
    shared = set(jargs) & set(targs)
    assert shared >= {"arch", "steps", "batch", "seq", "accum", "lr", "momentum", "warmup",
                      "emb", "emb_cap", "cluster_every", "ckpt_dir", "ckpt_every", "fail_at",
                      "seed", "obs", "profile_steps", "profile_dir"}
    assert {k: targs[k] for k in shared} == {k: jargs[k] for k in shared}
