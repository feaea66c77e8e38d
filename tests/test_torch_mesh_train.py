"""The (data, model) mesh over gloo ranks: the LMs' sharded train and
serve steps and the 2-D DLRM trainer, held against the unsharded port.

Three worlds run side by side, one ``torch.multiprocessing.spawn`` each
(a ``FileStore`` in ``tmp_path``, one thread a rank): a world of 1 (the
LMs at (1, 1)), of 2 (the LMs at (1, 2), the vlm, audio and moe families
at (2, 1) too, then DLRM at (2, 1) and (1, 2)) and of 4 (the LMs at (2,
2), then DLRM at (2, 2)).  This module imports nothing of JAX, so the ranks,
which import it, do not load it.

* The LM, reduced command-r-35b (parallel block, layernorm) and reduced
  qwen2-1.5b (QKV bias; 2 KV heads, and 1 KV head, which 2 model ranks
  hold whole): two ``build_train_step`` steps of 4 sequences of 16
  tokens in 2 micro-batches, then a 9-token prefill of 2 prompts and 2
  decode ticks through ``build_serve_step``.  Each rank holds its result
  against the unsharded step, prefill and decode of the same params:
  every loss, gnorm, param and adamw moment (gathered over the data and
  model groups), every logit and its cache slice.  Bit for bit at (1, 1);
  at (1, 2) and (2, 2) within ``TOL`` (float32 sums in another order),
  qwen2's key bias within lr x steps (its gradient is float noise, which
  adam scales to about ±lr; ``test_torch_lm_train.py``).
* The same for reduced paligemma-3b (tied CCE head, MQA held whole; its
  train batches carry ``patch_emb``), musicgen-medium (full table and
  head, 4 codebooks, MHA), phi3.5-moe (4 experts over the data axis,
  2 a rank at D = 2; ``moe_group`` 8 and 8-token prompts, so that a data
  rank's tokens are whole groups), hymba-1.5b with 10 query and 5 KV
  heads (2 model ranks hold 3 and 2 whole GQA groups; its SSM's channels
  split; the 9-token prompt runs past its window of 8) and xlstm-1.3b
  (one superblock: an mLSTM block's heads split, an sLSTM block's
  recurrence whole on each rank), at (1, 1), (1, 2), (2, 1) and (2, 2):
  at (2, 1) and (2, 2) the experts' gradients arrive whole through the
  all-to-alls and the clip's norm sums their slices over the data group.
  The moe step's "aux", summed over the data group, tracks the (1, 1)
  step's within ``TOL``.  hymba's and xlstm's ``ServeEngine`` on the model
  group gives every rank the unsharded engine's tokens.
* DLRM (reduced Criteo at cap 300, ``k_multiple`` M): 4 steps of
  ``build_dlrm_sharded_trainer`` on the mesh, a transition at step 3, a
  checkpoint at 4.  The data axis changes nothing but the order of float
  sums: the losses, params and moments track the trainer of one data
  replica and the same M within ``TOL``, its pointer tables and hash seeds
  exactly.  At M = 1 that is the 1-device trainer (dense tracker, the
  same batches and keys); at M = 2 the model-parallel trainer at (1, 2),
  whose sharded transition (k-means over the model group, JAX's sharded
  algorithm, ``test_torch_sharded.py``) is another clustering than the
  serial one.  The first 3 steps' losses track the 1-device trainer at
  every mesh.  The data replicas' shards are equal bit for bit; the
  checkpoint, written by data replica 0, restores into a 1-device trainer
  at ``k_multiple`` 1 bit for bit (through the per-feature view) and
  trains on.
"""
import argparse
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLDS = {1: [("lm", 1, 1), ("family", 1, 1)],
          2: [("lm", 1, 2), ("family", 1, 2), ("family", 2, 1), ("dlrm", 2, 1), ("dlrm", 1, 2)],
          4: [("lm", 2, 2), ("family", 2, 2), ("dlrm", 2, 2)]}
LM_CASES = {"command-r-35b": {}, "qwen2-1.5b": {}, "qwen2-1.5b-kv1": {"n_kv_heads": 1}}
FAMILY_CASES = {"paligemma-3b": {}, "musicgen-medium": {"n_kv_heads": 4},
                "phi3.5-moe-42b-a6.6b": {"moe_group": 8},
                "hymba-1.5b-kv5": {"n_heads": 10, "n_kv_heads": 5}, "xlstm-1.3b": {}}
ENGINE_CASES = ("hymba-1.5b-kv5", "xlstm-1.3b")  # served through ServeEngine(group=) too
MOE_PROMPT = 8  # a data rank's prompt: one whole group
TOL = dict(rtol=1e-4, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
KEY_BIAS = "['blocks']['attn']['bk']"
SEQ, BATCH, MICRO = 16, 4, 2  # two micro-batches of two sequences
PROMPT, MAX_SEQ, TICKS = 9, 16, 2
LR_STEP1 = 3e-4 / 100  # the schedule's second lr (the first is 0)
CAP, B, STEPS, SEED = 300, 32, 4, 0


def _arch(case):
    return case.split("-kv")[0]


def _worst(got, want, tol, paths=None, bias_atol=None):
    """(the largest |got - want| over its allowance, its leaf) over
    paired numpy leaves: <= 1 passes."""
    worst, where = 0.0, ""
    for i, (a, b) in enumerate(zip(got, want)):
        path = paths[i] if paths else str(i)
        rt, at = (0.0, bias_atol) if bias_atol and path == KEY_BIAS else (tol["rtol"], tol["atol"])
        r = float(np.max(np.abs(a - b) / (at + rt * np.abs(b)), initial=0.0))
        if r > worst:
            worst, where = r, path
    return worst, where


def _np_leaves(tree):
    from repro_torch import convert
    from repro_torch.tree import jax_leaves_with_paths

    pairs = jax_leaves_with_paths(convert.to_numpy(tree))
    return [p for p, _ in pairs], [np.asarray(x, dtype=np.float64) for _, x in pairs]


def _record(res, tag, got, want, tol, *, bias_atol=None):
    paths, g = _np_leaves(got)
    _, w = _np_leaves(want)
    assert len(g) == len(w), (tag, len(g), len(w))
    res[f"{tag}/exact"] = np.array(all(np.array_equal(a, b) for a, b in zip(g, w)))
    worst, where = _worst(g, w, tol, paths, bias_atol)
    res[f"{tag}/worst"] = np.array(worst)
    res[f"{tag}/where"] = np.array(where)


def _lm(case, overrides, mesh, res):
    """One LM case on ``mesh``: the sharded train and serve steps against
    the unsharded ones, results under ``{case}@{D}x{M}/``."""
    from repro_torch import configs
    from repro_torch.launch import shapes, steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.shard import gather_tree, shard_tree
    from repro_torch.train import loop
    from repro_torch.tree import tree_map

    D, M = mesh.shape["data"], mesh.shape["model"]
    tag = f"{case}@{D}x{M}"
    cfg = configs.get_reduced(_arch(case), train_microbatch=MICRO, **overrides)
    params, buffers = lm.init(cfg, torch.Generator().manual_seed(7), device="cpu")
    opt = adamw(weight_decay=0.1)
    rng = np.random.default_rng(11)
    nc = (cfg.n_codebooks,) if cfg.n_codebooks else ()

    def batch():
        b = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (BATCH // MICRO, MICRO, SEQ, *nc)))}
        if cfg.family == "vlm":
            b["patch_emb"] = torch.from_numpy(rng.standard_normal(
                (BATCH // MICRO, MICRO, cfg.n_patches, cfg.d_model), dtype=np.float32))
        return b

    batches = [batch() for _ in range(2)]

    step, _, specs = steps.build_train_step(cfg, mesh, shape=shapes.Shape("t", SEQ, BATCH, "train"))
    state = steps.shard_state(loop.init_state(tree_map(torch.clone, params), opt, buffers),
                              specs, mesh)
    ref_step = loop.make_train_step(lambda p, b, mb: lm.next_token_loss(p, b, cfg, mb), opt,
                                    cosine_schedule(3e-4, 100, 10_000), accum=BATCH // MICRO,
                                    clip_norm=1.0)
    ref = loop.init_state(tree_map(torch.clone, params), opt, buffers)
    got_m, ref_m = [], []
    for b in batches:
        state, m = step(state, b)
        ref, rm = ref_step(ref, b)
        got_m += [m["loss"], m["gnorm"]]
        ref_m += [rm["loss"], rm["gnorm"]]
        if "aux" in m:
            res[f"{tag}/aux"] = np.append(res.get(f"{tag}/aux", []), float(m["aux"]))
    _record(res, f"{tag}/metrics", got_m, ref_m, TOL)
    whole = gather_tree(gather_tree(state.params, specs.params, mesh.data, axis="data"),
                        specs.params, mesh.model)
    _record(res, f"{tag}/params", whole, ref.params, TOL, bias_atol=2 * LR_STEP1)
    moments = gather_tree(gather_tree(state.opt, specs.opt, mesh.data, axis="data"),
                          specs.opt, mesh.model)
    _record(res, f"{tag}/moments", moments, ref.opt, TOL)

    prefill, _, (pspecs, cspecs) = steps.build_serve_step(
        cfg, mesh, "p", shape=shapes.Shape("p", MAX_SEQ, 2, "prefill"))
    decode, _, _ = steps.build_serve_step(cfg, mesh, "d",
                                          shape=shapes.Shape("d", MAX_SEQ, 2, "decode"))
    local = steps.shard_state(params, pspecs, mesh)
    if cfg.family == "moe":
        res[f"{tag}/experts"] = np.array([local["blocks"]["moe"]["wi"].shape[1],
                                          state.params["blocks"]["moe"]["wi"].shape[1]])
    cache = lm.init_cache(cfg, 2 // D, MAX_SEQ, device="cpu", group=mesh.model)
    ref_cache = lm.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    prompt = MOE_PROMPT if cfg.family == "moe" else PROMPT
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt, *nc)))
    got_l, ref_l = [], []
    with torch.no_grad():
        lg, cache = prefill(local, buffers, tokens, cache)
        rl, ref_cache = lm.prefill(params, buffers, cfg, tokens, ref_cache)
        got_l.append(lg)
        ref_l.append(rl)
        for t in range(TICKS):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, *nc)))
            pos = torch.full((2,), prompt + t, dtype=torch.int64)
            lg, cache = decode(local, buffers, nxt, pos, cache)
            rl, ref_cache = lm.decode_step(params, buffers, cfg, nxt, pos, ref_cache)
            got_l.append(lg)
            ref_l.append(rl)
    _record(res, f"{tag}/logits", got_l, ref_l, SERVE_TOL)
    # this rank's slice of the unsharded cache: its batch rows, its KV heads
    want = shard_tree(shard_tree(ref_cache, cspecs, mesh.coords[1], M), cspecs,
                      mesh.coords[0], D, "data")
    _record(res, f"{tag}/cache", cache, want, SERVE_TOL)
    if case in ENGINE_CASES:
        res[f"{tag}/engine"] = np.array(_engine_tokens(cfg, local, buffers, mesh.model)
                                        == _engine_tokens(cfg, params, buffers, None))


def _engine_tokens(cfg, params, buffers, group):
    """The tokens ``ServeEngine`` generates for 3 prompts over 2 slots."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, buffers, max_batch=2, max_seq=MAX_SEQ, group=group)
    rng = np.random.default_rng(13)
    for uid, n in enumerate((5, PROMPT, 3)):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab, n), max_tokens=3))
    return sorted((r.uid, r.generated) for r in eng.run())


def _dlrm_cfg(k_multiple):
    from repro_torch.configs import dlrm_criteo

    return dlrm_criteo.reduced(cap=CAP, k_multiple=k_multiple)


def _args(ckpt_dir=None, ckpt_every=0, cluster_every=3, seed=SEED):
    return argparse.Namespace(emb="cce", emb_cap=CAP, seed=seed, batch=B, accum=1, lr=0.05,
                              momentum=0.9, clip=1.0, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                              cluster_every=cluster_every, fail_at=[], device="cpu")


def _per_feature(cfg, state) -> list:
    """The emb params, moments and buffers through the per-feature view and
    the MLPs (numpy, ``jax.tree`` order): equal for two states that differ
    only in ``k_multiple`` padding."""
    from repro_torch import convert
    from repro_torch.tree import jax_leaves

    coll = cfg.collection
    trees = [coll.unstack_params(state.params["emb"]), coll.unstack_params(state.opt["m"]["emb"]),
             coll.unstack_buffers(state.ebuf["emb"]), state.params["bottom"], state.params["top"]]
    return [np.asarray(x) for x in jax_leaves(convert.to_numpy(trees))]


def _dlrm(mesh, out, res):
    """The 2-D DLRM trainer on ``mesh``; rank 0 keeps its losses and whole
    state and restores its checkpoint into a 1-device trainer.  Results
    under ``dlrm@{D}x{M}/``; every rank's shard under ``.../local``."""
    from repro_torch.launch.train import build_dlrm_sharded_trainer, build_dlrm_trainer
    from repro_torch.shard import gather_tree
    from repro_torch.tree import tree_leaves

    D, M = mesh.shape["data"], mesh.shape["model"]
    tag = f"dlrm@{D}x{M}"
    ckpt = os.path.join(out, f"{tag}-ckpt")
    cfg = _dlrm_cfg(M)
    tr = build_dlrm_sharded_trainer(cfg, _args(ckpt, ckpt_every=STEPS), mesh=mesh)
    tr.run(STEPS)
    for i, x in enumerate(tree_leaves(tr.state)):
        res[f"{tag}/local/{i}"] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    whole = gather_tree(tr.state, tr.specs, mesh.model)
    dist.barrier()  # data replica 0's checkpoint is written
    if mesh.rank != 0:
        return
    res[f"{tag}/clusters"] = np.array(tr.clusters_done)
    res[f"{tag}/losses"] = np.array([h["loss"] for h in tr.history])
    for part in ("params", "opt", "ebuf"):
        for i, x in enumerate(_np_leaves(getattr(whole, part))[1]):
            res[f"{tag}/{part}/{i}"] = x
    cfg1 = _dlrm_cfg(1)
    one = build_dlrm_trainer(cfg1, _args(ckpt, seed=SEED + 1))
    res[f"{tag}/restored_step"] = np.array(one.restore_latest())
    res[f"{tag}/restored_exact"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(_per_feature(cfg1, one.state),
                                             _per_feature(cfg, whole))))
    one.run(1)
    res[f"{tag}/restored_loss"] = np.array(one.history[-1]["loss"])


def _rank_main(rank, world, store, out):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, init_model_group

    init_model_group("cpu", world_size=world, rank=rank, store=dist.FileStore(store, world))
    res = {}
    for kind, D, M in WORLDS[world]:
        mesh = Mesh(D, M)
        res[f"coords@{D}x{M}"] = np.array(mesh.coords)
        res[f"groups@{D}x{M}"] = np.array([dist.get_process_group_ranks(mesh.model),
                                           dist.get_process_group_ranks(mesh.data)],
                                          dtype=object)
        if kind in ("lm", "family"):
            for case, overrides in (LM_CASES if kind == "lm" else FAMILY_CASES).items():
                _lm(case, overrides, mesh, res)
        else:
            _dlrm(mesh, out, res)
    np.savez(os.path.join(out, f"{rank}.npz"), **res)
    dist.destroy_process_group()


def _one_device():
    """The 1-device DLRM trainer's losses and state leaves (k_multiple 1)."""
    from repro_torch.launch.train import build_dlrm_trainer

    tr = build_dlrm_trainer(_dlrm_cfg(1), _args())
    tr.run(STEPS)
    res = {"losses": np.array([h["loss"] for h in tr.history])}
    for part in ("params", "opt", "ebuf"):
        for i, x in enumerate(_np_leaves(getattr(tr.state, part))[1]):
            res[f"{part}/{i}"] = x
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's results]}, the worlds spawned side by side, and
    the 1-device DLRM trainer's run under "one", made meanwhile."""
    dirs = {w: tmp_path_factory.mktemp(f"mesh{w}") for w in WORLDS}
    ctxs = [mp.spawn(_rank_main, args=(w, str(d / "store"), str(d)), nprocs=w, join=False)
            for w, d in dirs.items()]
    out = {"one": _one_device()}
    for ctx in ctxs:
        while not ctx.join():
            pass
    out.update({w: [dict(np.load(d / f"{r}.npz", allow_pickle=True)) for r in range(w)]
                for w, d in dirs.items()})
    return out


# the families run on meshes the LM's and DLRM's cases already lay out
MESHES = [(w, D, M) for w, runs in WORLDS.items() for k, D, M in runs if k != "family"]


@pytest.mark.parametrize("world,D,M", MESHES)
def test_rank_layout(runs, world, D, M):
    """World rank r at (r // M, r % M); its model group the ranks of its
    data index, its data group those of its model index."""
    for r, res in enumerate(runs[world]):
        assert tuple(res[f"coords@{D}x{M}"]) == (r // M, r % M)
        model, data = res[f"groups@{D}x{M}"]
        assert list(model) == [r // M * M + m for m in range(M)]
        assert list(data) == [d * M + r % M for d in range(D)]


LM_MESHES = [(w, D, M) for w, runs in WORLDS.items() for k, D, M in runs if k == "lm"]
FAMILY_MESHES = [(w, D, M) for w, runs in WORLDS.items() for k, D, M in runs if k == "family"]
WHAT = ["metrics", "params", "moments", "logits", "cache"]


def _check_lm(runs, world, D, M, case, what):
    for r, res in enumerate(runs[world]):
        key = f"{case}@{D}x{M}/{what}"
        if (D, M) == (1, 1):
            assert bool(res[f"{key}/exact"]), f"rank {r}: {key} differs at (1, 1)"
        worst = float(res[f"{key}/worst"])
        assert worst <= 1.0, f"rank {r}: {key} {worst} x its tolerance at {res[f'{key}/where']}"


@pytest.mark.parametrize("case", sorted(LM_CASES))
@pytest.mark.parametrize("world,D,M", LM_MESHES)
@pytest.mark.parametrize("what", WHAT)
def test_lm_steps_match_the_unsharded_port(runs, world, D, M, case, what):
    _check_lm(runs, world, D, M, case, what)


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
@pytest.mark.parametrize("world,D,M", FAMILY_MESHES)
@pytest.mark.parametrize("what", WHAT)
def test_family_steps_match_the_unsharded_port(runs, world, D, M, case, what):
    _check_lm(runs, world, D, M, case, what)


@pytest.mark.parametrize("world,D,M", [m for m in FAMILY_MESHES if m[1:] != (1, 1)])
def test_moe_aux_is_summed_over_the_data_group(runs, world, D, M):
    """The step's load-balancing loss: every rank reports the (1, 1)
    step's, the unsharded one, within TOL."""
    key = "phi3.5-moe-42b-a6.6b@{}x{}/{}"
    want = runs[1][0][key.format(1, 1, "aux")]
    assert want.shape == (2,) and np.all(np.isfinite(want))
    for res in runs[world]:
        np.testing.assert_allclose(res[key.format(D, M, "aux")], want, **TOL)
        assert list(res[key.format(D, M, "experts")]) == [4 // D] * 2  # a rank's experts


@pytest.mark.parametrize("case", ENGINE_CASES)
@pytest.mark.parametrize("world,D,M", FAMILY_MESHES)
def test_engine_serves_on_the_model_group(runs, world, D, M, case):
    for r, res in enumerate(runs[world]):
        assert bool(res[f"{case}@{D}x{M}/engine"]), f"rank {r}: {case} at ({D}, {M})"


DLRM_MESHES = [(w, D, M) for w, runs in WORLDS.items() for k, D, M in runs if k == "dlrm"]
DLRM_2D = [(w, D, M) for w, D, M in DLRM_MESHES if D > 1]


def _dlrm_run(runs, D, M):
    """Rank 0's DLRM record at (D, M) ("one": the 1-device trainer), keys
    without their tag."""
    if (D, M) == (1, 1):
        return runs["one"]
    world = D * M
    tag = f"dlrm@{D}x{M}/"
    return {k[len(tag):]: v for k, v in runs[world][0].items() if k.startswith(tag)}


@pytest.mark.parametrize("world,D,M", DLRM_2D)
def test_dlrm_tracks_the_trainer_of_one_data_replica(runs, world, D, M):
    got, want = _dlrm_run(runs, D, M), _dlrm_run(runs, 1, M)
    assert int(got["clusters"]) == 1
    np.testing.assert_allclose(got["losses"][:3], runs["one"]["losses"][:3], **TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    for part, tol in (("ebuf", dict(rtol=0, atol=0)), ("params", TOL), ("opt", TOL)):
        keys = [k for k in want if k.startswith(part + "/")]
        assert keys and len(keys) == len([k for k in got if k.startswith(part + "/")])
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("world,D,M", DLRM_MESHES)
def test_dlrm_data_replicas_are_equal(runs, world, D, M):
    tag = f"dlrm@{D}x{M}/local/"
    for m in range(M):
        base = runs[world][m]
        keys = sorted(k for k in base if k.startswith(tag))
        assert keys
        for d in range(1, D):
            other = runs[world][d * M + m]
            for k in keys:
                np.testing.assert_array_equal(other[k], base[k], err_msg=k)


@pytest.mark.parametrize("world,D,M", DLRM_MESHES)
def test_dlrm_checkpoint_restores_into_a_1device_trainer(runs, world, D, M):
    res = runs[world][0]
    tag = f"dlrm@{D}x{M}"
    assert int(res[f"{tag}/restored_step"]) == STEPS
    assert bool(res[f"{tag}/restored_exact"])
    assert np.isfinite(float(res[f"{tag}/restored_loss"]))
