"""The (data, model) mesh's layout, with no processes: the port's specs
against the JAX package's, at full size.

* ``lm.param_specs``: the dims each leaf splits over the model and the
  data axes equal the JAX ``PartitionSpec``'s "model" and "data" entries
  (``ep="data"``: the moe family's experts over the data axis), for
  qwen2-1.5b, qwen3-4b, qwen3-14b, command-r-35b, paligemma-3b,
  musicgen-medium, phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b at 2, 4
  and 8 model ranks (where the port splits the query heads), command-r
  at 16, and hymba-1.5b and xlstm-1.3b at 2 and 4.  The named deviations
  of a dim: where M does not divide the KV heads but is a multiple of
  them (qwen2's 2 at 4 ranks, paligemma's 1, qwen3-moe's 4 at 8) the JAX
  package splits wk, wv (and bk, bv) through half heads and the port holds
  them whole; the mLSTM's wi and wf split their head columns (JAX: their
  rows) and bi and bf their heads (JAX: whole).  The named deviations of
  a cut (``Spec.parts``, ``Spec.blocks``), on the dims JAX splits:
  hymba's 25 query and 5 KV heads, which 2 and 4 ranks divide neither,
  cut into whole GQA groups (3 / 2 and 2 / 1 / 1 / 1) where JAX cuts
  evenly through heads; the SSM's in_proj and the mLSTM's and sLSTM's
  ``up`` split each of their two halves, where JAX splits the
  concatenation.
* ``zero1_specs`` and ``moment_specs`` equal JAX's on the same shapes
  (``jax.eval_shape`` of JAX's ``lm.init``) at 1, 2 and 16 data ranks
  (the other families at 2, 4 and 8, which split the experts), the
  deviation's leaves excepted, which take the data axis on another dim
  than JAX's model-split one.
* ``lm.cache_specs``: the batch over the data axis, as JAX's; over the
  model axis the KV heads (dim 3) where JAX splits head_dim (dim 4), or
  nothing where the heads do not split (the second named deviation);
  hymba's SSM state and conv input their channels, as JAX's; xlstm's
  mLSTM C, n and m their heads (JAX: C's and n's head_dim, m whole), its
  sLSTM states whole on every rank (JAX: d split), since each rank runs
  the whole recurrence.
* ``abstract_state`` (the meta device) has JAX's shapes and dtypes, and
  the port's ``n_params`` command-r's count of 28,448,530,432, for every
  family with a sharded layout.
* ``shapes.SHAPES``, ``applicable`` and ``microbatch`` equal JAX's.
* ``Mesh``: world rank r sits at (r // M, r % M) with its groups' ranks,
  every rank making every subgroup in one order (``torch.distributed``
  stubbed).
* The model axis emulated in one process: each rank's share
  (``lm.embed_share``, ``prefill_attention_share``, ``parallel_share``
  or ``layers.mlp_partial``, ``head_share``) on its slices, the
  collectives replaced by a concatenation and sums in rank order, equals
  the unsharded ``prefill``'s logits and cache for reduced command-r,
  qwen2-1.5b, paligemma-3b (its tied CCE head; ``lm.patch_share``'s
  columns against the projection), musicgen-medium (its full table's
  columns, its full head's vocabulary slices through ``lm.vocab_share``)
  and phi3.5-moe (each rank's experts' ff slices), hymba-1.5b (its 4 / 2
  heads, and 10 / 5, which 2 and 4 ranks cut into uneven whole GQA
  groups; the SSM's projection summed between ``ssm.ssm_project`` and
  ``ssm_scan``, the branches mixed by ``lm.hybrid_mix``) and xlstm-1.3b
  (the mLSTM's x half gathered between ``xlstm.mlstm_up`` and
  ``mlstm_heads``, the sLSTM's pre-activations between ``slstm_input``
  and ``slstm_recur``, its FFN's partial sums by ``slstm_ffn``) at 2 and
  4 model ranks (float32, rtol 1e-5 of the largest magnitude; the
  lookup's slices bit for bit).
* The data axis of the moe family emulated: 2 and 4 data ranks (and 2 x
  2), each routing its own groups (``moe.dispatch``), the all-to-alls
  replaced by transposes in rank order, each rank's experts
  (``moe.grouped_experts``) on every rank's slots: the routing equals the
  unsharded one exactly, the output and the load-balancing loss within
  rtol 1e-5, for the einsum and the sort routes.  A data axis that does
  not split the experts, or a rank's tokens that are not whole groups,
  raise by name.
* The options without a sharded layout raise by name; ``zero1`` on one
  rank is adamw bit for bit; the tensor-parallel collectives are the
  identity without a group; ``shard_tree`` and ``gather_tree`` invert
  each other under uneven and blocked cuts; one sLSTM block under a group
  of 2 runs one all-gather and one all-reduce forward, whatever the
  sequence's length: none inside its per-token loop.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import lm as jlm
from repro.optim import optimizers as joptim
from repro_torch import configs as tconfigs
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as toptim
from repro_torch.shard import Spec
from repro_torch.tree import jax_leaves_with_paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread in this module: beside the suite's other
    workers its threads would wait on each other at every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("qwen2-1.5b", "qwen3-4b", "qwen3-14b", "command-r-35b")
FAMILIES = ("paligemma-3b", "musicgen-medium", "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
RECURRENT = ("hymba-1.5b", "xlstm-1.3b")
CASES = [(a, m) for a in ARCHS + FAMILIES for m in (2, 4, 8)
         if tconfigs.get(a).n_heads % m == 0] + [("command-r-35b", 16)]
RECURRENT_CASES = [(a, m) for a in RECURRENT for m in (2, 4)]
KV_LEAVES = ("['wk']", "['wv']", "['bk']", "['bv']")
GATE_LEAVES = ("['mlstm']['wi']", "['mlstm']['wf']", "['mlstm']['bi']", "['mlstm']['bf']")
HEAD_LEAVES = ("['attn']['wq']", "['attn']['wk']", "['attn']['wv']", "['attn']['wo']",
               "['attn']['bq']", "['attn']['bk']", "['attn']['bv']")
HALVES_LEAVES = ("['ssm']['in_proj']", "['mlstm']['up']", "['slstm']['up']")
_SHAPES = {}


def _jax_shapes(arch):
    if arch not in _SHAPES:
        cfg = jconfigs.get(arch)
        _SHAPES[arch] = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), cfg))[0]
    return _SHAPES[arch]


def _jax_dims(spec_tree, axis):
    """{path: the dim the leaf's PartitionSpec splits over ``axis``}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(spec_tree,
                                                   is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): next((i for i, e in enumerate(s) if e == axis), None)
            for path, s in flat}


def _port_dims(spec_tree, axis):
    return {path: getattr(s, axis) for path, s in jax_leaves_with_paths(spec_tree)}


def _whole_kv(cfg, n_model):
    """M a multiple of the KV heads that does not divide them: every rank
    holds them all."""
    from repro_torch.models import layers as L

    return cfg.family != "xlstm" and L.kv_split(cfg, n_model) is None


def _deviates(cfg, n_model, path):
    """A leaf whose model dim is not JAX's."""
    return (_whole_kv(cfg, n_model) and path.endswith(KV_LEAVES)) or path.endswith(GATE_LEAVES)


@pytest.mark.parametrize("arch,n_model", CASES + RECURRENT_CASES)
def test_param_specs_match_jax(arch, n_model):
    from repro_torch.models import layers as L

    cfg = tconfigs.get(arch)
    jspecs = jlm.param_specs(jconfigs.get(arch))
    tspecs = tlm.param_specs(cfg, n_model)
    want, got = _jax_dims(jspecs, "model"), _port_dims(tspecs, "model")
    assert set(got) == set(want)
    deviations = [p for p in got if _deviates(cfg, n_model, p)]
    for path in got:
        if path.endswith(GATE_LEAVES[:2]):  # the head columns, where JAX splits the rows
            assert (got[path], want[path]) == (3, 2), path
        elif path.endswith(GATE_LEAVES[2:]):  # the heads, where JAX holds the biases whole
            assert (got[path], want[path]) == (2, None), path
        elif path in deviations:
            assert got[path] is None and want[path] is not None, path
        else:
            assert got[path] == want[path], path
    assert bool(deviations) == (_whole_kv(cfg, n_model) or cfg.family == "xlstm")
    assert _port_dims(tspecs, "data") == _jax_dims(jspecs, "data")
    # the cuts: whole GQA groups where M divides neither head count, two halves
    uneven = cfg.family != "xlstm" and len(set(L.kv_split(cfg, n_model) or (0,))) > 1
    assert uneven == (arch == "hymba-1.5b")
    for path, spec in jax_leaves_with_paths(tspecs):
        parts = L.kv_split(cfg, n_model) if uneven and path.endswith(HEAD_LEAVES) else None
        assert spec.parts == parts, path
        assert spec.blocks == (2 if path.endswith(HALVES_LEAVES) else 1), path
    if uneven:
        assert L.kv_split(cfg, n_model) == {2: (3, 2), 4: (2, 1, 1, 1)}[n_model]
    experts = [p for p, d in _port_dims(tspecs, "data").items() if d is not None]
    assert len(experts) == (3 if cfg.family == "moe" else 0), experts


@pytest.mark.parametrize("arch,n_model", [("qwen2-1.5b", 8), ("qwen3-14b", 16)])
def test_param_specs_refuse_split_query_heads(arch, n_model):
    """JAX splits the query heads' columns wherever they divide; the port's
    attention reads whole heads, and raises."""
    with pytest.raises(ValueError, match="query heads"):
        tlm.param_specs(tconfigs.get(arch), n_model)


@pytest.mark.parametrize("arch,n_model,dp", [(a, 4, dp) for dp in (1, 2, 16) for a in ARCHS]
                         + [(a, 4, dp) for dp in (2, 4, 8) for a in FAMILIES]
                         + [(a, 4, dp) for dp in (2, 8) for a in RECURRENT])
def test_zero1_and_moment_specs_match_jax(arch, n_model, dp):
    cfg = tconfigs.get(arch)
    shapes = _jax_shapes(arch)
    jspecs = jlm.param_specs(jconfigs.get(arch))
    tspecs = tlm.param_specs(cfg, n_model)
    jz = joptim.zero1_specs(jspecs, shapes, dp_axis="data", dp_size=dp)
    tz = toptim.zero1_specs(tspecs, shapes, dp)
    for axis in ("model", "data"):
        want, got = _jax_dims(jz, axis), _port_dims(tz, axis)
        for path in got:
            if not _deviates(cfg, n_model, path):
                assert got[path] == want[path], (axis, path)
    for (path, s), (_, z) in zip(jax_leaves_with_paths(tspecs), jax_leaves_with_paths(tz)):
        assert (z.parts, z.blocks) == (s.parts, s.blocks), path  # the model cut kept
    jm = joptim.moment_specs("adamw", jspecs, shapes, dp_axis="data", dp_size=dp)
    tm = toptim.moment_specs("adamw", tspecs, shapes, dp)
    assert set(tm) == set(jm) == {"m", "v", "t"} and tm["t"] == Spec() and jm["t"] == P()
    assert tm["m"] == tm["v"] == tz
    assert toptim.moment_specs("sgdm", tspecs, shapes, dp) == {"m": tz}
    assert toptim.moment_specs("sgd", tspecs, shapes, dp) == {}


@pytest.mark.parametrize("arch,n_model", CASES)
def test_cache_specs_name_their_deviation(arch, n_model):
    """JAX: batch over "data" (dim 1), head_dim over "model" (dim 4).  The
    port: the same batch dim; the KV heads (3) where M divides them, else
    none (every model rank holds every KV head)."""
    cfg = tconfigs.get(arch)
    jspec = jlm.cache_specs(jconfigs.get(arch))
    tspec = tlm.cache_specs(cfg, n_model)
    assert set(tspec) == set(jspec) == {"k", "v"}
    for key in ("k", "v"):
        assert _jax_dims(jspec[key], "data")["" ] == tspec[key].data == 1
        assert _jax_dims(jspec[key], "model")[""] == 4
        assert tspec[key].model == (3 if cfg.n_kv_heads % n_model == 0 else None)
    assert tlm.cache_specs(cfg, n_model, batch_split=False)["k"].data is None


# the port's cache dims over the model axis that depart from JAX's: (port, JAX)
CACHE_DEVIATIONS = {"k": (3, 4), "v": (3, 4), "C": (3, 4), "n": (3, 4), "m": (3, None),
                    "s_c": (None, 2), "s_n": (None, 2), "s_h": (None, 2), "s_m": (None, 2)}


@pytest.mark.parametrize("arch,n_model", RECURRENT_CASES)
def test_recurrent_cache_specs_name_their_deviations(arch, n_model, monkeypatch):
    """hymba: k and v as the other families', in whole GQA groups where M
    divides neither head count; ssm and conv their channels, as JAX's.
    xlstm: C, n and m by heads; the sLSTM states whole (each rank runs the
    whole recurrence).  The batch over the data axis, as JAX's.  A rank's
    ``init_cache(group=)`` has the shapes ``cache_specs`` cuts out of the
    whole cache (reduced hymba at 10 / 5 heads: uneven at 2 and 4)."""
    import torch.distributed as dist

    from repro_torch.models import layers as L
    from repro_torch.shard import shard_tree

    cfg = tconfigs.get(arch)
    jspec = jlm.cache_specs(jconfigs.get(arch))
    tspec = tlm.cache_specs(cfg, n_model)
    assert set(tspec) == set(jspec)
    for key, spec in tspec.items():
        assert spec.data == _jax_dims(jspec[key], "data")[""], key
        want = _jax_dims(jspec[key], "model")[""]
        assert (spec.model, want) == CACHE_DEVIATIONS.get(key, (want, want)), key
        kv = key in ("k", "v")
        assert spec.parts == (L.kv_split(cfg, n_model) if kv else None), key
    assert all(s.data is None for s in tlm.cache_specs(cfg, n_model, batch_split=False).values())
    red = tconfigs.get_reduced(arch, **({"n_heads": 10, "n_kv_heads": 5}
                                         if cfg.family == "hybrid" else {}))
    whole = tlm.init_cache(red, 2, 16, device="meta")
    monkeypatch.setattr(dist, "get_world_size", lambda g: n_model)
    for r in range(n_model):
        monkeypatch.setattr(dist, "get_rank", lambda g, r=r: r)
        got = tlm.init_cache(red, 2, 16, device="meta", group=object())
        want = shard_tree(whole, tlm.cache_specs(red, n_model), r, n_model)
        assert ({k: tuple(v.shape) for k, v in got.items()}
                == {k: tuple(v.shape) for k, v in want.items()}), r


@pytest.mark.parametrize("arch", ARCHS + FAMILIES + RECURRENT)
def test_abstract_state_has_jax_shapes(arch):
    cfg = tconfigs.get(arch)
    state = tsteps.abstract_state(cfg, toptim.adamw(weight_decay=0.1))
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), _jax_shapes(arch))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       state.params)
    assert got == want
    for tree in (state.params, state.opt["m"], state.opt["v"]):
        assert all(t.device.type == "meta" for t in jax.tree.leaves(tree))
    specs = tsteps.state_specs(cfg, state, n_model=4, dp_size=16)
    assert specs.params == tlm.param_specs(cfg, 4)
    assert all(s == Spec() for s in jax.tree.leaves(specs.ebuf))
    np.testing.assert_equal(tsteps.static_buffers_for(cfg), jlm.init_buffers(jconfigs.get(arch)))
    if arch == "command-r-35b":
        assert cfg.n_params() == jconfigs.get(arch).n_params() == 28_448_530_432


def test_shapes_match_jax():
    assert set(tshapes.SHAPES) == set(jshapes.SHAPES)
    for name, s in tshapes.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(jshapes.SHAPES[name])
    for arch in tconfigs.ARCHS:
        tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
        for name, s in tshapes.SHAPES.items():
            assert tshapes.applicable(tcfg, name) == jshapes.applicable(jcfg, name)
            for n_dp in (1, 2, 16, 512):
                assert (tshapes.microbatch(tcfg, s, n_dp)
                        == jshapes.microbatch(jcfg, jshapes.SHAPES[name], n_dp))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "command-r-35b"])
def test_input_descriptions_match_jax(arch):
    tcfg = tconfigs.get_reduced(arch)
    jcfg = jconfigs.get_reduced(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = tshapes.input_specs(tcfg, name, n_dp=4)
        want = jshapes.input_specs(jcfg, name, n_dp=4)
        want = jax.tree.map(lambda s: s.shape, want)
        assert jax.tree.map(lambda s: s[0], got, is_leaf=lambda x: isinstance(x, tuple)) == want


class _FakeDist:
    """``torch.distributed`` as one rank of a world sees it: the groups it
    is asked for, in order."""

    class _Group:
        def __init__(self, ranks):
            self.ranks = ranks

    def __init__(self, rank, n):
        self.rank, self.n, self.made = rank, n, []
        self.group = type("G", (), {"WORLD": self._Group(list(range(n)))})

    def get_world_size(self, g):
        return len(g.ranks)

    def get_rank(self, g):
        return g.ranks.index(self.rank)

    def new_group(self, ranks):
        self.made.append(list(ranks))
        return self._Group(list(ranks))


@pytest.mark.parametrize("data,model", [(1, 1), (2, 2), (4, 2), (2, 4), (1, 4), (4, 1)])
def test_mesh_rank_layout(data, model, monkeypatch):
    """Rank r at (r // model, r % model), the row-major order of
    ``jax.make_mesh``; every rank makes the same subgroups in one order."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    grid = np.arange(data * model).reshape(data, model)
    made = None
    for r in range(data * model):
        fake = _FakeDist(r, data * model)
        for name in ("get_world_size", "get_rank", "new_group", "group"):
            monkeypatch.setattr(dist, name, getattr(fake, name))
        m = tmesh.Mesh(data, model)
        assert m.coords == (r // model, r % model) and m.rank == r
        assert m.shape == {"data": data, "model": model} and m.size == data * model
        assert m.model.ranks == list(grid[m.coords[0]])
        assert m.data.ranks == list(grid[:, m.coords[1]])
        assert made is None or fake.made == made
        made = fake.made
        assert tmesh.batch_axes(m) == ("data",)
        assert tmesh.model_axis(m) == ("model" if model > 1 else None)
        assert tmesh.all_batch_axes(m) == (("data", "model") if model > 1 else ("data",))
    with pytest.raises(ValueError, match="ranks"):
        tmesh.Mesh(data + 1, model)


@pytest.mark.parametrize("parts,blocks", [(None, 1), (None, 2), ((3, 2), 1), ((2, 1, 1, 1), 1),
                                          ((1, 2), 2)])
def test_uneven_and_blocked_cuts_invert(parts, blocks):
    """``shard_leaf``'s slices, put back together in rank order as
    ``gather_tree`` does (``shard._join``), are the whole leaf (tensor and
    numpy); an uneven cut's slices have its weights' sizes."""
    from repro_torch.shard import _join, shard_leaf

    M = len(parts) if parts else 2
    x = torch.arange(2 * 60 * 3, dtype=torch.float32).reshape(2, 60, 3)
    pieces = [shard_leaf(x, 1, r, M, parts, blocks) for r in range(M)]
    assert torch.equal(_join(pieces, 1, blocks), x)
    assert [p.shape[1] for p in pieces] == [60 * w // sum(parts or (1,) * M)
                                           for w in (parts or (1,) * M)]
    arr = [shard_leaf(x.numpy(), 1, r, M, parts, blocks) for r in range(M)]
    assert all(np.array_equal(a, p.numpy()) for a, p in zip(arr, pieces))
    with pytest.raises(ValueError, match="does not split"):
        shard_leaf(x[:, :7], 1, 0, M, parts, blocks)


def test_slstm_runs_no_collective_inside_its_loop(monkeypatch):
    """One sLSTM block on a rank's slices under a (stubbed) group of 2:
    forward, one all-gather (the pre-activations, before the loop) and one
    all-reduce (the FFN's partial sums, after it) at 3 and at 9 tokens;
    backward, the same count at both lengths too."""
    import torch.distributed as dist

    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.shard import shard_tree

    calls = []

    def all_gather(parts, x, group=None):
        calls.append("all_gather")
        for p in parts:
            p.copy_(x)

    def all_reduce(x, op=None, group=None):
        calls.append("all_reduce")

    for name, fn in (("get_world_size", lambda g: 2), ("get_rank", lambda g: 0),
                     ("all_gather", all_gather), ("all_reduce", all_reduce)):
        monkeypatch.setattr(dist, name, fn)
    cfg = tconfigs.get_reduced("xlstm-1.3b")
    params, _ = tlm.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    sp = tlm.layer_params(shard_tree(params, tlm.param_specs(cfg, 2), 0, 2)["blocks"]["slstm"], 0)
    counts = []
    for S in (3, 9):
        x = torch.randn(2, S, cfg.d_model, requires_grad=True)
        calls.clear()
        with torch.no_grad():
            xlstm_lib.slstm_seq(sp, cfg, x, group=object())
        forward = calls[:]
        calls.clear()
        y, _ = xlstm_lib.slstm_seq(sp, cfg, x, group=object())
        trained = calls[:]
        calls.clear()
        y.sum().backward()
        counts.append((forward, trained, calls[:]))
    assert counts[0] == counts[1], counts
    assert counts[0][0] == counts[0][1] == ["all_gather", "all_reduce"], counts[0]
    assert counts[0][2] == ["all_reduce", "all_reduce"], counts[0]  # h's and x's gradients


@pytest.mark.parametrize("option,value", [("seq_shard", True), ("zero2_grads", True),
                                          ("parallelism", "fsdp")])
def test_unported_sharding_options_raise_by_name(option, value):
    cfg = tconfigs.get_reduced("qwen2-1.5b", **{option: value})
    with pytest.raises(NotImplementedError, match=option):
        tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_zero1_on_one_rank_is_adamw_bit_for_bit():
    cfg = tconfigs.get_reduced("command-r-35b")
    params, _ = tlm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    opt = toptim.adamw(weight_decay=0.1)
    mspecs = toptim.moment_specs("adamw", tlm.param_specs(cfg), params, 1)
    grads = jax.tree.map(lambda p: torch.randn_like(p), params)
    a = jax.tree.map(torch.clone, params)
    b = jax.tree.map(torch.clone, params)
    sa, sb = opt.init(a), opt.init(b)
    for _ in range(2):
        a, sa = opt.update(grads, sa, a, torch.tensor(1e-2))
        b, sb = toptim.zero1(opt, mspecs, None).update(grads, sb, b, torch.tensor(1e-2))
    for x, y in zip(jax.tree.leaves((a, sa)), jax.tree.leaves((b, sb))):
        assert torch.equal(x, y)


def test_tensor_parallel_collectives_without_a_group():
    from repro_torch.shard import copy_to_group, gather_last, reduce_from_group, shard_tree

    x = torch.randn(3, 4, requires_grad=True)
    for f in (copy_to_group, reduce_from_group, gather_last):
        assert f(x, None) is x
    tree = {"a": torch.arange(24.0).reshape(4, 6), "b": torch.zeros(2)}
    specs = {"a": Spec(model=1, data=0), "b": Spec()}
    got = shard_tree(shard_tree(tree, specs, 1, 2, "model"), specs, 1, 4, "data")
    assert torch.equal(got["a"], tree["a"][1:2, 3:6]) and got["b"] is tree["b"]


SHARE_ARCHS = ("command-r-35b", "qwen2-1.5b", "paligemma-3b", "musicgen-medium",
               "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "hymba-1.5b-kv5", "xlstm-1.3b")
SHARE_OVERRIDES = {"hymba-1.5b-kv5": {"n_heads": 10, "n_kv_heads": 5}}


def _emulated_embed(ranks, buffers, cfg, toks):
    """``lm.embed`` under M model ranks: their ``embed_share`` slices
    concatenated in rank order, then its scaling."""
    x = torch.cat([tlm.embed_share(rp, buffers, cfg, toks) for rp in ranks], dim=-1)
    x = x.reshape(*toks.shape[:2], cfg.d_model)
    return (x * cfg.d_model ** 0.5 if cfg.emb_scale else x).to(cfg.dtype)


def _emulated_xlstm(cfg, params, ranks, x, cache, close):
    """The xlstm stack of M ranks in rank order: each mLSTM block's x half
    gathered between ``mlstm_up`` and ``mlstm_heads``, its partial outputs
    summed, each rank's heads' state held against its slice of the cache;
    each sLSTM block's pre-activations gathered, the whole recurrence run
    once, its FFN's partial sums added."""
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as xlstm_lib

    M = len(ranks)
    H = cfg.n_heads // M
    walks = [tlm._xlstm_blocks(params["blocks"], cfg)]
    walks += [tlm._xlstm_blocks(rp["blocks"], cfg) for rp in ranks]
    for (kind, at, _, norm), *rest in zip(*walks):
        qs = [p for _, _, p, _ in rest]
        hn = L.apply_norm(norm, x)
        if kind == "m":
            ups = [xlstm_lib.mlstm_up(q, hn) for q in qs]
            xm = torch.cat([u[0] for u in ups], dim=-1)
            outs = [xlstm_lib.mlstm_heads(q, cfg, xm, u[1]) for q, u in zip(qs, ups)]
            for r, (_, state) in enumerate(outs):
                for key, t in zip(("C", "n", "m"), state):
                    close(t, cache[key][at][:, r * H:(r + 1) * H])
            x = x + sum(o[0] for o in outs)
        else:
            zx = torch.cat([xlstm_lib.slstm_input(q, hn) for q in qs], dim=-1)
            h, state = xlstm_lib.slstm_recur(qs[0], cfg, zx)
            for key, t in zip(("s_c", "s_n", "s_h", "s_m"), state):
                close(t, cache[key][at])
            x = x + sum(xlstm_lib.slstm_ffn(q, h) for q in qs)
    return x


@pytest.mark.parametrize("arch,n_model", [(a, m) for a in SHARE_ARCHS for m in (2, 4)])
def test_rank_shares_emulated_equal_the_unsharded_prefill(arch, n_model):
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.shard import shard_tree

    cfg = tconfigs.get_reduced(arch.split("-kv")[0], dtype=torch.float32,
                               **SHARE_OVERRIDES.get(arch, {}))
    M, S = n_model, min(12, cfg.sliding_window or 12)  # hymba within its window: flash
    params, buffers = tlm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    ranks = [shard_tree(params, tlm.param_specs(cfg, M), r, M) for r in range(M)]
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S, cfg.n_codebooks or 1)))
    toks = toks if cfg.n_codebooks else toks[..., 0]

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))

    with torch.no_grad():
        cache = tlm.init_cache(cfg, 2, S, device="cpu")
        want, _ = tlm.prefill(params, buffers, cfg, toks, cache)
        x = _emulated_embed(ranks, buffers, cfg, toks)
        assert torch.equal(x, tlm.embed(params, buffers, cfg, toks))
        positions = torch.arange(S)[None].expand(2, S)
        x = tlm._add_positions(cfg, x, positions)
        freqs = L.rope_freqs(cfg, device="cpu")
        layers = 0 if cfg.family == "xlstm" else cfg.n_layers
        if cfg.family == "xlstm":
            x = _emulated_xlstm(cfg, params, ranks, x, cache, close)
        for i in range(layers):
            lp = tlm.layer_params(params["blocks"], i)
            lps = [tlm.layer_params(rp["blocks"], i) for rp in ranks]
            h = L.apply_norm(lp["ln1"], x)
            attn = [tlm.prefill_attention_share(q, cfg, h, positions, freqs, r, M)
                    for r, q in enumerate(lps)]
            for r, (_, k, v) in enumerate(attn):
                held = slice(*L.kv_range(cfg, r, M))
                for got, full in ((k, cache["k"]), (v, cache["v"])):
                    close(got, full[i, :, :, held])
            if cfg.parallel_block:
                y = sum(tlm.parallel_share(q, cfg, a, h) for q, (a, _, _) in zip(lps, attn))
                x = tlm.parallel_residual(lp, cfg, x, y)
                continue
            if cfg.family == "hybrid":  # the projection summed inside the SSM branch
                proj = [ssm_lib.ssm_project(q["ssm"], cfg, h) for q in lps]
                whole = sum(p[2] for p in proj)
                scans = [ssm_lib.ssm_scan(q["ssm"], cfg, p[0], p[1], whole)
                         for q, p in zip(lps, proj)]
                di = cfg.ssm_inner // M
                for r, ((_, _, _, conv), (_, state)) in enumerate(zip(proj, scans)):
                    close(state, cache["ssm"][i, :, r * di:(r + 1) * di])
                    close(conv, cache["conv"][i, ..., r * di:(r + 1) * di])
                x = tlm.hybrid_mix(lp, x, sum(a for a, _, _ in attn), sum(s for s, _ in scans))
            else:
                x = x + sum(a for a, _, _ in attn)
            h2 = L.apply_norm(lp["ln2"], x)
            if cfg.family == "moe":  # each rank's experts' ff slices, combined in token space
                x = x + sum(moe_lib.apply_moe(q["moe"], cfg, h2, group_size=cfg.moe_group)[0]
                            for q in lps)
            else:
                x = x + L.mlp_bias(lp["mlp"], cfg,
                                   sum(L.mlp_partial(q["mlp"], cfg, h2) for q in lps))
        y = L.apply_norm(params["ln_f"], x[:, -1])
        if cfg.emb_method == "full":
            got = torch.cat([tlm.vocab_share(rp, cfg, y) for rp in ranks], dim=-1)
            got = got.reshape(*want.shape)
        else:
            got = tlm.head_logits(buffers, cfg, sum(tlm.head_share(rp, cfg, y, r, M)
                                                    for r, rp in enumerate(ranks)))
        close(got, want)
        if cfg.family == "vlm":
            pe = torch.from_numpy(rng.standard_normal((2, cfg.n_patches, cfg.d_model),
                                                      dtype=np.float32))
            got = torch.cat([tlm.patch_share(rp, cfg, pe) for rp in ranks], dim=-1)
            close(got, pe @ params["patch_proj"])


def _moe_case(D, M, impl):
    """Reduced phi3.5-moe (4 experts, top 2) with groups of 16 tokens, its
    layer-0 expert params, a (4, 16, d) input and each of the D x M ranks'
    expert params (its experts' ff slices)."""
    from repro_torch.shard import shard_tree

    cfg = tconfigs.get_reduced("phi3.5-moe-42b-a6.6b", moe_group=16, moe_impl=impl)
    params, _ = tlm.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    specs = tlm.param_specs(cfg, M)["blocks"]["moe"]
    p = tlm.layer_params(params["blocks"]["moe"], 0)
    stacked = params["blocks"]["moe"]
    ranks = [[tlm.layer_params(shard_tree(shard_tree(stacked, specs, m, M), specs, d, D, "data"),
                               0) for m in range(M)] for d in range(D)]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 16, cfg.d_model),
                                                                   dtype=np.float32))
    return cfg, p, x, ranks


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("D,M", [(2, 1), (4, 1), (2, 2)])
def test_expert_parallel_emulated_equals_the_unsharded_layer(D, M, impl):
    """Each data rank routes its own rows' groups; the all-to-all sends
    rank s the slots of its experts from every rank (a transpose in rank
    order); each model rank's partial sums over its ff slice are added."""
    from repro_torch.models import moe as moe_lib

    cfg, p, x, ranks = _moe_case(D, M, impl)
    apply = moe_lib.apply_moe if impl == "einsum" else moe_lib.apply_moe_sort
    moe_lib.TRACE = []
    try:
        with torch.no_grad():
            want, want_aux = apply(p, cfg, x, group_size=cfg.moe_group)
            whole_trace = moe_lib.TRACE[:]
            moe_lib.TRACE.clear()
            rows = x.shape[0] // D
            routed = [moe_lib.dispatch(p, cfg, x[d * rows:(d + 1) * rows], impl=impl,
                                       group_size=cfg.moe_group) for d in range(D)]
            G, E, C, d_model = routed[0].slots.shape
            El = E // D
            # the first all-to-all: rank s holds every rank's slots of its experts
            at = [torch.cat([r.slots[:, s * El:(s + 1) * El] for r in routed]) for s in range(D)]
            out = [[moe_lib.grouped_experts(ranks[s][m], at[s]) for m in range(M)]
                   for s in range(D)]
            got, aux = [], 0.0
            for d in range(D):  # the second all-to-all, the combine, the model ranks' sum
                y = sum(routed[d].combine(torch.cat([out[s][m][d * G:(d + 1) * G]
                                                     for s in range(D)], dim=1))
                        for m in range(M))
                got.append(y.reshape(rows, *x.shape[1:]))
                aux = aux + moe_lib._aux(routed[d].probs, routed[d].gate_idx, E) / D
            got = torch.cat(got)
            assert torch.equal(torch.cat([t[1] for t in moe_lib.TRACE]), whole_trace[0][1])
            assert torch.equal(torch.cat([t[2] for t in moe_lib.TRACE]), whole_trace[0][2])
    finally:
        moe_lib.TRACE = None
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    # uniform routing shares over the ranks: the mean of their aux is the whole batch's
    frac = torch.stack([torch.nn.functional.one_hot(r.gate_idx[..., 0], E).float().mean((0, 1))
                        for r in routed]).mean(0)
    probs = torch.stack([r.probs.mean((0, 1)) for r in routed]).mean(0)
    np.testing.assert_allclose(E * torch.sum(frac * probs), want_aux, rtol=1e-5)
    assert np.isfinite(float(aux))


def test_expert_parallel_refusals_name_their_cause(monkeypatch):
    import torch.distributed as dist

    from repro_torch.models import moe as moe_lib

    cfg, p, x, _ = _moe_case(1, 1, "einsum")
    data = object()  # a stand-in group of 3, then 2, ranks
    monkeypatch.setattr(dist, "get_world_size", lambda g: 3)
    monkeypatch.setattr(dist, "get_rank", lambda g: 0)
    with pytest.raises(ValueError, match="4 experts do not split over 3 data ranks"):
        moe_lib.apply_moe(p, cfg, x, group_size=cfg.moe_group, data=data)
    with pytest.raises(ValueError, match="4 experts do not split over 3 data ranks"):
        moe_lib.apply_moe_decode(p, cfg, x[:, :1], data=data)
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    with pytest.raises(ValueError, match="not a whole number of groups of 16"):
        moe_lib.apply_moe_sort(p, cfg, x[:, :10], group_size=cfg.moe_group, data=data)
