"""Port vs JAX package: the LM serving engine.  On the JAX serving tests'
model (dense, 2 layers, full tables, float32) with the JAX package's
params carried over by ``convert``, the port's ``ServeEngine`` generates
the same greedy tokens as the JAX ``ServeEngine`` for the same requests:
continuous batching over fewer slots than requests, prompts of every
length up to a 32-token cache (power-of-two buckets), and eos.  The same
on reduced hymba-1.5b (the hybrid family: window 8, so a ring of 8 k/v
rows, and SSM states; prompts unpadded, shorter and longer than the
window, decoding past it) at two slot counts, and on reduced paligemma-3b
(the vlm family: tied CCE head, MQA; prompts padded into buckets), where
each prefill's logits are held too: with random tied weights greedy
decoding repeats each prompt's last token, so equal tokens alone would
pass most faults in the layers.  On reduced xlstm-1.3b (the xlstm family:
a recurrent cache whose mLSTM states carry the batch on axis 2; prompts
unpadded, up to JAX's 256-token limit) at one and three slots, the tokens
and each prefill's logits.  On reduced phi3.5-moe-42b-a6.6b (the moe
family: 4 experts, top-2, capacity 1.25; prompts padded into buckets,
the pads routed and taking expert capacity as in JAX) at two slot
counts, the tokens and each prefill's logits.  On reduced command-r-35b
(dense: a parallel block, layernorm, CCE table and head; prompts padded
into buckets) the same.  Also drives the port's serve launcher on the
CPU, dense (qwen2-1.5b, command-r-35b), hybrid, xlstm, vlm and moe."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.obs.runlog import RunLog, read_runlog
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread in this module: beside the suite's other
    workers its threads would wait on each other at every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=97, remat="none")


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig(dtype=jnp.float32, **FIELDS)
    params, buffers = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (TConfig(dtype=torch.float32, **FIELDS), tp, tb)


@pytest.fixture(scope="module")
def hymba():
    jcfg = jconfigs.get_reduced("hymba-1.5b")
    params, buffers = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (tconfigs.get_reduced("hymba-1.5b"), tp, tb)


@pytest.fixture(scope="module")
def paligemma():
    jcfg = jconfigs.get_reduced("paligemma-3b")
    params, buffers = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (tconfigs.get_reduced("paligemma-3b"), tp, tb)


@pytest.fixture(scope="module")
def xlstm():
    jcfg = jconfigs.get_reduced("xlstm-1.3b")
    params, buffers = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (tconfigs.get_reduced("xlstm-1.3b"), tp, tb)


@pytest.fixture(scope="module")
def phi_moe():
    jcfg = jconfigs.get_reduced("phi3.5-moe-42b-a6.6b")
    params, buffers = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (tconfigs.get_reduced("phi3.5-moe-42b-a6.6b"), tp, tb)


@pytest.fixture(scope="module")
def command_r():
    jcfg = jconfigs.get_reduced("command-r-35b")
    params, buffers = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    tp, tb = convert.lm_to_torch(*jax.tree.map(np.asarray, (params, buffers)), "cpu")
    return (jcfg, params, buffers), (tconfigs.get_reduced("command-r-35b"), tp, tb)


def _serve(engine_cls, request_cls, state, requests, **kw):
    cfg, params, buffers = state
    eng = engine_cls(cfg, params, buffers, **kw)
    for uid, prompt, max_tokens, eos in requests:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_tokens=max_tokens, eos=eos))
    done = eng.run()
    assert len(done) == len(requests)
    return {r.uid: r.generated for r in done}


def _requests(scenario):
    rng = np.random.default_rng({"batching": 1, "queue": 2, "buckets": 3}[scenario])
    if scenario == "batching":  # 5 prompts of 4..8 tokens over 3 slots
        return [(i, rng.integers(0, 97, 4 + i).astype(np.int32), 4, None) for i in range(5)]
    if scenario == "queue":  # 7 requests over 2 slots
        return [(i, rng.integers(0, 97, 3).astype(np.int32), 3, None) for i in range(7)]
    # 17 prompt lengths over 4 buckets, 4 slots
    return [(i, rng.integers(0, 97, s).astype(np.int32), 3, None)
            for i, s in enumerate(range(1, 18))]


@pytest.mark.parametrize("scenario,max_batch", [("batching", 3), ("queue", 2), ("buckets", 4)])
def test_engine_tokens_match_jax(model, scenario, max_batch):
    jstate, tstate = model
    reqs = _requests(scenario)
    want = _serve(JEngine, JRequest, jstate, reqs, max_batch=max_batch, max_seq=32)
    got = _serve(TEngine, TRequest, tstate, reqs, max_batch=max_batch, max_seq=32)
    assert got == want


@pytest.mark.parametrize("max_batch", [2, 3])
def test_hybrid_engine_tokens_match_jax(hymba, max_batch):
    """Four requests of 5 and 13 prompt tokens (the window is 8) and 6
    generated tokens each, so that every request's ring wraps while it
    decodes, over fewer slots than requests."""
    jstate, tstate = hymba
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, 257, s).astype(np.int32), 6, None)
            for i, s in enumerate((5, 13, 13, 5))]
    want = _serve(JEngine, JRequest, jstate, reqs, max_batch=max_batch, max_seq=32)
    got = _serve(TEngine, TRequest, tstate, reqs, max_batch=max_batch, max_seq=32)
    assert got == want


def _prefill_calls(eng, attr):
    """Record each prefill's (padded length, logits as numpy) in call
    order: ``attr`` is the JAX engine's jitted ``_prefill`` (dyn, toks,
    cache, last) or the port's ``_prefill_one`` (slot, toks, last)."""
    calls, inner = [], getattr(eng, attr)

    def recorded(*a):
        out = inner(*a)
        logits = out[0] if isinstance(out, tuple) else out
        calls.append((int(a[1].shape[1]), np.asarray(logits, np.float32)))
        return out

    setattr(eng, attr, recorded)
    return calls


def _tokens_and_prefill_logits(jstate, tstate, reqs, max_batch, max_seq):
    """Both engines over ``reqs``: ({uid: tokens}, [(prefill length,
    logits)]) for JAX's and the port's."""
    out = {}
    for side, (cls, rcls, state, attr) in {
            "jax": (JEngine, JRequest, jstate, "_prefill"),
            "port": (TEngine, TRequest, tstate, "_prefill_one")}.items():
        cfg, params, buffers = state
        eng = cls(cfg, params, buffers, max_batch=max_batch, max_seq=max_seq)
        calls = _prefill_calls(eng, attr)
        for uid, prompt, max_tokens, eos in reqs:
            eng.submit(rcls(uid=uid, prompt=prompt, max_tokens=max_tokens, eos=eos))
        done = eng.run()
        out[side] = ({r.uid: r.generated for r in done}, calls)
    return out["jax"], out["port"]


@pytest.mark.parametrize("max_batch", [2, 3])
def test_vlm_engine_tokens_and_prefill_logits_match_jax(paligemma, max_batch):
    """Five requests of 3..13 prompt tokens over fewer slots: each prompt
    padded into its power-of-two bucket on both sides, each prefill's
    logits within rtol 1e-4 / atol 1e-5 of JAX's, and the same tokens."""
    jstate, tstate = paligemma
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 257, s).astype(np.int32), 5, None)
            for i, s in enumerate((3, 13, 8, 5, 9))]
    (want, jcalls), (got, tcalls) = _tokens_and_prefill_logits(jstate, tstate, reqs, max_batch,
                                                                32)
    assert got == want
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls] == [4, 16, 8, 8, 16]
    for (_, a), (_, b) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_batch", [1, 3])
def test_xlstm_engine_tokens_and_prefill_logits_match_jax(xlstm, max_batch):
    """Four requests of 6, 256, 6 and 19 prompt tokens (past 256 JAX
    prefills only multiples of its 256-token chunk) over fewer slots, each
    prefilled at its own length into its slot of every state, the others'
    states left as they are: each prefill's logits within rtol 1e-4 /
    atol 1e-5 of JAX's, and the same tokens."""
    jstate, tstate = xlstm
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, 257, s).astype(np.int32), 4, None)
            for i, s in enumerate((6, 256, 6, 19))]
    (want, jcalls), (got, tcalls) = _tokens_and_prefill_logits(jstate, tstate, reqs, max_batch,
                                                                272)
    assert got == want
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls] == [6, 256, 6, 19]
    for (_, a), (_, b) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_batch", [2, 3])
def test_moe_engine_tokens_and_prefill_logits_match_jax(phi_moe, max_batch):
    """Five requests of 3..13 prompt tokens over fewer slots: each prompt
    padded into its power-of-two bucket on both sides (the pads routed
    through the experts like any token), each prefill's logits within
    rtol 1e-4 / atol 1e-5 of JAX's, and the same tokens."""
    jstate, tstate = phi_moe
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, 257, s).astype(np.int32), 5, None)
            for i, s in enumerate((3, 13, 8, 5, 9))]
    (want, jcalls), (got, tcalls) = _tokens_and_prefill_logits(jstate, tstate, reqs, max_batch,
                                                                32)
    assert got == want
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls] == [4, 16, 8, 8, 16]
    for (_, a), (_, b) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_batch", [2, 3])
def test_command_r_engine_tokens_and_prefill_logits_match_jax(command_r, max_batch):
    """Five requests of 3..13 prompt tokens over fewer slots, each padded
    into its power-of-two bucket on both sides: each prefill's logits
    within rtol 1e-4 / atol 1e-5 of JAX's, and the same tokens."""
    jstate, tstate = command_r
    rng = np.random.default_rng(8)
    reqs = [(i, rng.integers(0, 257, s).astype(np.int32), 5, None)
            for i, s in enumerate((3, 13, 8, 5, 9))]
    (want, jcalls), (got, tcalls) = _tokens_and_prefill_logits(jstate, tstate, reqs, max_batch,
                                                                32)
    assert got == want
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls] == [4, 16, 8, 8, 16]
    for (_, a), (_, b) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_eos_matches_jax(model):
    jstate, tstate = model
    prompt = np.asarray([5, 17, 3], np.int32)
    free = _serve(TEngine, TRequest, tstate, [(0, prompt, 8, None)], max_batch=1, max_seq=32)[0]
    reqs = [(0, prompt, 8, free[2]), (1, prompt[:2], 8, None)]
    want = _serve(JEngine, JRequest, jstate, reqs, max_batch=2, max_seq=32)
    got = _serve(TEngine, TRequest, tstate, reqs, max_batch=2, max_seq=32)
    assert got == want and got[0] == free[:3]


def test_prefill_count_latency_histogram_and_run_log(model, tmp_path):
    _, tstate = model
    cfg, params, buffers = tstate
    with RunLog(tmp_path / "serve.jsonl") as log:
        eng = TEngine(cfg, params, buffers, max_batch=2, max_seq=32, runlog=log)
        for uid, prompt, max_tokens, eos in _requests("queue"):
            eng.submit(TRequest(uid=uid, prompt=prompt, max_tokens=max_tokens, eos=eos))
        done = eng.run()
        hist = eng.flush_stats()
    assert eng.prefills == len(done) == 7
    assert hist["n"] == 7 and 0 < hist["p50"] <= hist["p99"]
    events = [r["event"] for r in read_runlog(tmp_path / "serve.jsonl")]
    assert events == ["manifest"] + ["request"] * 7 + ["latency_hist"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "paligemma-3b", "xlstm-1.3b",
                                  "phi3.5-moe-42b-a6.6b", "command-r-35b"])
def test_launch_serve_runs_on_the_cpu(capsys, arch):
    done = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--max-tokens", "3"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert f"{arch}: served 3 requests" in capsys.readouterr().out
