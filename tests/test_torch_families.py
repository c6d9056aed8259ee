"""PyTorch port: the MoE, SSM and hybrid families against the JAX package,
on the smoke configs of grok-1 (MoE, 4 experts top-2), arctic (MoE, 8
experts and a dense residual, bfloat16 parameters), mamba2 (SSM) and
zamba2 (Mamba2 layers and one shared attention block), from parameters
carried across with ``params_from_jax``.

At float32 compute:

* ``lm_per_sample_loss`` on both of the port's forwards (training path,
  and ``scoring=True`` through the kernels' plain versions on the CPU)
  at 1e-4 (atol and rtol, ``tests/test_torch_model.py``'s float32
  tolerance), and the training path's gradients at atol 1e-5, rtol 1e-4;
* one ``es_step`` (B = 4, b = 2) against the JAX engine's from the same
  state and Gumbel draws: the meta-batch's and the selected minibatch's
  losses, the parameters and the store at atol 1e-5, rtol 1e-4
  (``tests/test_torch_engine.py``'s), the AdamW moments too; a weight
  whose gradient sits in AdamW's eps regime (0 < |g| < 1e-7, ten eps:
  the first step is lr * g / (|g| + 1e-8), which turns a float32-order
  difference of 1e-9 in g into 1e-2 of the step; under 2 % of the
  weights, the SSM's dt and B/C projections at random init) is held
  through its moments only;
  arctic's bfloat16 parameters and moments within one bfloat16 ulp
  (rtol 2^-7) where their rounding may land on the other side;
* the prefill and 3 decode steps against JAX's jitted ones (bfloat16 KV
  caches on both sides, float32 SSM caches) at ``tests/test_decode.py``'s
  atol 2e-3, rtol 1e-3, the caches too; greedy ``Server.generate`` equal
  to JAX's ``Server`` token for token;
* a MoE packed step (``segment_ids``) against JAX's, and ``ssm`` /
  ``hybrid`` with ``segment_ids`` raising as the reference does;
* ``n_params`` of all ten archs equal to the JAX package's, within the
  published ranges of ``tests/test_models_smoke.py:70-81``.

MoE routing ties go to the lower expert index on both sides (a stable
sort, ``jax.lax.top_k``'s order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _flat, fast_jit, one_torch_thread  # noqa: F401
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config
from repro.configs.registry import list_archs as jax_list_archs
from repro.core import engine as jengine
from repro.core.scores import ESScores
from repro.data.pipeline import PackedSource as JaxPackedSource
from repro.data.synthetic import SyntheticConfig, SyntheticLM
from repro.launch.serve import Server as JaxServer
from repro.models import model as jmodel
from repro.models.layers import ShardCtx
from repro.models.transformer import init_lm as jinit_lm
from repro.models.transformer import lm_per_sample_loss
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.optim.schedule import get_schedule as t_get_schedule

ARCHS = ["grok-1-314b", "arctic-480b", "mamba2-780m", "zamba2-2.7b"]
CTX = ShardCtx()
ATOL, RTOL = 1e-5, 1e-4
BF16_RTOL = 2.0 ** -7          # one bfloat16 ulp
B, b, N, S = 4, 2, 16, 16


def _cfg(arch, **over):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **over)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (3, 24)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((3, 1), -1)],
                            axis=1).astype(np.int32)
    labels[0, 12:] = -1
    return {"tokens": tokens, "labels": labels}


def _step_batch():
    rng = np.random.default_rng(6)
    ds = SyntheticLM(SyntheticConfig(n_samples=N, seq_len=S, vocab_size=64,
                                     seed=0))
    return ds.batch(rng.permutation(N)[:B])


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX side of an arch's tests, under ONE jit (eager, every random
    leaf and op would compile on its own): the initial state with a
    preset store, lm_per_sample_loss and its gradients on ``_batch``, and
    one ``es_step`` on ``_step_batch``. -> (cfg, engine, state, (mean,
    per-sample), grads, new state, metrics)."""
    cfg = _cfg(arch)
    es_cfg = jengine.ESConfig(method="es", minibatch=b, n_train=N,
                              seq_chunk=0)
    opt = OptConfig(lr=1e-3)
    eng = jengine.ESEngine(cfg, es_cfg, opt, get_schedule("cosine", 16, 0),
                           CTX)
    rng = np.random.default_rng(5)
    s0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, N).astype(np.float32)

    def run(key, s, w, loss_batch, step_batch):
        state = jengine.init_train_state(cfg, es_cfg, opt, key, B)
        state = dataclasses.replace(state, scores=ESScores(
            s=s, w=w, seen=jnp.zeros(N, jnp.int32)))

        def loss(p):
            per, mean = lm_per_sample_loss(cfg, p, loss_batch, CTX,
                                           seq_chunk=0)
            return mean, per

        (mean, per), grads = jax.value_and_grad(loss, has_aux=True)(
            state.params)
        new, metrics = eng.es_step(state, step_batch)
        return state, (mean, per), grads, new, metrics

    args = (jax.random.PRNGKey(0), jnp.asarray(s0), jnp.asarray(w0),
            {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()},
            {k: jnp.asarray(v) for k, v in _step_batch().items()})
    # LLVM's backend optimisations off: a third of the compile time, and
    # the HLO (the arithmetic) is the same
    out = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return (cfg, eng) + tuple(out)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg, _, state, (want_mean, want), jgrads, _, _ = _jax_run(arch)
    params = state.params
    batch = _batch(cfg.vocab_size)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_jax(jax.device_get(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        for scoring in (False, True):
            got, got_mean = ttransformer.lm_per_sample_loss(
                tcfg, tparams, tb, scoring=scoring)
            assert got.dtype == torch.float32 and got.shape == (3,)
            _close(got, want, f"scoring={scoring}", 1e-4, 1e-4)
            _close(float(got_mean), float(want_mean), "mean", 1e-4, 1e-4)
    mean, _, grads = tengine._value_and_grad(
        tparams, lambda: ttransformer.lm_per_sample_loss(
            tcfg, tparams, tb)[::-1])
    got, want = _flat(grads), _flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _leaf_tol(x):
    return (0.0, BF16_RTOL) if x.dtype == torch.bfloat16 else (ATOL, RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_es_step_matches_jax(arch):
    cfg, _, state, _, _, new, jm = _jax_run(arch)
    s0, w0 = np.asarray(state.scores.s), np.asarray(state.scores.w)
    host = _step_batch()
    key = jax.random.split(state.rng)[1]
    gumbel = torch.from_numpy(np.asarray(
        jax.random.gumbel(key, (B,), jnp.float32)).copy())
    tparams = params_from_jax(jax.device_get(state.params))

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    t_es = tengine.ESConfig(method="es", minibatch=b, n_train=N)
    t_opt = TOptConfig(lr=1e-3, state_dtype=cfg.optimizer_dtype)
    teng = tengine.ESEngine(tcfg, t_es, t_opt,
                            t_get_schedule("cosine", 16, 0))
    tstate = tengine.init_train_state(tcfg, t_es, t_opt, 0, "cpu",
                                      params=tparams)
    tstate.scores.s.copy_(torch.from_numpy(s0.copy()))
    tstate.scores.w.copy_(torch.from_numpy(w0.copy()))
    tstate, m = teng.es_step(tstate, {k: torch.from_numpy(v.copy())
                                      for k, v in host.items()},
                             gumbel=gumbel)
    # the same selection: the selected minibatch's loss (and the update)
    _close(float(m["loss"]), float(jm["loss"]), "meta loss")
    _close(float(m["sel_loss"]), float(jm["sel_loss"]), "selected loss")
    assert tstate.opt.step == int(new.opt.step) == 1
    flat_t = _flat_torch(tstate.params)
    want = _flat(new.params)
    assert set(flat_t) == set(want)
    t_m, t_v = _flat_torch(tstate.opt.m), _flat_torch(tstate.opt.v)
    j_m, j_v = _flat(new.opt.m), _flat(new.opt.v)
    eps_regime = 0
    for k, v in flat_t.items():
        assert v.dtype == (torch.bfloat16 if want[k].dtype.name == "bfloat16"
                           else torch.float32), k
        atol, rtol = _leaf_tol(v)
        # the moments carry the step's gradient, m = 0.1 g and v = 0.05 g^2
        _close(t_m[k].float().numpy(), j_m[k].astype(np.float32), f"m {k}",
               atol, rtol)
        _close(t_v[k].float().numpy(), j_v[k].astype(np.float32), f"v {k}",
               atol, rtol)
        # the first AdamW step moves a weight by lr * g / (|g| + eps): for
        # |g| within ten eps = 1e-7 it turns a float32-order difference of
        # 1e-9 in g into 1e-2 of the step, so those weights are held
        # through their moments above (at most 2 % of them; an untouched
        # weight, g = 0, moves by its weight decay only and is held)
        g = np.abs(j_m[k].astype(np.float32) / 0.1)
        live = (g >= 1e-7) | (g == 0)
        eps_regime += int((~live).sum())
        _close(v.float().numpy()[live], want[k].astype(np.float32)[live], k,
               atol, rtol)
    assert eps_regime <= sum(x.size for x in want.values()) // 50
    for name in ("s", "w"):
        _close(getattr(tstate.scores, name).numpy(),
               getattr(new.scores, name), name)
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(new.scores.seen))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_greedy_generate_match_jax(arch):
    """The JAX ``Server``'s jitted prefill and decode against the port's
    (bfloat16 KV caches, float32 SSM caches), then both servers' greedy
    ``generate``, which reuses the same two compiled functions."""
    cfg, _, state = _jax_run(arch)[:3]
    if cfg.num_experts:
        # dropless: a decode step routes B tokens, a prefill B * P
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts))
    Bs, P, G = 2, 12, 4
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (Bs, P + G)).astype(np.int32)
    js = JaxServer(cfg, params=state.params)
    # the same two functions, compiled with LLVM's backend optimisations
    # off (the same HLO, a quicker compile)
    js._prefill = fast_jit(lambda p, bt, c: jmodel.prefill(cfg, p, bt, c,
                                                          CTX))
    js._decode = fast_jit(lambda p, t, c, pos: jmodel.decode_step(
        cfg, p, t, c, pos, CTX))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_jax(jax.device_get(state.params))
    jcache = jmodel.init_cache(cfg, Bs, P + G)
    tcache = tmodel.init_cache(tcfg, Bs, P + G, device="cpu")
    want, jcache = js._prefill(state.params,
                               {"tokens": jnp.asarray(toks[:, :P])}, jcache)
    with torch.no_grad():
        got, tcache = tmodel.prefill(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :P])}, tcache)
    assert got.dtype == torch.float32 and got.shape == (Bs, cfg.vocab_size)
    _close(got, want, "prefill logits", 2e-3, 1e-3)
    for t in range(G - 1):
        want, jcache = js._decode(state.params,
                                  jnp.asarray(toks[:, P + t][:, None]),
                                  jcache, jnp.int32(P + t))
        with torch.no_grad():
            got, tcache = tmodel.decode_step(
                tcfg, tparams, torch.from_numpy(toks[:, P + t][:, None]),
                tcache, torch.tensor([P + t]))
        _close(got, want, f"decode step {t}", 2e-3, 1e-3)
    flat_t, flat_j = _flat_torch(tcache), _flat(jcache)
    assert set(flat_t) == set(flat_j)
    for k, v in flat_t.items():
        assert v.shape == flat_j[k].shape, k
        _close(v.float().numpy(), flat_j[k].astype(np.float32), k, 2e-3,
               1e-3)
    wtok = js.generate(toks[:, :P], gen_len=G)
    gtok = tserve.Server(tcfg, device="cpu", params=tparams).generate(
        toks[:, :P], gen_len=G)
    np.testing.assert_array_equal(gtok, np.asarray(wtok))


def _packed_step_pair(cfg):
    es_cfg = jengine.ESConfig(method="es", minibatch=6, n_train=40,
                              seq_chunk=0)
    eng = jengine.ESEngine(cfg, es_cfg, OptConfig(lr=1e-3),
                           get_schedule("cosine", 16, 0), CTX)
    teng = tengine.ESEngine(ModelConfig(**dataclasses.asdict(cfg)),
                            tengine.ESConfig(method="es", minibatch=6,
                                             n_train=40),
                            TOptConfig(lr=1e-3),
                            t_get_schedule("cosine", 16, 0))
    return eng, teng


def test_moe_packed_step_matches_jax():
    """Token-level ES over packed rows (``segment_ids``) on grok-1 smoke:
    the losses, kept count, store and parameters as JAX's."""
    cfg, _, state = _jax_run("grok-1-314b")[:3]
    src = JaxPackedSource.synthetic(40, S, max_segments=4, seed=2)
    host = src.batch(np.arange(B))
    state = dataclasses.replace(state, scores=ESScores(
        s=jnp.ones(40, jnp.float32), w=jnp.ones(40, jnp.float32),
        seen=jnp.zeros(40, jnp.int32)))
    eng, teng = _packed_step_pair(cfg)
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(
        jax.random.split(state.rng)[1], (B * 4,), jnp.float32)).copy())
    tstate = tengine.init_train_state(
        teng.model_cfg, teng.es_cfg, teng.opt_cfg, 0, "cpu",
        params=params_from_jax(jax.device_get(state.params)))
    tstate.scores.s.fill_(1.0)
    tstate.scores.w.fill_(1.0)
    new, jm = fast_jit(eng.packed_step)(state, {k: jnp.asarray(v)
                                               for k, v in host.items()})
    tstate, m = teng.packed_step(tstate, {k: torch.from_numpy(v.copy())
                                          for k, v in host.items()},
                                 gumbel=gumbel)
    assert float(m["bp_samples"]) == float(jm["bp_samples"]) == 6
    for k in ("loss", "sel_loss"):
        _close(float(m[k]), float(jm[k]), k)
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(new.scores.seen))
    _close(tstate.scores.s.numpy(), new.scores.s, "s")
    got, want = _flat(params_to_numpy(tstate.params)), _flat(new.params)
    for k in want:
        g = np.abs(np.asarray(_flat(new.opt.m)[k]) / 0.1)
        live = (g >= 1e-7) | (g == 0)       # AdamW's eps regime, as above
        _close(got[k][live], want[k][live], k)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_packing_raises_for_ssm_and_hybrid(arch):
    tcfg = ModelConfig(**dataclasses.asdict(get_smoke_config(arch)))
    params = ttransformer.init_lm(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    tokens = torch.zeros(2, 8, dtype=torch.int32)
    seg = torch.ones(2, 8, dtype=torch.int32)
    pos = torch.arange(8).expand(2, 8)
    with pytest.raises(NotImplementedError,
                       match="has no segment isolation"):
        ttransformer.lm_hidden(tcfg, params, tokens, positions=pos,
                               segment_ids=seg)
    with pytest.raises(NotImplementedError,
                       match="has no segment isolation"):
        ttransformer.lm_per_segment_loss(
            tcfg, params, {"tokens": tokens, "labels": tokens,
                           "positions": pos, "segment_ids": seg,
                           "doc_ids": torch.zeros(2, 1, dtype=torch.int32)})


@pytest.mark.parametrize("arch", jax_list_archs())
def test_n_params_match_jax(arch):
    """All ten archs: the port's count of the JAX config equals the
    reference's, and the port's own configs (vlm and encdec included) are
    the same dataclass values."""
    lo, hi = {"zamba2-2.7b": (2.0, 3.0), "mamba2-780m": (0.7, 0.9),
              "llama3-8b": (7.5, 8.5), "olmo-1b": (1.0, 1.4),
              "qwen1.5-0.5b": (0.4, 0.55), "qwen2-72b": (70, 75),
              "seamless-m4t-large-v2": (1.4, 2.4),
              "grok-1-314b": (300, 330), "arctic-480b": (460, 500),
              "llama-3.2-vision-11b": (10, 13)}[arch]
    jcfg = jax_get_config(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert tcfg.n_params() == jcfg.n_params()
    assert lo <= tcfg.n_params() / 1e9 <= hi
    for prop in ("is_encdec", "is_attention_free", "supports_long_context",
                 "has_decoder"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(ttransformer_smoke(arch)) == \
        dataclasses.asdict(get_smoke_config(arch))


def ttransformer_smoke(arch):
    from repro_torch.configs import get_smoke_config as t_smoke
    return t_smoke(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip_of_the_family_trees(arch):
    """The families' trees convert leaf for leaf (the hybrid's (n_sites,
    every) stack and its shared block; arctic's bfloat16 leaves, carried
    as float32, arrive as torch.bfloat16, exactly), and the port's own
    init draws the same tree."""
    cfg = get_smoke_config(arch)
    state = _jax_run(arch)[2]
    host = jax.device_get(state.params)
    port = params_from_jax(host)
    want, got = _flat(host), _flat_torch(port)
    assert set(want) == set(got)
    for k, v in got.items():
        bf16 = want[k].dtype.name == "bfloat16"
        assert bf16 == (cfg.param_dtype == "bfloat16"), k
        assert v.dtype == (torch.bfloat16 if bf16 else torch.float32), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      want[k].astype(np.float32), err_msg=k)
    own = _flat_torch(ttransformer.init_lm(
        ModelConfig(**dataclasses.asdict(cfg)),
        torch.Generator().manual_seed(0), "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_params_from_jax_rejects_vlm_and_encdec(arch):
    """Since the vlm and encdec families are ported, their trees convert
    leaf for leaf (the vlm's (n_sites, every) stack and its gated cross
    blocks; the encdec's cross-attention, encoder, frontend_proj and
    enc_final_norm), the port's own init draws the same tree, and a
    cross or encoder entry of no family still raises."""
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jinit_lm(cfg, k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    host = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), shapes)
    want, got = _flat(host), _flat_torch(params_from_jax(host))
    assert set(want) == set(got)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    own = _flat_torch(ttransformer.init_lm(
        ModelConfig(**dataclasses.asdict(cfg)),
        torch.Generator().manual_seed(0), "cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    if cfg.is_encdec:
        bad = {k: v for k, v in host.items() if k != "frontend_proj"}
    else:
        bad = {**host, "cross": {**host["cross"], "shared": host["layers"]}}
    with pytest.raises(ValueError):
        params_from_jax(bad)
