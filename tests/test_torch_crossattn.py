"""PyTorch port: the vlm (llama-3.2-vision smoke: 2 sites of 2 layers and a
gated cross block each, GQA 4:2) and encdec (seamless smoke: LayerNorm,
GELU, a 2-layer encoder over 32-wide frames) families against the JAX
package, from parameters carried across with ``params_from_jax`` and the
vlm's gates drawn uniform in +-0.5 on both sides (at init tanh(0) = 0
would cut the cross path off).

At float32 compute, each family's JAX side under ONE jit
(``_jax_run``; eager JAX would compile every op on its own):

* LayerNorm and the GELU MLP against ``repro.models.layers`` at 1e-6;
* ``cross_attn`` (Sq 24 != Sk 16, GQA) and ``encode`` at 1e-5;
* ``lm_per_sample_loss`` on both of the port's forwards and the training
  path's gradients at atol 1e-5, rtol 1e-4;
* one ``es_step`` (B = 4, b = 2) on batches that carry the memory, from
  the same state and Gumbel draws: the selected ids exactly, the losses,
  parameters, AdamW moments and store at atol 1e-5, rtol 1e-4, with
  ``tests/test_torch_families.py``'s AdamW eps-regime exemption;
* the prefill's logits and caches (KV and cross K/V, bfloat16) and 4
  decode steps against JAX's on the same stubs, at
  ``tests/test_decode.py``'s atol 2e-3, rtol 1e-3, and greedy
  ``Server.generate`` with caller-given stubs equal to the JAX
  prefill/decode loop token for token;
* a vlm or encdec batch without its memory raises the reference's reason.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _flat, one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config
from repro.core import engine as jengine
from repro.core.scores import ESScores
from repro.core.selection import gumbel_topk_select
from repro.data.synthetic import SyntheticConfig, SyntheticLM
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.layers import ShardCtx
from repro.models.transformer import encode as jencode
from repro.models.transformer import lm_per_sample_loss
from repro.optim.adamw import OptConfig
from repro.optim.schedule import get_schedule
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.core import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim.adamw import OptConfig as TOptConfig
from repro_torch.optim.schedule import get_schedule as t_get_schedule

ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-large-v2"]
CTX = ShardCtx()
ATOL, RTOL = 1e-5, 1e-4
B, b, N, S = 4, 2, 16, 16
P, G = 12, 5                   # prompt, greedy tokens (4 decode steps)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def _memory_key(cfg):
    return "frames" if cfg.is_encdec else "image_embeds"


def _memory(cfg, rows, length, seed):
    """Standard normal memory rows, rounded to bfloat16 (the server's
    stubs are bfloat16; the same values reach both sides)."""
    width = cfg.frontend_dim if cfg.is_encdec else cfg.d_model
    x = np.random.default_rng(seed).standard_normal((rows, length, width))
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _inputs(cfg):
    """Host inputs of ``_jax_run``: the loss batch (3 rows of 24 tokens,
    memory of 16 rows: Sq != Sk), the step batch (B synthetic samples of
    S), the prompts and their stubs, the vlm's gates, and the cross and
    norm probes."""
    rng = np.random.default_rng(0)
    key = _memory_key(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((3, 1), -1)],
                            axis=1).astype(np.int32)
    labels[0, 12:] = -1
    loss_batch = {"tokens": tokens, "labels": labels,
                  key: _memory(cfg, 3, 16, 1)}
    ds = SyntheticLM(SyntheticConfig(n_samples=N, seq_len=S, vocab_size=64,
                                     seed=0))
    step_batch = ds.batch(np.random.default_rng(6).permutation(N)[:B])
    step_batch[key] = _memory(cfg, B, 12, 2)
    n_mem = jmodel.encoder_len(cfg, P) if cfg.is_encdec \
        else jmodel.image_tokens(cfg)
    prompts = rng.integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
    aux = {key: _memory(cfg, 2, n_mem, 3)}
    n_cross = cfg.num_layers // cfg.cross_attn_every if \
        cfg.family == "vlm" else 0
    gates = rng.uniform(-0.5, 0.5, (2, n_cross, 1)).astype(np.float32)
    d = cfg.d_model
    probe = {"x": rng.standard_normal((3, 24, d)).astype(np.float32),
             "mem": rng.standard_normal((3, 16, d)).astype(np.float32),
             "scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
             "bias": rng.standard_normal(d).astype(np.float32)}
    s0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    w0 = rng.uniform(0.5, 6.0, N).astype(np.float32)
    return loss_batch, step_batch, prompts, aux, gates, probe, s0, w0


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """Everything the JAX side of an arch's tests computes, under one jit:
    the state (preset store; the vlm's gates set), the norm and GELU MLP,
    cross_attn and encode probes, the loss and its gradients, one
    ``es_step`` and its selected ids, and the greedy prefill/decode loop
    (logits of the prefill and of each decode step, the caches after the
    prefill and at the end, the tokens)."""
    cfg = _cfg(arch)
    es_cfg = jengine.ESConfig(method="es", minibatch=b, n_train=N,
                              seq_chunk=0)
    opt = OptConfig(lr=1e-3)
    eng = jengine.ESEngine(cfg, es_cfg, opt, get_schedule("cosine", 16, 0),
                           CTX)
    loss_batch, step_batch, prompts, aux, gates, probe, s0, w0 = \
        _inputs(cfg)

    def run(key, s, w, loss_batch, step_batch, prompts, aux, gates, probe):
        state = jengine.init_train_state(cfg, es_cfg, opt, key, B)
        params = state.params
        if cfg.family == "vlm":
            params = {**params, "cross": {**params["cross"],
                                          "gate_attn": gates[0],
                                          "gate_mlp": gates[1]}}
        state = dataclasses.replace(state, params=params, scores=ESScores(
            s=s, w=w, seen=jnp.zeros(N, jnp.int32)))
        out = {"params": params}
        # the primitives on probe inputs
        out["layernorm"] = jlayers.layernorm(probe["x"], probe["scale"],
                                             probe["bias"])
        cattn = jax.tree.map(lambda a: a[0], params["cross"]["attn"])
        out["cross_attn"] = jattention.cross_attn(
            cattn, probe["x"], probe["mem"], n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim(),
            ctx=CTX)
        if cfg.is_encdec:
            out["encode"] = jencode(cfg, params, loss_batch["frames"], CTX)
            first = jax.tree.map(lambda a: a[0], params["encoder"]["mlp"])
            out["mlp"] = jlayers.mlp_fwd(cfg.mlp_kind, first, probe["x"],
                                         CTX)

        def loss(p):
            per, mean = lm_per_sample_loss(cfg, p, loss_batch, CTX,
                                           seq_chunk=0)
            return mean, per

        (out["mean"], out["per"]), out["grads"] = jax.value_and_grad(
            loss, has_aux=True)(params)
        new, out["metrics"] = eng.es_step(state, step_batch)
        out["new"] = new
        out["selected"] = gumbel_topk_select(
            jax.random.split(state.rng)[1],
            new.scores.w[step_batch["sample_ids"]], b)
        cache = jmodel.init_cache(cfg, prompts.shape[0], P + G)
        logits, cache = jmodel.prefill(cfg, params,
                                       {"tokens": prompts, **aux}, cache,
                                       CTX)
        out["prefill_cache"] = cache

        def greedy(carry, pos):        # one compiled decode step
            logits, cache = carry
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = jmodel.decode_step(cfg, params, tok[:, None],
                                               cache, pos, CTX)
            return (logits, cache), (tok, logits)

        (last, cache), (toks, steps) = jax.lax.scan(
            greedy, (logits, cache), P + jnp.arange(G - 1, dtype=jnp.int32))
        out["logits"] = jnp.concatenate([logits[None], steps])
        out["tokens"] = jnp.concatenate(
            [toks, jnp.argmax(last, -1).astype(jnp.int32)[None]]).T
        out["cache"] = cache
        return state, out

    args = (jax.random.PRNGKey(0), jnp.asarray(s0), jnp.asarray(w0),
            *[{k: jnp.asarray(v) for k, v in d.items()}
              for d in (loss_batch, step_batch)],
            jnp.asarray(prompts),
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in aux.items()},
            jnp.asarray(gates),
            {k: jnp.asarray(v) for k, v in probe.items()})
    # LLVM's backend optimisations off: the HLO (the arithmetic) is the same
    state, out = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})(*args)
    return cfg, state, jax.device_get(out)


def _port(arch):
    cfg, state, out = _jax_run(arch)
    return (cfg, ModelConfig(**dataclasses.asdict(cfg)),
            params_from_jax(out["params"]), state, out)


def _t(host):
    return {k: torch.from_numpy(np.array(v)) for k, v in host.items()}


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_layernorm_and_gelu_mlp_match_jax():
    """seamless's norm (LayerNorm, epsilon 1e-5, scale and bias) and MLP
    (tanh GELU between biased projections), which no other ported config
    uses, against the reference's on the same inputs."""
    cfg, tcfg, tparams, _, out = _port("seamless-m4t-large-v2")
    probe = _t(_inputs(cfg)[5])
    got = tlayers.layernorm(probe["x"], probe["scale"], probe["bias"])
    _close(got, out["layernorm"], "layernorm", 1e-6, 1e-6)
    got = tlayers.apply_norm("layernorm", probe["x"],
                             {"scale": probe["scale"], "bias": probe["bias"]})
    _close(got, out["layernorm"], "apply_norm", 1e-6, 1e-6)
    first = {k: v[0] for k, v in tparams["encoder"]["mlp"].items()}
    _close(tlayers.mlp_fwd("gelu", first, probe["x"]), out["mlp"], "mlp",
           1e-6, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attn_and_encode_match_jax(arch):
    cfg, tcfg, tparams, _, out = _port(arch)
    probe = _t(_inputs(cfg)[5])
    cattn = {k: v[0] for k, v in tparams["cross"]["attn"].items()}
    got = tattention.cross_attn(cattn, probe["x"], probe["mem"],
                                n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                                head_dim=cfg.resolved_head_dim())
    assert got.shape == (3, 24, cfg.d_model)
    _close(got, out["cross_attn"], "cross_attn")
    if cfg.is_encdec:
        frames = torch.from_numpy(_inputs(cfg)[0]["frames"])
        for scoring in (False, True):
            with torch.no_grad():
                got = ttransformer.encode(tcfg, tparams, frames,
                                          scoring=scoring)
            _close(got, out["encode"], f"encode scoring={scoring}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg, tcfg, tparams, _, out = _port(arch)
    tb = _t(_inputs(cfg)[0])
    with torch.no_grad():
        for scoring in (False, True):
            got, got_mean = ttransformer.lm_per_sample_loss(
                tcfg, tparams, tb, scoring=scoring)
            assert got.dtype == torch.float32 and got.shape == (3,)
            _close(got, out["per"], f"scoring={scoring}")
            _close(float(got_mean), float(out["mean"]), "mean")
    _, _, grads = tengine._value_and_grad(
        tparams, lambda: ttransformer.lm_per_sample_loss(
            tcfg, tparams, tb)[::-1])
    got, want = _flat(grads), _flat(out["grads"])
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_es_step_matches_jax(arch):
    cfg, tcfg, tparams, state, out = _port(arch)
    _, step_batch, *_, s0, w0 = _inputs(cfg)
    key = jax.random.split(state.rng)[1]
    gumbel = torch.from_numpy(np.asarray(
        jax.random.gumbel(key, (B,), jnp.float32)).copy())
    t_es = tengine.ESConfig(method="es", minibatch=b, n_train=N)
    t_opt = TOptConfig(lr=1e-3)
    teng = tengine.ESEngine(tcfg, t_es, t_opt,
                            t_get_schedule("cosine", 16, 0))
    tstate = tengine.init_train_state(tcfg, t_es, t_opt, 0, "cpu",
                                      params=tparams)
    tstate.scores.s.copy_(torch.from_numpy(s0))
    tstate.scores.w.copy_(torch.from_numpy(w0))
    tstate, m = teng.es_step(tstate, _t(step_batch), gumbel=gumbel)
    np.testing.assert_array_equal(m["selected"].numpy(), out["selected"])
    jm, new = out["metrics"], out["new"]
    _close(float(m["loss"]), float(jm["loss"]), "meta loss")
    _close(float(m["sel_loss"]), float(jm["sel_loss"]), "selected loss")
    assert tstate.opt.step == int(new.opt.step) == 1
    got, want = _flat_torch(tstate.params), _flat(new.params)
    assert set(got) == set(want)
    t_m, t_v = _flat_torch(tstate.opt.m), _flat_torch(tstate.opt.v)
    j_m, j_v = _flat(new.opt.m), _flat(new.opt.v)
    eps_regime = 0
    for k, v in got.items():
        _close(t_m[k].numpy(), j_m[k], f"m {k}")
        _close(t_v[k].numpy(), j_v[k], f"v {k}")
        # AdamW's eps regime (tests/test_torch_families.py): a weight whose
        # |g| lies in (0, 1e-7) is held through its moments only
        g = np.abs(j_m[k] / 0.1)
        live = (g >= 1e-7) | (g == 0)
        eps_regime += int((~live).sum())
        _close(v.numpy()[live], want[k][live], k)
    assert eps_regime <= sum(x.size for x in want.values()) // 50
    for name in ("s", "w"):
        _close(getattr(tstate.scores, name).numpy(),
               getattr(new.scores, name), name)
    np.testing.assert_array_equal(tstate.scores.seen.numpy(),
                                  np.asarray(new.scores.seen))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """The prefill's logits and caches (the prefill's own cross K/V,
    sized by the stubs), then 4 decode steps fed JAX's greedy tokens."""
    cfg, tcfg, tparams, _, out = _port(arch)
    _, _, prompts, aux, *_ = _inputs(cfg)
    key = _memory_key(cfg)
    tcache = tmodel.init_cache(tcfg, 2, P + G, device="cpu")
    batch = {"tokens": torch.from_numpy(prompts),
             key: torch.from_numpy(aux[key]).bfloat16()}
    with torch.no_grad():
        got, tcache = tmodel.prefill(tcfg, tparams, batch, tcache)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
    _close(got, out["logits"][0], "prefill logits", 2e-3, 1e-3)
    want_cache = _flat(out["prefill_cache"])
    got_cache = _flat_torch(tcache)
    assert set(got_cache) == set(want_cache)
    for k, v in got_cache.items():
        assert v.shape == want_cache[k].shape, k
        assert v.dtype == torch.bfloat16, k
        _close(v.float().numpy(), want_cache[k].astype(np.float32), k,
               2e-3, 1e-3)
    toks = out["tokens"]
    for t in range(G - 1):
        with torch.no_grad():
            got, tcache = tmodel.decode_step(
                tcfg, tparams, torch.from_numpy(toks[:, t:t + 1].copy()),
                tcache, torch.tensor([P + t]))
        _close(got, out["logits"][t + 1], f"decode step {t}", 2e-3, 1e-3)
    want_cache = _flat(out["cache"])
    for k, v in _flat_torch(tcache).items():
        _close(v.float().numpy(), want_cache[k].astype(np.float32), k,
               2e-3, 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_with_given_stubs_matches_jax(arch):
    cfg, tcfg, tparams, _, out = _port(arch)
    _, _, prompts, aux, *_ = _inputs(cfg)
    server = tserve.Server(tcfg, device="cpu", params=tparams)
    given = {k: torch.from_numpy(v).bfloat16() for k, v in aux.items()}
    gtok = server.generate(prompts, gen_len=G, aux=given)
    np.testing.assert_array_equal(gtok[:, :P], prompts)
    np.testing.assert_array_equal(gtok[:, P:], out["tokens"])
    # without ``aux`` the server draws its stubs: bfloat16, the stub shapes
    stubs = server.stub_inputs(2, P, torch.Generator().manual_seed(0))
    n_mem = tmodel.encoder_len(tcfg, P) if cfg.is_encdec \
        else tmodel.image_tokens(tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in stubs.items()} == \
        {_memory_key(cfg): ((2, n_mem) + aux[_memory_key(cfg)].shape[2:],
                            torch.bfloat16)}
    assert server.generate(prompts, gen_len=3).shape == (2, P + 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_missing_memory_raises_the_references_reason(arch):
    tcfg = ModelConfig(**dataclasses.asdict(get_smoke_config(arch)))
    params = ttransformer.init_lm(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    why = "image embeddings" if tcfg.family == "vlm" else "frame embeddings"
    tokens = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{tcfg.family} needs {why}"):
        ttransformer.lm_per_sample_loss(tcfg, params,
                                        {"tokens": tokens, "labels": tokens})
