"""PyTorch port: the serving path (KV cache, prefill, decode, ``Server``)
against the JAX package.

On qwen1.5 smoke (QKV bias, tied head) and llama3 smoke (GQA, untied
head) at float32, from parameters converted with ``params_from_jax``:

* ``prefill`` and each ``decode_step`` against JAX's (float32 caches), at
  ``tests/test_decode.py``'s ``atol=2e-3, rtol=1e-3``, the caches too;
  also with query chunks on the prefill (``attn_chunk_q``);
* the port's prefill + decode against its own full forward
  (``lm_hidden`` + ``last_token_logits``) on the growing prefix;
* greedy ``Server.generate`` equals JAX's ``Server`` token for token
  (bfloat16 caches on both sides), and rows are independent;
* ``sample_next`` fed JAX's Gumbel draws equals ``jax.random.categorical``;
* ``repro_torch.launch.serve`` runs with ``--device cpu`` and refuses the
  default ``cuda`` without a GPU; the vlm and encdec families raise "not
  ported".
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fast_jit
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.launch.serve import Server as JaxServer
from repro.models import model as jmodel
from repro.models.layers import ShardCtx
from repro.models.transformer import init_lm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models.layers import unembed_matrix
from repro_torch.models.losses import last_token_logits
from repro_torch.models.transformer import lm_hidden

ARCHS = ["qwen1.5-0.5b", "llama3-8b"]
ATOL, RTOL = 2e-3, 1e-3
CTX = ShardCtx()


def _pair(arch, **over):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32", **over)
    params, _ = init_lm(cfg, jax.random.PRNGKey(2))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params, tcfg, params_from_jax(jax.device_get(params))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("arch,chunk_q", [("qwen1.5-0.5b", 0),
                                          ("llama3-8b", 0),
                                          ("llama3-8b", 4)])
def test_prefill_and_decode_match_jax(arch, chunk_q):
    cfg, params, tcfg, tparams = _pair(arch, attn_chunk_q=chunk_q)
    B, P, T = 2, 12, 4
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P + T)).astype(np.int32)
    jcache = jmodel.init_cache(cfg, B, P + T, dtype=jnp.float32)
    tcache = tmodel.init_cache(tcfg, B, P + T, dtype=torch.float32,
                               device="cpu")
    jprefill = fast_jit(lambda p, b, c: jmodel.prefill(cfg, p, b, c, CTX))
    jdecode = fast_jit(lambda p, t, c, pos: jmodel.decode_step(
        cfg, p, t, c, pos, CTX))
    want, jcache = jprefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                            jcache)
    with torch.no_grad():
        got, tcache = tmodel.prefill(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :P])},
            tcache)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    _close(got, want, "prefill logits")
    for name in ("k", "v"):
        _close(tcache["kv"][name], jcache["kv"][name], f"prefill {name}")
    for t in range(T):
        want, jcache = jdecode(params, jnp.asarray(toks[:, P + t][:, None]),
                               jcache, jnp.int32(P + t))
        with torch.no_grad():
            got, tcache = tmodel.decode_step(
                tcfg, tparams, torch.from_numpy(toks[:, P + t][:, None]),
                tcache, torch.tensor([P + t]))
        _close(got, want, f"decode step {t}")
    for name in ("k", "v"):
        _close(tcache["kv"][name], jcache["kv"][name], f"cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """The port against itself: (prefill, then decode_step) and one full
    forward over the same prefix give the same next-token logits."""
    _, _, tcfg, tparams = _pair(arch)
    B, P, T = 2, 10, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, P + T)).astype(np.int32))

    def full(upto):
        h = lm_hidden(tcfg, tparams, toks[:, :upto])
        return last_token_logits(h[:, -1:], unembed_matrix(tparams["embed"]))

    with torch.no_grad():
        cache = tmodel.init_cache(tcfg, B, P + T, dtype=torch.float32,
                                  device="cpu")
        logits, cache = tmodel.prefill(tcfg, tparams,
                                       {"tokens": toks[:, :P]}, cache)
        _close(logits, full(P).numpy(), "prefill")
        for t in range(T):
            logits, cache = tmodel.decode_step(
                tcfg, tparams, toks[:, P + t:P + t + 1], cache, P + t)
            _close(logits, full(P + t + 1).numpy(), f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax_server(arch):
    cfg, params, tcfg, tparams = _pair(arch)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 7)).astype(np.int32)
    want = JaxServer(cfg, params=params).generate(prompts, gen_len=6)
    server = tserve.Server(tcfg, device="cpu", params=tparams)
    assert server.params is tparams        # read as given, not copied
    got = server.generate(prompts, gen_len=6)
    assert got.dtype == np.int32 and got.shape == (3, 13)
    np.testing.assert_array_equal(got, np.asarray(want))
    # a row's continuation does not depend on the other rows
    np.testing.assert_array_equal(server.generate(prompts[1:2], 6)[0],
                                  got[1])


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
def test_sample_next_with_jax_gumbel_matches_categorical(temperature):
    key = jax.random.PRNGKey(11)
    logits = jax.random.normal(jax.random.PRNGKey(5), (6, 256)) * 3.0
    for i in range(4):
        key, sk = jax.random.split(key)
        want = jax.random.categorical(sk, logits / temperature, -1)
        noise = jax.random.gumbel(sk, logits.shape, logits.dtype)
        got = tserve.sample_next(torch.from_numpy(np.asarray(logits)),
                                 temperature,
                                 torch.from_numpy(np.asarray(noise)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = tserve.sample_next(torch.from_numpy(np.asarray(logits)), 0.0)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jnp.argmax(logits, -1)))


def test_temperature_generate_is_seeded():
    _, _, tcfg, tparams = _pair("qwen1.5-0.5b")
    server = tserve.Server(tcfg, device="cpu", params=tparams)
    prompts = np.zeros((2, 4), np.int32)
    a = server.generate(prompts, 8, temperature=1.0, seed=4)
    np.testing.assert_array_equal(
        a, server.generate(prompts, 8, temperature=1.0, seed=4))
    assert (a < tcfg.vocab_size).all() and a.shape == (2, 12)


def test_serve_cli_on_cpu_and_default_device(capsys):
    report = tserve.main(["--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--gen", "3"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    assert report["device"] == "cpu" and len(report["sample_output"]) == 8
    assert report["tokens_per_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.main(["--batch", "1", "--gen", "1"])
    # vlm and encdec run too, on the server's own stubs (their parity with
    # JAX: test_torch_crossattn.py; moe, ssm, hybrid: test_torch_families)
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        report = tserve.main(["--arch", arch, "--device", "cpu", "--batch",
                              "2", "--prompt-len", "5", "--gen", "3"])
        capsys.readouterr()
        assert len(report["sample_output"]) == 8
        other = ModelConfig(**dataclasses.asdict(get_smoke_config(arch)))
        cache = tmodel.init_cache(other, 1, 4, device="cpu")
        assert set(cache) == {"kv", "cross_kv"}
