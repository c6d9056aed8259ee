"""PyTorch port: ``lm_per_sample_loss`` against JAX's on the dense smoke
configs, from parameters converted with ``params_from_jax``.

qwen1.5 covers QKV bias with tied embeddings, llama3 GQA with an untied
head, olmo the non-parametric LayerNorm. Both of the port's forwards are
held to the reference: the training path (plain autograd) and the
``scoring=True`` path (the kernels' plain versions on the CPU). At float32
the tolerance is 1e-4 (atol and rtol); at the default bf16 it is 5e-2,
the JAX kernel tests' bf16 tolerance, since the two frameworks round to
bf16 at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.models.layers import ShardCtx
from repro.models.transformer import init_lm, lm_per_sample_loss
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.models.transformer import \
    lm_per_sample_loss as torch_lm_per_sample_loss

ARCHS = ["qwen1.5-0.5b", "llama3-8b", "olmo-1b"]


def _batch(vocab: int, B: int = 3, S: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)],
                            axis=1).astype(np.int32)
    labels[0, S // 2:] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_per_sample_loss_matches_jax(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    params, _ = init_lm(cfg, jax.random.PRNGKey(1))
    batch = _batch(cfg.vocab_size)
    want, want_mean = lm_per_sample_loss(
        cfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        ShardCtx(), seq_chunk=0)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_jax(jax.device_get(params))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = 1e-4 if dtype == "float32" else 5e-2
    for scoring in (False, True):
        with torch.no_grad():
            got, got_mean = torch_lm_per_sample_loss(tcfg, tparams, tbatch,
                                                     scoring=scoring)
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol, err_msg=f"scoring={scoring}")
        np.testing.assert_allclose(float(got_mean), float(want_mean),
                                   atol=tol, rtol=tol)


def test_non_dense_family_raises():
    # every family is ported (test_torch_families.py,
    # test_torch_crossattn.py); vlm and encdec raise the reference's reason
    # on a batch without their memory
    for arch, why in (("llama-3.2-vision-11b", "vlm needs image embeddings"),
                      ("seamless-m4t-large-v2",
                       "encdec needs frame embeddings")):
        cfg = ModelConfig(**dataclasses.asdict(get_smoke_config(arch)))
        with pytest.raises(ValueError, match=why):
            torch_lm_per_sample_loss(cfg, {}, {"tokens": torch.zeros(1, 2)})
