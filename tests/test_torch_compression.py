"""PyTorch port: int8 gradient compression with error feedback
(``repro_torch/distributed/compression.py`` and ``--grad-compression``)
against the JAX package.

* per-block and per-tensor quantize / dequantize and
  ``compress_decompress`` bitwise equal to JAX's (eager) on the same
  float32 input: a ragged last block, an all-zero block (its scale is the
  floor and it round-trips to 0), a large outlier, ties at .5 (both round
  half to even); the residual carried over 3 calls, bitwise;
* one ES step with ``compress_grads`` against the JAX engine's (jitted)
  from the same state: parameters and store at the step tests' tolerance
  (atol 1e-5, rtol 1e-4; the gradients differ in float32 order), and the
  new residuals (``grad_err``) at the same tolerance but where a gradient
  sits on a rounding tie of the int8 grid: there the two frameworks'
  last-ulp gradients round to neighbouring codes, and the residuals
  differ by exactly one grid step (at most one element in a thousand);
* the trainer with ``grad_compression`` killed mid-epoch and resumed:
  the tail's losses and every leaf of the final state, ``grad_err``
  included, bitwise equal to an uninterrupted run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ATOL, RTOL, _flat, assert_state_close,
                           host_batches, jax_batch, jax_gumbel, make_pair,
                           one_torch_thread, torch_batch)  # noqa: F401
from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import tree_map


def _vector(n, seed, zero_block=None, block=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    x[n // 3] = 50.0                           # one outlier
    x[min(7, n - 1)] = 0.0
    if zero_block is not None:
        x[zero_block * block:(zero_block + 1) * block] = 0.0
    return x


def _eq(got, want, what):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("n,block,zero_block", [
    (1000, 256, 1),       # ragged tail of 232, one all-zero block
    (4096, 256, None),
    (777, 64, 0),
    (5, 256, None)])      # one short block
def test_block_quantize_and_compress_bitwise(n, block, zero_block):
    x = _vector(n, n, zero_block, block)
    q, s = tc.quantize_int8_blocks(torch.from_numpy(x), block)
    jq, js = jc.quantize_int8_blocks(jnp.asarray(x), block)
    _eq(q, jq, "codes")
    _eq(s, js, "scales")
    if zero_block is not None:
        assert s[zero_block] == np.float32(tc.SCALE_FLOOR)
    deq = tc.dequantize_int8_blocks(q, s, block)
    if zero_block is not None:
        assert not deq[zero_block * block:(zero_block + 1) * block].any()
    _eq(deq, jc.dequantize_int8_blocks(jq, js, block), "dequantized")
    err = _vector(n, n + 1) * 1e-3
    d, e = tc.compress_decompress(torch.from_numpy(x),
                                  torch.from_numpy(err), block)
    jd, je = jc.compress_decompress(jnp.asarray(x), jnp.asarray(err), block)
    _eq(d, jd, "compress_decompress")
    _eq(e, je, "residual")


def test_per_tensor_quantize_and_ties_bitwise():
    # values on the grid's half steps: round half to even in both
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.0, 0.0], np.float32)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    _eq(q, jq, "codes")
    _eq(s, js, "scale")
    assert q.tolist()[:6] == [127, 0, 2, 2, 0, -2]
    _eq(tc.dequantize_int8(q, s), jc.dequantize_int8(jq, js), "deq")
    assert tc.wire_bytes_per_element(8) == jc.wire_bytes_per_element(8)


def test_residual_carried_over_three_calls_bitwise():
    g = [torch.from_numpy(_vector(600, s).reshape(20, 30))
         for s in range(3)]
    err = tc.ErrorFeedbackState.init({"w": g[0]})["w"]
    jerr = jc.ErrorFeedbackState.init({"w": jnp.asarray(g[0].numpy())})["w"]
    assert err.dtype == torch.float32 and not err.any()
    for i in range(3):
        d, err = tc.compress_decompress(g[i], err)
        jd, jerr = jc.compress_decompress(jnp.asarray(g[i].numpy()), jerr)
        _eq(d, jd, f"call {i}")
        _eq(err, jerr, f"residual {i}")
        assert err.abs().max() > 0


def _assert_residuals_close(got, want, grads, block=256):
    """``got`` and ``want`` residuals within (ATOL, RTOL), but where the
    gradient lies on a half step of its block's int8 grid (within 1e-3 of
    a step): there they differ by one grid step."""
    n_ties = 0
    for k in want:
        assert got[k].dtype == np.float32
        g = grads[k].reshape(-1)
        _, scales = tc.quantize_int8_blocks(g, block)
        step = scales.repeat_interleave(block)[:g.numel()].numpy()
        diff = np.abs(got[k] - want[k]).reshape(-1)
        bad = diff > ATOL + RTOL * np.abs(want[k]).reshape(-1)
        frac = np.abs(g.numpy()) / step % 1.0
        assert np.all(np.abs(frac[bad] - 0.5) < 1e-3), k
        np.testing.assert_allclose(diff[bad], step[bad], rtol=1e-3,
                                   err_msg=k)
        n_ties += int(bad.sum())
    assert n_ties <= sum(v.size for v in want.values()) // 1000


def test_es_step_with_grad_compression_matches_jax():
    jeng, jstate, teng, tstate, rng = make_pair(
        opt=dict(compress_grads=True))
    assert set(_flat(tstate.grad_err)) == set(_flat(jstate.grad_err))
    params0 = tree_map(torch.clone, tstate.params)
    host = host_batches(rng, 1)[0]
    gumbel = jax_gumbel(jstate)
    args = (jstate, jax_batch(host))
    # LLVM's backend optimisations off: a third of the compile time, the
    # same HLO (the arithmetic)
    jstate, jm = jax.jit(jeng.es_step).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    tstate, tm = teng.es_step(tstate, torch_batch(host), gumbel=gumbel)
    assert_state_close(tstate, jstate)
    # the step's gradients (the error fed back is 0 at the first step)
    sel = {k: v[tm["selected"]] for k, v in torch_batch(host).items()}
    grads = _flat(teng._loss_and_grads(params0, sel)[2])
    got, want = _flat(tstate.grad_err), _flat(jstate.grad_err)
    assert set(got) == set(want)
    _assert_residuals_close(got, want,
                            {k: torch.from_numpy(v) for k, v in grads.items()})
    assert max(np.abs(v).max() for v in got.values()) > 0


BASE = dict(arch="qwen1.5-0.5b", device="cpu", method="es", meta_batch=8,
            minibatch=2, seq_len=16, n_samples=32, epochs=2,
            grad_compression=True)


def _equal(a, b, prefix=""):
    if isinstance(a, dict):
        assert set(a) == set(b), prefix
        for k in a:
            _equal(a[k], b[k], f"{prefix}/{k}")
        return
    assert a.dtype == b.dtype and torch.equal(a, b), prefix


def test_grad_compression_resume_bit_exact(tmp_path):
    ref = ttrain.Trainer(ttrain.TrainerConfig(**BASE, max_steps=6))
    assert ref.opt_cfg.compress_grads
    ref_out = ref.train()
    ttrain.Trainer(ttrain.TrainerConfig(**BASE, max_steps=3,
                                        ckpt_dir=str(tmp_path))).train()
    res = ttrain.Trainer(ttrain.TrainerConfig(**BASE, max_steps=6,
                                              ckpt_dir=str(tmp_path)))
    assert res.global_step == 3
    out = res.train()
    assert [m["loss"] for m in out["metrics"]] == \
        [m["loss"] for m in ref_out["metrics"][3:]]
    want = ref.engine.state_dict(ref.state)
    got = res.engine.state_dict(res.state)
    assert "grad_err" in want
    _equal(got, want)
