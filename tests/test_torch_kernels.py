"""PyTorch port: the plain versions of the xent, flash-attention and
score-update kernels against the JAX Pallas kernels (interpret mode) and
their XLA oracles, the plain versions of the split xent kernels (partials,
then the fold) against the one-pass nll, and, for every wrapper, the rule
that a wrapper never runs the plain version for a tensor off the CPU. The segment-sum and
quantized-update plain versions are held against JAX in
test_torch_packing.py and test_torch_quant_store.py.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); on the CPU each wrapper takes its
plain version, which is what these tests drive. Tolerances are the JAX
kernel tests' (tests/test_kernels.py): 1e-5 in float32 and 5e-2 in bf16
for xent, 2e-5 / 2e-2 for flash attention, 1e-6 for the score update.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scores import ESScores, make_store
from repro.kernels.flash_attn.flash_attn import flash_attention
from repro.kernels.flash_attn.ops import gqa_flash_attention as jax_gqa
from repro.kernels.flash_attn.ref import attention_ref
from repro.kernels.score_update.score_update import \
    fused_score_update as jax_score_update
from repro.kernels.score_update.ref import score_update_ref as jax_score_ref
from repro.kernels.xent.ops import per_sample_xent_fused as jax_ps_xent
from repro.kernels.xent.ops import per_token_xent_fused
from repro.kernels.xent.ref import xent_ref as jax_xent_ref
from repro.models.layers import ShardCtx
from repro.models.losses import per_sample_xent as jax_per_sample_xent
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ops import gqa_flash_attention
from repro_torch.kernels.score_update import ops as score_ops
from repro_torch.kernels.score_update.ops import (fused_quant_score_update,
                                                  fused_score_update,
                                                  quant_grow_scales,
                                                  quant_ring_slots)
from repro_torch.kernels.score_update.ref import score_update_ref
from repro_torch.kernels.segsum import ops as segsum_ops
from repro_torch.kernels.segsum.ops import segment_sum, segment_sum_grad
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent.ops import (fused_xent, per_sample_xent_fused,
                                          vocab_split, xent_combine,
                                          xent_partials)
from repro_torch.kernels.xent.ref import (xent_combine_ref, xent_partials_ref,
                                          xent_ref)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(JDT[dtype])
    return j, torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# xent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [100, 192, 300])
@pytest.mark.parametrize("V", [500, 777])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_plain_matches_pallas_and_oracle(M, V, dtype):
    """Ragged M against the 128-row block and ragged V against the 512
    vocab tile; the port reads the (V, d) table, JAX its (d, V) transpose."""
    rng = np.random.default_rng(M * V)
    d = 64
    h_j, h_t = _pair(rng.normal(size=(M, d)), dtype)
    w_j, w_t = _pair(rng.normal(size=(V, d)) * 0.1, dtype)
    labels = rng.integers(0, V, M).astype(np.int32)
    got = fused_xent(h_t, w_t, torch.from_numpy(labels))
    kern = per_token_xent_fused(h_j, w_j.T, jnp.asarray(labels),
                                block_m=128, interpret=True)
    oracle = jax_xent_ref(h_j, w_j.T, jnp.asarray(labels))
    tol = 1e-5 if dtype == "float32" else 5e-2
    assert got.dtype == torch.float32 and got.shape == (M,)
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


def test_xent_per_sample_masking():
    rng = np.random.default_rng(2)
    B, S, d, V = 4, 32, 64, 512
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, -8:] = -1                            # masked tail
    labels[1, :] = -1                              # fully masked row
    ps, mean = per_sample_xent_fused(torch.from_numpy(h), torch.from_numpy(w),
                                     torch.from_numpy(labels))
    ps_k, mean_k = jax_ps_xent(jnp.asarray(h), jnp.asarray(w).T,
                               jnp.asarray(labels), interpret=True)
    ps_x, _ = jax_per_sample_xent(jnp.asarray(h), jnp.asarray(w).T,
                                  jnp.asarray(labels), ctx=ShardCtx(),
                                  seq_chunk=0)
    np.testing.assert_allclose(_np(ps), _np(ps_k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ps), _np(ps_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(mean), float(mean_k), atol=1e-5)
    assert float(ps[1]) == 0.0


@pytest.mark.parametrize("V", [500, 777])
@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_xent_split_partials_fold_to_plain(V, n_split):
    """The plain versions of the card's two kernels (per-split partials,
    then the fold over splits) give the one-pass nll of ``xent_ref``
    (held against JAX above): 1, 3 and more splits than the 256-column
    vocab tiles (2 at V = 500, 4 at V = 777)."""
    rng = np.random.default_rng(V + n_split)
    M, d = 50, 64
    h = torch.from_numpy(rng.normal(size=(M, d)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, d)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, M).astype(np.int32))
    span = -(-V // n_split)
    part = xent_partials(h, w, labels, span)
    assert part.shape == (M, n_split, 3) and part.dtype == torch.float32
    got = xent_combine(part)
    np.testing.assert_allclose(got.numpy(), xent_ref(h, w, labels).numpy(),
                               atol=1e-5, rtol=1e-5)
    want = xent_partials_ref(h, w, labels, span)
    np.testing.assert_array_equal(part.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), xent_combine_ref(part).numpy())


def test_vocab_split_covers_every_column_once():
    """Splits are whole 256-column tiles, none empty, together exactly
    [0, V); at the scoring forward's shape the grid fills 132 SMs."""
    for M in (1, 100, 128, 1000, 16384):
        for V in (1, 130, 256, 257, 777, 151936):
            for sms in (1, 114, 132):
                n, span = vocab_split(M, V, sms)
                assert span % 256 == 0 and 1 <= n <= 64
                cols = np.concatenate([
                    np.arange(s * span, min((s + 1) * span, V))
                    for s in range(n)])
                np.testing.assert_array_equal(cols, np.arange(V))
    n, _ = vocab_split(16384, 151936, 132)
    assert 128 * n >= 132


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(causal):
    """(BH, S, hd) kernel layout: the port sees it as H = K = 1."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 128, 32)).astype(np.float32)
               for _ in range(3))
    got = gqa_flash_attention(*(torch.from_numpy(x)[:, :, None]
                                for x in (q, k, v)), causal=causal)[:, :, 0]
    kern = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           block_q=64, block_k=64, causal=causal,
                           interpret=True)
    oracle = attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=causal)
    np.testing.assert_allclose(_np(got), _np(kern), atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_gqa_matches_pallas_wrapper(dtype):
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 2, 128, 8, 2, 32
    q_j, q_t = _pair(rng.normal(size=(B, S, H, hd)), dtype)
    k_j, k_t = _pair(rng.normal(size=(B, S, K, hd)), dtype)
    v_j, v_t = _pair(rng.normal(size=(B, S, K, hd)), dtype)
    got = gqa_flash_attention(q_t, k_t, v_t)
    kern = jax_gqa(q_j, k_j, v_j, block_q=64, block_k=64, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol)


# ---------------------------------------------------------------------------
# score update
# ---------------------------------------------------------------------------

def _scores(n: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    s = np.abs(rng.normal(size=n)).astype(np.float32)
    w = np.abs(rng.normal(size=n)).astype(np.float32)
    seen = rng.integers(0, 5, n).astype(np.int32)
    losses = np.abs(rng.normal(size=B)).astype(np.float32)
    return s, w, seen, losses


@pytest.mark.parametrize("n,B,b1,b2", [(64, 16, 0.2, 0.9),
                                       (1024, 32, 0.2, 0.9),
                                       (2048, 64, 0.5, 0.8)])
def test_score_update_plain_unique_ids(n, B, b1, b2):
    s, w, seen, losses = _scores(n, B, n + B)
    ids = np.random.default_rng(1).choice(n, B, replace=False).astype(np.int32)
    got = fused_score_update(*(torch.from_numpy(x.copy())
                               for x in (s, w, seen, ids, losses)),
                             beta1=b1, beta2=b2)
    ref = jax_score_ref(*(jnp.asarray(x) for x in (s, w, seen, ids, losses)),
                        beta1=b1, beta2=b2)
    kern = jax_score_update(*(jnp.asarray(x) for x in (s, w, seen, ids,
                                                       losses)),
                            beta1=b1, beta2=b2, interpret=True)
    for g, r, k in zip(got, ref, kern):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-6)


def test_score_update_plain_is_in_place():
    s, w, seen, losses = _scores(32, 4, 0)
    ts, tw, tseen = (torch.from_numpy(x.copy()) for x in (s, w, seen))
    out = fused_score_update(ts, tw, tseen, torch.tensor([1, 5, 9, 30],
                                                         dtype=torch.int32),
                             torch.from_numpy(losses), beta1=0.2, beta2=0.9)
    assert out[0] is ts and out[1] is tw and out[2] is tseen
    assert tseen.sum().item() == seen.sum() + 4


def test_score_update_plain_duplicate_id_pin():
    """Sequential Eq. (3.1) on duplicates: s = 0.5*1 + 0.5*2 = 1.5, then
    0.5*1.5 + 0.5*4 = 2.75 (the scatter's last write would give 2.5)."""
    s, w, seen = torch.ones(1), torch.ones(1), torch.zeros(1, dtype=torch.int32)
    fused_score_update(s, w, seen, torch.zeros(2, dtype=torch.int32),
                       torch.tensor([2.0, 4.0]), beta1=0.5, beta2=0.5)
    assert float(s[0]) == 2.75 and int(seen[0]) == 2
    js, _, jseen = jax_score_update(jnp.ones(1), jnp.ones(1),
                                    jnp.zeros(1, jnp.int32),
                                    jnp.zeros(2, jnp.int32),
                                    jnp.asarray([2.0, 4.0]), beta1=0.5,
                                    beta2=0.5, interpret=True)
    assert float(js[0]) == 2.75 and int(jseen[0]) == 2


def test_score_update_plain_drops_negative_and_out_of_range_ids():
    n = 16
    s, w, seen, losses = _scores(n, 6, 7)
    ids = np.array([3, -1, 16, 3, 40, 15], np.int32)
    got = fused_score_update(*(torch.from_numpy(x.copy())
                               for x in (s, w, seen, ids, losses)),
                             beta1=0.2, beta2=0.9)
    want = make_store(None).update(
        ESScores(s=jnp.asarray(s), w=jnp.asarray(w), seen=jnp.asarray(seen)),
        jnp.asarray(ids), jnp.asarray(losses), 0.2, 0.9, fused=True,
        interpret=True)
    for g, x in zip(got, (want.s, want.w, want.seen)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)
    untouched = np.setdiff1d(np.arange(n), [3, 15])
    np.testing.assert_array_equal(got[0].numpy()[untouched], s[untouched])


def test_score_update_chunks_keep_sequence(monkeypatch):
    """A batch above the kernel's chunk goes chunk by chunk, in order
    (here 8 ids a chunk; on the CPU into the plain version): duplicates
    split across chunk boundaries still apply in sequence, bitwise as one
    plain pass and within 1e-6 of JAX's sequential kernel."""
    n, B = 40, 50
    s, w, seen, losses = _scores(n, B, 11)
    ids = np.random.default_rng(2).integers(-2, n + 2, B).astype(np.int32)
    ids[8] = ids[7]                  # across the first boundary
    ids[30] = ids[17] = ids[3]       # three chunks
    want = score_update_ref(*(torch.from_numpy(x.copy())
                              for x in (s, w, seen, ids, losses)),
                            beta1=0.2, beta2=0.9)
    calls = []
    monkeypatch.setattr(score_ops, "CHUNK", 8)
    monkeypatch.setattr(score_ops, "score_update_ref",
                        lambda *a, **k: calls.append(a[3].shape[0]) or
                        score_update_ref(*a, **k))
    got = fused_score_update(*(torch.from_numpy(x.copy())
                               for x in (s, w, seen, ids, losses)),
                             beta1=0.2, beta2=0.9)
    assert calls == [8] * 6 + [2]
    jax_got = make_store(None).update(
        ESScores(s=jnp.asarray(s), w=jnp.asarray(w), seen=jnp.asarray(seen)),
        jnp.asarray(ids), jnp.asarray(losses), 0.2, 0.9, fused=True,
        interpret=True)
    for g, x, j in zip(got, want, (jax_got.s, jax_got.w, jax_got.seen)):
        np.testing.assert_array_equal(g.numpy(), x.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6)


# ---------------------------------------------------------------------------
# off the CPU a wrapper launches its kernel or raises
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_plain(*_, **__):
    raise AssertionError("the plain version ran for a tensor off the CPU")


CALLS = {
    "xent": (xent_ops, "xent_ref", fused_xent, lambda: fused_xent(
        _meta((8, 64), torch.bfloat16), _meta((50, 64), torch.bfloat16),
        _meta((8,), torch.int32))),
    "xent_partials": (xent_ops, "xent_partials_ref", xent_partials,
                      lambda: xent_partials(
                          _meta((8, 64), torch.bfloat16),
                          _meta((50, 64), torch.bfloat16),
                          _meta((8,), torch.int32), 256)),
    "xent_combine": (xent_ops, "xent_combine_ref", xent_combine,
                     lambda: xent_combine(_meta((8, 3, 3), torch.float32))),
    "flash": (flash_ops, "flash_attention_ref", gqa_flash_attention,
              lambda: gqa_flash_attention(
                  *(_meta((1, 16, 2, 64), torch.bfloat16) for _ in range(3)))),
    "score_update": (score_ops, "score_update_ref", fused_score_update,
                     lambda: fused_score_update(
                         _meta((8,), torch.float32), _meta((8,), torch.float32),
                         _meta((8,), torch.int32), _meta((2,), torch.int32),
                         _meta((2,), torch.float32), beta1=0.2, beta2=0.9)),
    "segment_sum": (segsum_ops, "segment_sum_ref", segment_sum,
                    lambda: segment_sum(_meta((2, 16), torch.float32),
                                        _meta((2, 16), torch.int32),
                                        _meta((2, 16), torch.bool),
                                        max_segments=4)),
    "segment_sum_grad": (segsum_ops, "segment_sum_grad_ref",
                         segment_sum_grad,
                         lambda: segment_sum_grad(
                             _meta((2, 4), torch.float32),
                             _meta((2, 16), torch.int32),
                             _meta((2, 16), torch.bool), max_segments=4)),
    "quant_score_update": (
        score_ops, "quant_score_update_ref", fused_quant_score_update,
        lambda: fused_quant_score_update(
            *(_meta((8,), torch.int8) for _ in range(3)),
            *(_meta((1,), torch.float32) for _ in range(2)),
            *(_meta((4,), dt) for dt in (torch.int32, torch.int32,
                                         torch.float32, torch.float32)),
            *(_meta((2,), dt) for dt in (torch.int32, torch.int32,
                                         torch.float32, torch.int32,
                                         torch.int32)),
            beta1=0.2, beta2=0.9, block=8)),
    "quant_grow_scales": (
        score_ops, "quant_grow_scales_ref", quant_grow_scales,
        lambda: quant_grow_scales(
            *(_meta((8,), torch.int8) for _ in range(2)),
            *(_meta((1,), torch.float32) for _ in range(2)),
            *(_meta((4,), dt) for dt in (torch.int32, torch.int32,
                                         torch.float32)),
            *(_meta((2,), dt) for dt in (torch.int32, torch.int32,
                                         torch.float32)),
            beta1=0.2, beta2=0.9, block=8)),
    "quant_ring_slots": (
        score_ops, "quant_ring_slots_ref", quant_ring_slots,
        lambda: quant_ring_slots(_meta((4,), torch.int32),
                                 _meta((2,), torch.int32), 8)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_off_cpu_raises_instead_of_plain(name, monkeypatch, tmp_path):
    """A non-CPU tensor never takes the plain version: it fails the
    wrapper's device check, and with the check passed (as a CUDA tensor
    would) the kernel library has to build, which raises on a machine
    without nvcc."""
    module, ref_name, wrapper, call = CALLS[name]
    monkeypatch.setattr(module, ref_name, _no_plain)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    for check in ("_validate", "_validate_quant", "_validate_combine",
                  "_check_leaves"):
        if hasattr(module, check):
            monkeypatch.setattr(module, check, lambda *a: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    launches = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert wrapper.launches == launches
