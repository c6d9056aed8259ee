"""PyTorch port: the int8 score store against the JAX package.

Both sides start from the same store state (carried across with
``bridge.scores_from_jax``) and take the same ids and losses. The contract
is the reference kernel test's (tests/test_kernels.py): integer leaves
(codes, seen, ring ids and stamps) and scales bitwise equal, the float32
ring residuals within atol 1e-7.

* the ring-slot assignment's plain version against JAX's
  ``_q_ring_slots`` (exact);
* the store's update, plain sequential (the CPU path of the kernel
  wrapper) and scatter form (``fused=False``), against JAX's scatter
  ``_q_apply_fixed`` over a stream of unique-id batches;
* masked ids, a warm ring and duplicate ids against JAX's Pallas kernel in
  interpret mode (the scatter form applies duplicates differently);
* a 3-step ``--quant-scores`` trainer run (method ``order``: no selection
  noise) against the JAX trainer: losses rtol 1e-3 (test_torch_train's),
  seen and ring ids exact, gathered scores within 1e-5;
* numpy emulations of the three CUDA kernels' decompositions (the grow
  kernel's one owner per store block, re-coding only the blocks that
  grew; the slot kernel's sort and rank formula; the apply kernel's
  walk of each id's occurrences with the as-of-i ring rule) held bitwise
  against the plain versions, which the kernels must equal on the card;
* consecutive store updates against JAX's ``_q_update_local`` with no
  scale growing and with exactly one block growing, the grow kernel's
  emulation against JAX's full re-code on the same states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs.registry import get_smoke_config
from repro.core import scores as jscores
from repro.kernels.score_update.score_update import \
    fused_quant_score_update as jax_quant_kernel
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax, scores_from_jax
from repro_torch.configs import ModelConfig
from repro_torch.core import scores as tscores
from repro_torch.kernels.score_update import ops as score_ops
from repro_torch.kernels.score_update.ops import fused_quant_score_update
from repro_torch.kernels.score_update.ref import (quant_grow_scales_ref,
                                                  quant_ring_slots_ref,
                                                  quant_score_update_ref)
from repro_torch.launch import train as ttrain

B1, B2 = 0.2, 0.9
QFIELDS = ("s_q", "w_q", "seen_q", "s_scale", "w_scale", "err_rows",
           "err_seq", "err_s", "err_w")


def _assert_q_equal(got, want):
    """Integer leaves and scales bitwise, residuals to atol 1e-7."""
    for f in QFIELDS:
        g = getattr(got, f).numpy()
        x = np.asarray(getattr(want, f))
        assert g.dtype == x.dtype, f
        if f in ("err_s", "err_w"):
            np.testing.assert_allclose(g, x, atol=1e-7, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, x, err_msg=f)


def _warm(n, block, R, steps, B=48, seed=0):
    """A JAX quantized store advanced ``steps`` unique-id batches."""
    st = jscores.make_store(None, quantize=True, block=block,
                            residual_rows=R)
    qs = st.init_leaf(n)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ids = jnp.asarray(rng.choice(n, B, replace=False), jnp.int32)
        qs = st.update(qs, ids, jnp.asarray(rng.uniform(0.1, 2.0, B),
                                            jnp.float32), B1, B2)
    return st, qs, rng


def _port(qs):
    return scores_from_jax(jax.device_get(qs))


def test_make_store_and_init_leaf_match_jax():
    st = tscores.make_store(None, quantize=True, block=64)
    assert isinstance(st, tscores.QuantizedStore)
    assert isinstance(tscores.make_store(None), tscores.ReplicatedStore)
    # every combination builds: over row blocks (its codes and scales the
    # replicated leaf's, block by block), and with the int8 wire
    two = tscores.ScoreSharding(["cpu", "cpu"])
    sharded = tscores.make_store(two, quantize=True, block=64, wire=True)
    assert isinstance(sharded.inner, tscores.ShardedStore) and sharded.wire
    assert tscores.make_store(None, quantize=True, wire=True).wire
    blocks, whole = sharded.init_leaf(512), st.init_leaf(512, "cpu")
    for f in ("s_q", "seen_q", "s_scale"):
        assert torch.equal(torch.cat(getattr(blocks, f)), getattr(whole, f))
    for n, block in ((512, 64), (100, 1024)):
        got = st.init_leaf(n, "cpu") if block == 64 else \
            tscores.make_store(None, quantize=True,
                               block=block).init_leaf(n, "cpu")
        want = jscores.make_store(None, quantize=True,
                                  block=block).init_leaf(n)
        _assert_q_equal(got, want)
    # the f32 leaf converts too
    f32 = scores_from_jax(jax.device_get(jscores.init_scores(8)))
    assert isinstance(f32, tscores.ESScores) and f32.seen.dtype == torch.int32


@pytest.mark.parametrize("B,R,warm", [(16, 64, 0), (16, 64, 40),
                                      (48, 32, 7)])
def test_ring_slots_match_jax(B, R, warm):
    """Empty, partly stamped and full (B > R) rings; a third of the batch
    masked."""
    rng = np.random.default_rng(B + R + warm)
    seq = np.zeros(R, np.int32)
    seq[:min(warm, R)] = rng.permutation(np.arange(1, warm + 1))[:R]
    mask = rng.random(B) > 0.33
    got = quant_ring_slots_ref(torch.from_numpy(seq), torch.from_numpy(mask))
    want = jscores._q_ring_slots(jnp.asarray(seq), jnp.asarray(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fused", [True, False])
def test_update_stream_matches_jax_scatter(fused):
    """Four unique-id batches from a warm store, the ring roomy enough that
    no live residual is recycled inside a batch: the sequential plain
    version and the scatter form both equal JAX's scatter."""
    n, block, R = 512, 64, 512
    st, qs, rng = _warm(n, block, R, steps=2)
    tst = tscores.make_store(None, quantize=True, block=block,
                             residual_rows=R)
    tqs = _port(qs)
    for _ in range(4):
        ids = rng.choice(n, 48, replace=False).astype(np.int32)
        losses = rng.uniform(0.05, 3.0, 48).astype(np.float32)
        qs = st.update(qs, jnp.asarray(ids), jnp.asarray(losses), B1, B2)
        tst.update(tqs, torch.from_numpy(ids), torch.from_numpy(losses), B1,
                   B2, fused=fused)
        _assert_q_equal(tqs, qs)
        got = tst.gather(tqs, torch.from_numpy(ids))
        want = st.gather(qs, jnp.asarray(ids))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)


@pytest.mark.parametrize("case", ["masked", "warm_ring", "duplicates"])
def test_update_matches_jax_kernel(case):
    """The store update (grow prologue, ring slots, plain sequential
    apply) against JAX's store update through its Pallas kernel in
    interpret mode; and the wrapper alone against the kernel alone on the
    same post-prologue inputs."""
    n, block, R, B = 256, 64, 96, 32
    st, qs, rng = _warm(n, block, R, steps=2, B=B)
    if case == "warm_ring":             # the rows the ring holds, again
        ids = np.asarray(qs.err_rows)[np.asarray(qs.err_rows) >= 0][:B]
    else:
        ids = rng.choice(n, B, replace=False)
    ids = np.asarray(ids, np.int32).copy()
    if case == "masked":
        ids[::3] = -1
        ids[1] = n + 5
    if case == "duplicates":
        ids[5] = ids[2]
        ids[9] = ids[2]
        ids[20] = ids[11]
    losses = rng.uniform(0.05, 3.0, B).astype(np.float32)
    want = st.update(qs, jnp.asarray(ids), jnp.asarray(losses), B1, B2,
                     fused=True, interpret=True)
    tst = tscores.make_store(None, quantize=True, block=block,
                             residual_rows=R)
    tqs = _port(qs)
    tst.update(tqs, torch.from_numpy(ids), torch.from_numpy(losses), B1, B2)
    _assert_q_equal(tqs, want)
    if case == "warm_ring":
        assert (np.asarray(want.err_rows) >= 0).sum() > B   # hits, then new

    # the kernel's contract alone, from JAX's own prologue
    mask = (ids >= 0) & (ids < n)
    pos = jnp.asarray(np.where(mask, ids, 0))
    mg = jnp.asarray(np.where(mask, ids, -1))
    grown = jscores._q_grow_scales(qs, pos, jnp.asarray(mask), mg,
                                   jnp.asarray(losses), B1, B2, block)
    slots, seqs = jscores._q_ring_slots(grown.err_seq, jnp.asarray(mask))
    lids = jnp.asarray(np.where(mask, ids, -1))
    args = [getattr(grown, f) for f in QFIELDS] + [lids, mg,
                                                    jnp.asarray(losses),
                                                    slots, seqs]
    kern = jax_quant_kernel(*args, beta1=B1, beta2=B2, block=block,
                            interpret=True)
    targs = [torch.from_numpy(np.array(a, copy=True)) for a in args]
    out = fused_quant_score_update(*targs, beta1=B1, beta2=B2, block=block)
    names = ("s_q", "w_q", "seen_q", "err_rows", "err_seq", "err_s", "err_w")
    for name, g, k in zip(names, out, kern):
        if name in ("err_s", "err_w"):
            np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(k),
                                          err_msg=name)


def test_quant_trainer_matches_jax_trainer():
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    common = dict(arch="qwen1.5-0.5b", smoke=True, method="order",
                  meta_batch=16, minibatch=4, seq_len=32, n_samples=64,
                  max_steps=3, quant_scores=True, quant_block=16)
    jt = JaxTrainer(JaxTrainerConfig(**common), model_cfg=cfg)
    params0 = jax.device_get(jt.state.params)
    want = [r["loss"] for r in jt.train()["metrics"]]
    tt = ttrain.Trainer(ttrain.TrainerConfig(device="cpu", **common),
                        model_cfg=ModelConfig(**dataclasses.asdict(cfg)),
                        init_params=params_from_jax(params0))
    got = [r["loss"] for r in tt.train()["metrics"]]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    jq, tq = jt.state.scores, tt.state.scores
    assert isinstance(tq, tscores.QuantizedScores)
    for f in ("seen_q", "err_rows"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    assert int(tq.seen_q.to(torch.int32).sum()) == 3 * 16
    ids = np.arange(64, dtype=np.int32)
    got_sw = tt.store.gather(tq, torch.from_numpy(ids))
    want_sw = jt.score_store.gather(jq, jnp.asarray(ids))
    for g, w in zip(got_sw, want_sw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# ---------------------------------------------------------------------------
# the CUDA kernels' decompositions, emulated in numpy
# ---------------------------------------------------------------------------

F32 = np.float32
INT_MAX = np.iinfo(np.int32).max


def _eq31(s_prev, loss, b1=B1, b2=B2):
    """Eq. (3.1) in float32 scalars, the kernels' operation order."""
    w_new = F32(b1) * s_prev + F32(1.0 - b1) * loss
    s_new = F32(b2) * s_prev + F32(1.0 - b2) * loss
    return w_new, s_new


def _newest(rows, seq, gid, valid=None):
    """Index of the newest entry of ``gid`` (largest stamp > 0, lowest
    index on a tie) among ``valid`` entries, or None."""
    hit = (rows == gid) & (seq > 0)
    if valid is not None:
        hit &= valid
    if not hit.any():
        return None
    stamped = np.where(hit, seq, 0)
    return int(np.argmax(stamped))


def _emulate_grow(leaves, ids, gids, losses, block):
    """csrc/quant_prologue.cu:quant_grow_kernel: the first in-range
    position of each store block owns it, folds its positions' needs from
    the pre-batch store and re-codes the block only if a scale grew."""
    s_q, w_q, s_scale, w_scale, rows, seq, es = (np.array(x, copy=True)
                                                 for x in leaves)
    n = s_q.shape[0]
    valid = (ids >= 0) & (ids < n)
    blks = np.where(valid, ids // block, -1)
    for i in np.nonzero(valid)[0]:
        blk = blks[i]
        if (blks[:i] == blk).any():
            continue
        need_s = need_w = F32(0)
        old_s, old_w = s_scale[blk], w_scale[blk]
        for j in np.nonzero(blks == blk)[0]:
            at = _newest(rows, seq, gids[j])
            resid = es[at] if at is not None else F32(0)
            s_prev = F32(s_q[ids[j]]) * old_s + resid
            w_new, s_new = _eq31(s_prev, losses[j])
            need_s = max(need_s, abs(s_new) / F32(127))
            need_w = max(need_w, abs(w_new) / F32(127))
        rows_of = slice(blk * block, min(n, (blk + 1) * block))
        for q, scale, old, need in ((s_q, s_scale, old_s, need_s),
                                    (w_q, w_scale, old_w, need_w)):
            new = max(old, need)
            if new > old:
                q[rows_of] = np.rint(q[rows_of].astype(F32) * (old / new)
                                     ).astype(np.int8)
            scale[blk] = new
    return s_q, w_q, s_scale, w_scale


def _emulate_slots(err_seq, ids, n):
    """csrc/quant_prologue.cu:quant_ring_slots_kernel: sort the unique
    64-bit (stamp, index) keys, then each position's slot and stamp from
    its rank (masked positions first, both groups in batch order)."""
    R, B = err_seq.shape[0], ids.shape[0]
    keys = np.sort((err_seq.astype(np.uint64) << np.uint64(32))
                   | np.arange(R, dtype=np.uint64))
    oldest = (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
    k = min(B, R)
    masked = ~((ids >= 0) & (ids < n))
    before = np.concatenate([[0], np.cumsum(masked)[:-1]])
    rank = np.where(masked, before, masked.sum() + np.arange(B) - before)
    slots = np.where(rank < B - k, R, oldest[np.clip(B - 1 - rank, 0, R - 1)])
    return slots.astype(np.int32), (err_seq.max() + 1 + rank).astype(np.int32)


def _emulate_apply(leaves, ids, gids, losses, slots, seqs, block):
    """csrc/quant_score_update.cu: the first occurrence of each id walks
    its occurrences in batch order; a residual comes from the latest
    earlier occurrence that wrote a slot < R, else from the pre-batch
    ring snapshot among the slots no earlier position writes."""
    (s_q, w_q, seen_q, s_scale, w_scale, rows, seq, es,
     ew) = (np.array(x, copy=True) for x in leaves)
    n, R, B = s_q.shape[0], rows.shape[0], ids.shape[0]
    snap_rows, snap_seq, snap_es = rows.copy(), seq.copy(), es.copy()
    valid = (ids >= 0) & (ids < n)
    first_w = np.full(R, INT_MAX, np.int64)
    for i in range(B):
        if valid[i] and 0 <= slots[i] < R:
            first_w[slots[i]] = min(first_w[slots[i]], i)
    for i in np.nonzero(valid)[0]:
        idx = ids[i]
        if (ids[:i] == idx).any():
            continue
        blk = idx // block
        ssc, wsc = s_scale[blk], w_scale[blk]
        code_s, seen = int(s_q[idx]), int(seen_q[idx])
        wrote, last_es = False, F32(0)
        for p in np.nonzero(ids == idx)[0]:
            if p < i:
                continue
            if wrote:
                resid = last_es
            else:
                at = _newest(snap_rows, snap_seq, gids[p], first_w >= p)
                resid = snap_es[at] if at is not None else F32(0)
            s_prev = F32(code_s) * ssc + resid
            w_new, s_new = _eq31(s_prev, losses[p])
            q_s = np.clip(np.rint(s_new / ssc), -127, 127).astype(F32)
            q_w = np.clip(np.rint(w_new / wsc), -127, 127).astype(F32)
            code_s, code_w, seen = int(q_s), int(q_w), min(seen + 1, 127)
            if 0 <= slots[p] < R:
                rows[slots[p]], seq[slots[p]] = gids[p], seqs[p]
                es[slots[p]] = s_new - q_s * ssc
                ew[slots[p]] = w_new - q_w * wsc
                wrote, last_es = True, es[slots[p]]
        s_q[idx], w_q[idx], seen_q[idx] = code_s, code_w, seen
    return s_q, w_q, seen_q, rows, seq, es, ew


def _warm_port(n, block, R, steps, B, seed):
    """A port store on the CPU advanced ``steps`` batches (duplicates
    included), so the ring holds many rows and has wrapped."""
    st = tscores.make_store(None, quantize=True, block=block,
                            residual_rows=R)
    qs = st.init_leaf(n, "cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ids = rng.integers(0, n, B).astype(np.int32)
        st.update(qs, torch.from_numpy(ids),
                  torch.from_numpy(rng.uniform(0.1, 2.0, B).astype(F32)),
                  B1, B2)
    return st, qs, rng


EMU_CASES = {
    # name: (n, block, R, B, warm steps)
    "duplicates": (256, 64, 96, 32, 3),
    "masked": (256, 64, 96, 32, 3),
    "b_gt_r": (1000, 16, 64, 100, 2),
    "warm_wrapped_ring": (256, 64, 48, 40, 4),
}


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_kernel_decompositions_match_plain(case):
    """Each kernel's per-position decomposition, emulated in numpy, equals
    its plain (sequential) version bitwise, residuals included: the grow
    on the pre-batch store, the slots on the grown store, the apply on
    the store the two leave."""
    n, block, R, B, warm = EMU_CASES[case]
    _, qs, rng = _warm_port(n, block, R, warm, 48, seed=len(case))
    assert int((qs.err_seq > 0).sum()) == R        # the ring has wrapped
    if case == "warm_wrapped_ring":                 # rows the ring holds
        ring = qs.err_rows.numpy()
        ids = rng.choice(ring[ring >= 0], B).astype(np.int32)
    else:
        ids = rng.integers(0, n, B).astype(np.int32)
    ids[5] = ids[9] = ids[2]                        # a triple
    ids[20] = ids[11]
    if case in ("masked", "b_gt_r"):
        ids[::7] = -1
        ids[3] = n + 5
        ids[14] = ids[7]                            # masked duplicate
    losses = rng.uniform(0.05, 3.0, B).astype(F32)
    t_ids, t_losses = torch.from_numpy(ids), torch.from_numpy(losses)

    grow_in = [getattr(qs, f).clone() for f in
               ("s_q", "w_q", "s_scale", "w_scale", "err_rows", "err_seq",
                "err_s")]
    want = quant_grow_scales_ref(*grow_in, t_ids, t_ids, t_losses, beta1=B1,
                                 beta2=B2, block=block)
    got = _emulate_grow([getattr(qs, f).numpy() for f in
                         ("s_q", "w_q", "s_scale", "w_scale", "err_rows",
                          "err_seq", "err_s")], ids, ids, losses, block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    qs.s_q, qs.w_q, qs.s_scale, qs.w_scale = want

    slots, seqs = quant_ring_slots_ref(qs.err_seq, (t_ids >= 0) & (t_ids < n))
    e_slots, e_seqs = _emulate_slots(qs.err_seq.numpy(), ids, n)
    np.testing.assert_array_equal(e_slots, slots.numpy())
    np.testing.assert_array_equal(e_seqs, seqs.numpy())
    if case == "b_gt_r":
        assert int((slots == R).sum()) == B - R     # dropped residuals

    leaves = [getattr(qs, f) for f in QFIELDS]
    emu = _emulate_apply([x.numpy() for x in leaves], ids, ids, losses,
                         slots.numpy(), seqs.numpy(), block)
    ref = quant_score_update_ref(*(x.clone() for x in leaves), t_ids, t_ids,
                                 t_losses, slots, seqs, beta1=B1, beta2=B2,
                                 block=block)
    for name, e, r in zip(("s_q", "w_q", "seen_q", "err_rows", "err_seq",
                           "err_s", "err_w"), emu, ref):
        np.testing.assert_array_equal(e, r.numpy(), err_msg=name)


def test_apply_chunks_match_one_pass(monkeypatch):
    """The int8 wrapper's chunk loop (here 16 ids a chunk, on the CPU
    into the plain version) gives the one-pass plain result."""
    n, block, R, B = 256, 64, 96, 70
    _, qs, rng = _warm_port(n, block, R, 2, 48, seed=7)
    ids = torch.from_numpy(rng.integers(-3, n + 3, B).astype(np.int32))
    ids[40] = ids[3]
    losses = torch.from_numpy(rng.uniform(0.05, 3.0, B).astype(F32))
    slots, seqs = quant_ring_slots_ref(qs.err_seq, (ids >= 0) & (ids < n))
    leaves = [getattr(qs, f) for f in QFIELDS]
    want = quant_score_update_ref(*(x.clone() for x in leaves), ids, ids,
                                  losses, slots, seqs, beta1=B1, beta2=B2,
                                  block=block)
    calls = []
    monkeypatch.setattr(score_ops, "CHUNK", 16)
    monkeypatch.setattr(score_ops, "quant_score_update_ref",
                        lambda *a, **k: calls.append(a[9].shape[0]) or
                        quant_score_update_ref(*a, **k))
    got = fused_quant_score_update(*(x.clone() for x in leaves), ids, ids,
                                   losses, slots, seqs, beta1=B1, beta2=B2,
                                   block=block)
    assert calls == [16, 16, 16, 16, 6]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("growth", ["none", "one_block"])
def test_update_steps_match_jax_update_local(growth):
    """Three consecutive unique-id updates from a warm store against
    JAX's ``_q_update_local`` (scatter form: the same for unique ids), with
    no scale growing in any step, or with exactly one store block growing
    in each. On each step's pre-batch state the grow kernel's emulation
    (re-coding only the grown blocks) equals JAX's full re-code."""
    n, block, R, B = 512, 64, 512, 24
    st, qs, rng = _warm(n, block, R, steps=3)
    tst = tscores.make_store(None, quantize=True, block=block,
                             residual_rows=R)
    tqs = _port(qs)
    for _ in range(3):
        ids = rng.choice(n, B, replace=False).astype(np.int32)
        losses = rng.uniform(0.0, 0.05, B).astype(F32)
        if growth == "one_block":
            losses[0] = 400.0
        pre = {f: np.array(getattr(qs, f)) for f in QFIELDS}
        mask = jnp.ones(B, bool)
        grown = jscores._q_grow_scales(qs, jnp.asarray(ids), mask,
                                       jnp.asarray(ids), jnp.asarray(losses),
                                       B1, B2, block)
        emu = _emulate_grow([pre[f] for f in ("s_q", "w_q", "s_scale",
                                              "w_scale", "err_rows",
                                              "err_seq", "err_s")],
                            ids, ids, losses, block)
        for f, e in zip(("s_q", "w_q", "s_scale", "w_scale"), emu):
            np.testing.assert_array_equal(e, np.asarray(getattr(grown, f)),
                                          err_msg=f)
        qs = jscores._q_update_local(qs, jnp.asarray(ids), jnp.asarray(ids),
                                     jnp.asarray(losses), B1, B2, block,
                                     False, None)
        tst.update(tqs, torch.from_numpy(ids), torch.from_numpy(losses), B1,
                   B2)
        _assert_q_equal(tqs, qs)
        changed = ((np.asarray(qs.s_scale) != pre["s_scale"])
                   | (np.asarray(qs.w_scale) != pre["w_scale"]))
        assert int(changed.sum()) == (1 if growth == "one_block" else 0)
        if growth == "one_block":   # the re-code touched that block only
            other = np.arange(n) // block != ids[0] // block
            recoded = np.asarray(qs.s_q) != pre["s_q"]
            assert not (recoded & other & ~np.isin(np.arange(n), ids)).any()
