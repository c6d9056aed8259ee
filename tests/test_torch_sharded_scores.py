"""PyTorch port: the sharded score store (row blocks over a device list),
its int8 form and wire, host collectives, checkpoints across shard
counts, ``elastic_restart`` and the trainer's ``--shard-scores`` and
``--quant-wire``, against the JAX package.

The reference's sharded store runs under ``shard_map`` on a mesh of
several devices; its own tests force 8 CPU devices in a subprocess. Here
the port's store takes D = 4 row blocks, all on the one CPU, and is held
to the reference in-process:

* the f32 store: updates with duplicate ids (the scatter form against
  ``update_scores``; the kernel form against the port's replicated
  store), gathers against direct loads and the candidate-merge selection
  against ``gumbel_topk_select`` on the same Gumbel noise, bitwise (the
  contracts of ``tests/test_sharded_scores.py:74-160``); set-level
  pruning, ``grow`` and checkpoints across shard counts
  (``:267-345``);
* the int8 store over 4 blocks: every block's codes, scales and ring and
  the gathers bitwise the reference's per-shard body (``_q_init_leaf``,
  ``_q_update_local`` and ``_q_gather_1d`` called on each block's leaf,
  which is what ``shard_map`` runs on each device);
* the int8 wire: the reference's ``QuantizedStore`` itself, its
  ``shard_map`` replaced by ``jax.vmap(..., axis_name="data")`` over a
  leading block axis (one CPU device), for the wire gather
  (``compressed_psum_sum``) and ``_select_wire``; bitwise, and within the
  reference's one grid step of the exact gather
  (``tests/test_quant_store.py:187-218``);
* ``HostComm`` over a ``torch.distributed.HashStore`` with two threads
  against the reference's ``HostComm`` over an in-memory key-value client
  with two threads: the same bytes, f64 kept f64, its keys deleted;
* the trainer with four CPU blocks (``sharding.local_devices``
  replaced): ``score_store_sharded`` true and the losses, kept-sets and
  final store bitwise the replicated run's, a sharded resume bitwise, and
  at one block the reference's warning and a replicated store
  (``tests/test_sharded_scores.py:418``); ``elastic_restart``
  (``tests/test_fault_tolerance.py:58``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import MemoryKV, in_threads
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import pruning as jpruning
from repro.core import scores as jscores
from repro.core.selection import gumbel_topk_select
from repro.distributed import hostcomm as jhostcomm
from repro_torch.bridge import scores_from_jax
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import scores as tscores
from repro_torch.distributed import hostcomm as thostcomm
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.fault_tolerance import elastic_restart
from repro_torch.launch import train as ttrain

D, N, B, T = 4, 64, 16, 5
B1, B2 = 0.2, 0.9
CPU4 = tsharding.score_store_sharding(["cpu"] * D)
QKW = dict(quantize=True, block=8, residual_rows=1024)


def _stream(replace, seed=0, n=N):
    rng = np.random.default_rng(seed)
    for _ in range(T):
        yield (rng.choice(n, B, replace=replace).astype(np.int32),
               rng.uniform(0.1, 3.0, B).astype(np.float32))


def _cat(blocks):
    return torch.cat(blocks).numpy()


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# the f32 store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_run():
    """The scatter-form sharded store and the reference's replicated one
    over the same stream (duplicate ids), with every gather of both."""
    st = tscores.make_store(CPU4)
    leaf = st.init_leaf(N)
    ref = jscores.init_scores(N)
    gathers = []
    for ids, losses in _stream(replace=True):
        gathers.append((st.gather(leaf, torch.from_numpy(ids)),
                        (ref.s[ids], ref.w[ids])))
        st.update(leaf, torch.from_numpy(ids), torch.from_numpy(losses),
                  B1, B2, fused=False)
        ref = jscores.update_scores(ref, jnp.asarray(ids),
                                    jnp.asarray(losses), B1, B2)
    return st, leaf, jax.device_get(ref), gathers


def test_sharded_store_layout_and_errors():
    """make_store builds every combination; each block lies on its device
    at the 1/n prior; indivisible layouts raise the reference's error."""
    st = tscores.make_store(CPU4)
    assert isinstance(st, tscores.ShardedStore)
    leaf = st.init_leaf(N)
    assert [tuple(b.shape) for b in leaf.s] == [(N // D,)] * D
    _eq(_cat(leaf.s), np.asarray(jscores.init_scores(N).s))
    for wire in (False, True):
        q = tscores.make_store(CPU4, wire=wire, **QKW)
        assert isinstance(q.inner, tscores.ShardedStore) and q.wire == wire
    with pytest.raises(ValueError, match="not divisible"):
        st.init_leaf(N + 2)
    with pytest.raises(ValueError, match="does not divide"):
        tscores.make_store(CPU4, quantize=True, block=6).init_leaf(N)
    assert tsharding.score_store_sharding(["cpu"]) is None


def test_update_and_gather_match_reference_bitwise(f32_run):
    st, leaf, ref, gathers = f32_run
    for (s_g, w_g), (s_r, w_r) in gathers:
        _eq(s_g, s_r)
        _eq(w_g, w_r)
    for f in ("s", "w", "seen"):
        _eq(_cat(getattr(leaf, f)), getattr(ref, f), f)


def test_kernel_form_per_block_matches_replicated_kernel():
    """The kernel form (sequential over duplicates) per block is the
    replicated store's kernel form, block for block."""
    st, rep = tscores.make_store(CPU4), tscores.make_store(None)
    leaf, rleaf = st.init_leaf(N), rep.init_leaf(N, "cpu")
    for ids, losses in _stream(replace=True, seed=1):
        st.update(leaf, torch.from_numpy(ids), torch.from_numpy(losses),
                  B1, B2)
        rep.update(rleaf, torch.from_numpy(ids), torch.from_numpy(losses),
                   B1, B2)
    for f in ("s", "w", "seen"):
        _eq(_cat(getattr(leaf, f)), getattr(rleaf, f), f)


@pytest.mark.parametrize("trial,k", [(0, 6), (1, 6), (2, 8), (3, 1)])
def test_candidate_merge_select_matches_reference(trial, k):
    """The per-block top-k merge on the reference's Gumbel draw is the
    reference's replicated selection, order included; with B not divisible
    by D the replicated form runs."""
    st = tscores.make_store(CPU4)
    rng = np.random.default_rng(trial)
    for n_w in (32, 30):
        w = rng.uniform(0.01, 5.0, n_w).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        g = np.asarray(jax.random.gumbel(key, (n_w,), jnp.float32))
        got = st.select(torch.from_numpy(w), k, gumbel=torch.from_numpy(g))
        _eq(got, gumbel_topk_select(key, jnp.asarray(w), k))
    # ties go to the lower position, as jax.lax.top_k
    w = np.ones(32, np.float32)
    got = st.select(torch.from_numpy(w), k,
                    gumbel=torch.zeros(32, dtype=torch.float32))
    _eq(got, np.arange(k))


@pytest.mark.parametrize("method", ["eswp", "infobatch", "ucb", "ka",
                                    "random"])
def test_prune_epoch_matches_reference(f32_run, method):
    st, leaf, ref, _ = f32_run
    prev = np.random.default_rng(1).uniform(0.05, 3.0, N).astype(np.float32)
    res, s_full = st.prune_epoch(method, np.random.default_rng(3), leaf,
                                 prev_losses=prev, ratio=0.25)
    want = jpruning.prune_epoch(method, np.random.default_rng(3),
                                weights=ref.w, losses=ref.s,
                                prev_losses=prev, seen=ref.seen, ratio=0.25)
    _eq(np.sort(res.kept), np.sort(want.kept))
    _eq(s_full, ref.s)
    if want.grad_scale is None:
        assert res.grad_scale is None
    else:
        _eq(res.grad_scale, want.grad_scale)


def test_grow_matches_reference(f32_run, quant_run):
    """f32: the grown blocks are the reference's grown (n,) store. int8:
    the grown blocks' codes and scales, and every row's gather, bitwise
    the reference's replicated grow of the same rows (the per-shard rings
    re-dealt to their new blocks); then updates over old and new rows
    keep every gather the replicated store's."""
    st, leaf, ref, _ = f32_run
    st2, leaf2 = st.grow(leaf, 2 * N)
    _, ref2 = jscores.ReplicatedStore().grow(ref, 2 * N)
    for f in ("s", "w", "seen"):
        _eq(_cat(getattr(leaf2, f)), getattr(ref2, f), f)
    assert [b.shape[0] for b in leaf2.s] == [3 * N // D] * D
    with pytest.raises(ValueError, match="n_new > 0"):
        st.grow(leaf, 0)
    q, qleaf, blocks, _ = quant_run
    qref = jscores.make_store(None, **QKW)
    qr = jscores.QuantizedScores(**{
        f.name: jnp.concatenate([getattr(b, f.name) for b in blocks])
        for f in dataclasses.fields(jscores.QuantizedScores)})
    q2, qleaf2 = q.grow(qleaf, 2 * N)
    _, qr2 = qref.grow(qr, 2 * N)
    for f in ("s_q", "w_q", "seen_q", "s_scale", "w_scale"):
        _eq(_cat(getattr(qleaf2, f)), getattr(qr2, f), f)
    every = torch.arange(3 * N, dtype=torch.int32)
    for got, want in zip(q2.gather(qleaf2, every),
                         qref.gather(qr2, jnp.asarray(every.numpy()))):
        _eq(got, want)
    rep = tscores.make_store(None, **QKW)
    rleaf = scores_from_jax(jax.device_get(qr2))
    for ids, losses in _stream(False, 4, 3 * N):
        for store, lf in ((q2, qleaf2), (rep, rleaf)):
            store.update(lf, torch.from_numpy(ids), torch.from_numpy(losses),
                         B1, B2)
        for got, want in zip(q2.gather(qleaf2, every),
                             rep.gather(rleaf, every)):
            _eq(got, want)


def test_checkpoint_across_shard_counts(f32_run, tmp_path):
    """4 blocks -> 2 blocks and replicated, replicated -> 4 blocks, and a
    sharded int8 leaf -> replicated int8 (codes, scales, ring), each
    bitwise; the manifest records the backend."""
    st, leaf, ref, _ = f32_run
    ck = Checkpointer(tmp_path)
    ck.save({"scores": st.leaf_state(leaf)}, step=1,
            metadata={"score_store": st.checkpoint_spec()})
    assert ck.manifest(1)["metadata"]["score_store"]["kind"] == "sharded"
    two = tscores.make_store(tsharding.score_store_sharding(["cpu"] * 2))
    for other in (two, tscores.make_store(None)):
        like = other.init_leaf(N, "cpu")
        got = other.load_leaf_state(ck.restore(
            {"scores": other.leaf_state(like)}, step=1)["scores"], like)
        for f in ("s", "w", "seen"):
            blocks = getattr(got, f)
            full = _cat(blocks) if isinstance(blocks, list) else blocks
            _eq(full, getattr(ref, f), f)
    rep = tscores.make_store(None)
    ck.save({"scores": rep.leaf_state(tscores.ESScores(
        *(torch.from_numpy(np.array(getattr(ref, f)))
          for f in ("s", "w", "seen"))))}, step=2)
    like = st.init_leaf(N)
    back = st.load_leaf_state(ck.restore({"scores": st.leaf_state(like)},
                                         step=2)["scores"], like)
    _eq(_cat(back.s), ref.s)
    assert [b.shape[0] for b in back.s] == [N // D] * D


# ---------------------------------------------------------------------------
# the int8 store over 4 blocks against the reference's per-shard body
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quant_run():
    """The port's 4-block int8 store (wire off) and the reference's
    per-shard body on each block's leaf, over the same unique-id stream;
    the gathers of both after each update."""
    st = tscores.make_store(CPU4, **QKW)
    leaf = st.init_leaf(N)
    shard = N // D
    blk, nb, ring = st._layout(N)
    blocks = [jscores._q_init_leaf(shard, nb // D, ring // D, N)
              for _ in range(D)]
    gathers = []
    for ids, losses in _stream(replace=False):
        st.update(leaf, torch.from_numpy(ids), torch.from_numpy(losses),
                  B1, B2)
        jids, jl = jnp.asarray(ids), jnp.asarray(losses)
        blocks = [jscores._q_update_local(b, jids - d * shard, jids, jl, B1,
                                          B2, blk, False, None)
                  for d, b in enumerate(blocks)]
        want = []
        for f_q, f_sc, f_err in (("s_q", "s_scale", "err_s"),
                                 ("w_q", "w_scale", "err_w")):
            total = np.zeros(B, np.float32)
            for d, b in enumerate(blocks):
                local = jids - d * shard
                mask = (local >= 0) & (local < shard)
                v = jscores._q_gather_1d(
                    getattr(b, f_q), getattr(b, f_sc), blk, b.err_rows,
                    b.err_seq, getattr(b, f_err),
                    jnp.where(mask, local, 0), jnp.where(mask, jids, -1))
                total = total + np.asarray(jnp.where(mask, v, 0.0))
            want.append(total)
        gathers.append((st.gather(leaf, torch.from_numpy(ids)), want))
    return st, leaf, jax.device_get(blocks), gathers


def test_quant_blocks_match_reference_per_shard_body(quant_run):
    st, leaf, blocks, gathers = quant_run
    for f in dataclasses.fields(tscores.QuantizedScores):
        for d in range(D):
            _eq(getattr(leaf, f.name)[d], getattr(blocks[d], f.name),
                f"{f.name}[{d}]")
    for got, want in gathers:
        for g, w in zip(got, want):
            _eq(g, w)
    assert int((_cat(leaf.err_seq) > 0).sum()) == T * B   # nothing evicted


# the reference's shard_map on one CPU device: vmap over a block axis
class _Mesh:
    def __init__(self, n):
        self.shape = {"data": n}
        self.axis_names = ("data",)


def _vmap_shard_map(body, mesh, in_specs, out_specs, check_rep=False):
    n = mesh.shape["data"]

    def spec(x):
        return isinstance(x, P)

    def run(*args):
        specs = in_specs if isinstance(in_specs, tuple) else (in_specs,)
        axes = tuple(jax.tree.map(lambda s: 0 if len(s) else None, sp,
                                  is_leaf=spec) for sp in specs)
        split = tuple(jax.tree.map(
            lambda s, x: x.reshape((n, -1)) if len(s) else x, sp, a,
            is_leaf=spec) for sp, a in zip(specs, args))
        out = jax.vmap(body, in_axes=axes, axis_name="data",
                       axis_size=n)(*split)
        return jax.tree.map(lambda s, y: y.reshape(-1) if len(s) else y[0],
                            out_specs, out, is_leaf=spec)
    return run


def _jit_exact(fn, *args):
    """``fn(*args)`` under one jit without XLA's algebraic simplifier,
    which would turn the reference's divisions by 127 into products with
    1/127 (one ulp off): the arithmetic of the reference run eagerly, as
    its own tests run it, in one compilation."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)


@pytest.fixture
def ref_wire_store(monkeypatch):
    monkeypatch.setattr(jscores, "shard_map", _vmap_shard_map)
    return jscores.make_store(jscores.ScoreSharding(_Mesh(D), ("data",)),
                              wire=True, **QKW)


def test_wire_gather_matches_reference_compressed_psum(quant_run,
                                                       ref_wire_store):
    """The wire gather is the reference's (its ``compressed_psum_sum``
    over the blocks' contributions) bitwise, within one grid step of the
    exact gather."""
    st, leaf, blocks, gathers = quant_run
    wired = dataclasses.replace(st, wire=True)
    qs = jscores.QuantizedScores(**{
        f.name: jnp.concatenate([getattr(b, f.name) for b in blocks])
        for f in dataclasses.fields(jscores.QuantizedScores)})
    # every row once, and a few twice
    ids = np.concatenate([np.arange(N), np.arange(0, N, 8)]).astype(np.int32)
    got = wired.gather(leaf, torch.from_numpy(ids))
    want = _jit_exact(ref_wire_store.gather, qs, jnp.asarray(ids))
    exact = st.gather(leaf, torch.from_numpy(ids))
    for g, w, e in zip(got, want, exact):
        _eq(g, w)
        tol = float(e.abs().max()) / 127.0 + 1e-7
        assert float((g - e).abs().max()) <= tol


@pytest.mark.parametrize("k", [6, 3])
def test_select_wire_matches_reference(ref_wire_store, k):
    """``_select_wire``: int8 keys and int16 positions, the reference's
    merge on the same Gumbel draw; every id whose exact key lies more than
    one key-grid step from the k-th is decided as the exact selection
    decides it."""
    wired = tscores.make_store(CPU4, wire=True, **QKW)
    rng = np.random.default_rng(k)
    for trial in range(3):
        w = rng.uniform(0.01, 5.0, 32).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        g = np.asarray(jax.random.gumbel(key, (32,), jnp.float32))
        got = wired.select(torch.from_numpy(w), k,
                           gumbel=torch.from_numpy(g))
        _eq(got, jax.jit(ref_wire_store.select, static_argnums=2)(
            key, jnp.asarray(w), k))
        keys = np.log(np.maximum(w, 1e-20)) + g
        kth = np.sort(keys)[::-1][k - 1]
        step = max((np.sort(c)[::-1][0] - np.sort(c)[::-1][k - 1]) / 127.0
                   for c in keys.reshape(D, -1))
        sel = set(got.tolist())
        assert {i for i in range(32) if keys[i] > kth + step} <= sel
        assert not {i for i in range(32) if keys[i] < kth - step} & sel


# ---------------------------------------------------------------------------
# host collectives
# ---------------------------------------------------------------------------

def _collectives(comm, p, block=None):
    """The port's comm takes its wire block from ``WIRE_BLOCK``; the
    reference's from ``block``."""
    rng = np.random.default_rng(p)
    x = rng.standard_normal(300).astype(np.float32) * (10.0 ** p)
    kw = {} if block is None else {"block": block}
    return {"gather": comm.allgather(np.arange(3 + p, dtype=np.int16)),
            "sum64": comm.allreduce_sum(rng.standard_normal(7)),
            "max": comm.allreduce_max(rng.integers(0, 9, (2, 3))),
            "comp": comm.allreduce_sum_compressed(x, **kw)}


@pytest.mark.parametrize("block", [256, 16])
def test_hostcomm_matches_reference_hostcomm(monkeypatch, block):
    monkeypatch.setattr(thostcomm, "WIRE_BLOCK", block)
    store = torch.distributed.HashStore()
    kv = MemoryKV(2)
    got = in_threads(lambda p: _collectives(thostcomm.HostComm(store, p, 2),
                                          p))
    want = in_threads(lambda p: _collectives(jhostcomm.HostComm(kv, p, 2), p,
                                             block))
    for g, w in zip(got, want):
        for k in w:
            if k == "gather":
                for a, b in zip(g[k], w[k]):
                    assert a.dtype == b.dtype == np.int16
                    _eq(a, b)
            else:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                _eq(g[k], w[k], k)
    assert got[0]["sum64"].dtype == np.float64
    in_threads(lambda p: thostcomm.HostComm(store, p, 2).barrier("x"))
    assert store.num_keys() == 0          # every key deleted after use
    assert thostcomm.get_comm() is None   # no process group here


# ---------------------------------------------------------------------------
# the trainer and the elastic restore
# ---------------------------------------------------------------------------

KW = dict(arch="qwen1.5-0.5b", method="eswp", epochs=2, meta_batch=16,
          minibatch=16, n_samples=64, seq_len=32, anneal_ratio=0.0,
          lr=3e-3, device="cpu", quant_block=8)


@pytest.fixture
def four_blocks(monkeypatch):
    monkeypatch.setattr(tsharding, "local_devices",
                        lambda device: [torch.device("cpu")] * D)


def _train(**kw):
    tr = ttrain.Trainer(ttrain.TrainerConfig(**{**KW, **kw}))
    try:
        return tr, tr.train()
    finally:
        tr.preempt.uninstall()


def _final(tr):
    """The store's rows (int8: codes, scales and every row's gather; its
    ring is laid out by block), as one tensor a field."""
    st = tr.store
    out = {k: v.clone() for k, v in st.leaf_state(tr.state.scores).items()
           if not k.startswith("err_")}
    if isinstance(st, tscores.QuantizedStore):
        exact = dataclasses.replace(st, wire=False)
        out["s"], out["w"] = exact.gather(tr.state.scores,
                                          torch.arange(KW["n_samples"]))
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_trainer_shard_scores_matches_replicated(four_blocks, tmp_path,
                                                 quant):
    """--shard-scores over 4 blocks (int8: with --quant-wire): sharded
    summary, losses, kept-sets and final store bitwise the replicated
    run's; killed after 3 steps and resumed, bitwise the straight run."""
    q = dict(quant_scores=quant, quant_wire=quant)
    tr_s, out_s = _train(shard_scores=True, **q)
    tr_r, out_r = _train(quant_scores=quant)
    assert out_s["score_store_sharded"] and not out_r["score_store_sharded"]
    assert isinstance(getattr(tr_s.store, "inner", tr_s.store),
                      tscores.ShardedStore)
    assert out_s["steps"] == out_r["steps"] == 6
    assert [m["loss"] for m in out_s["metrics"]] == \
        [m["loss"] for m in out_r["metrics"]]
    _eq(tr_s.pipeline.sampler.kept, tr_r.pipeline.sampler.kept)
    for k, v in _final(tr_r).items():
        _eq(_final(tr_s)[k], v, k)
    ck = str(tmp_path / "ck")
    _train(shard_scores=True, max_steps=3, ckpt_dir=ck, **q)
    tr_b, out_b = _train(shard_scores=True, ckpt_dir=ck, **q)
    assert [m["loss"] for m in out_b["metrics"]] == \
        [m["loss"] for m in out_s["metrics"]][3:]
    for k, v in _final(tr_s).items():
        _eq(_final(tr_b)[k], v, k)


def test_trainer_one_block_warns_and_stays_replicated():
    with pytest.warns(UserWarning, match="single device, store stays "
                                         "replicated"):
        tr = ttrain.Trainer(ttrain.TrainerConfig(**{**KW, "shard_scores":
                                                    True}))
    tr.preempt.uninstall()
    assert tr.score_sharding is None
    assert isinstance(tr.store, tscores.ReplicatedStore)


def test_trainer_indivisible_store_warns(monkeypatch):
    monkeypatch.setattr(tsharding, "local_devices",
                        lambda device: [torch.device("cpu")] * 3)
    with pytest.warns(UserWarning, match="not divisible by 3 devices"):
        tr = ttrain.Trainer(ttrain.TrainerConfig(**{**KW, "shard_scores":
                                                    True}))
    tr.preempt.uninstall()
    assert tr.score_sharding is None


def test_elastic_restart_restores_onto_the_devices_present(monkeypatch,
                                                           tmp_path):
    """Saved from 4 blocks, restored onto the 2 devices present (and the
    reference test's state, reshaped to its template)."""
    st = tscores.make_store(CPU4)
    leaf = st.init_leaf(N)
    st.update(leaf, torch.arange(16, dtype=torch.int32),
              torch.linspace(0.1, 2.0, 16), B1, B2)
    ck = Checkpointer(tmp_path)
    ck.save({"scores": st.leaf_state(leaf),
             "w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
             "step": torch.tensor(5)}, step=5)
    monkeypatch.setattr(tsharding, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)
    stores = {}

    def make_template(devices):
        stores["st"] = tscores.make_store(
            tsharding.score_store_sharding(devices))
        stores["like"] = stores["st"].init_leaf(N)
        return {"scores": stores["st"].leaf_state(stores["like"]),
                "w": torch.zeros(4, 4), "step": torch.tensor(0)}

    devices, state = elastic_restart(ck, make_template, "cpu")
    assert devices == [torch.device("cpu")] * 2
    got = stores["st"].load_leaf_state(state["scores"], stores["like"])
    assert len(got.s) == 2
    _eq(_cat(got.s), _cat(leaf.s))
    _eq(state["w"], np.arange(16, dtype=np.float32).reshape(4, 4))
    assert int(state["step"]) == 5
