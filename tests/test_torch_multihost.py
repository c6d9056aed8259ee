"""PyTorch port: the per-process score store on a 2-process CPU cluster
(``torch.distributed`` gloo group, ``HostComm`` over its store) against
the JAX package's one-process replicated store (the contracts of
``tests/test_multihost.py:142-420``).

Two fresh interpreters each own 32 of 64 rows in two row blocks
(``ScoreSharding(n_global=64, offset=rank * 32)``) and run the
reference's seeded workload (``_WORKLOAD``, ``_QUANT_WORKLOAD``); the
parent computes the reference's results with JAX meanwhile and holds every
child's to them bitwise:

* each process's rows are the reference's row range; every gather, the
  selection on the reference's Gumbel draw, and the kept-set,
  ``grad_scale`` and s-snapshot of all five prune methods;
* a grow of the store: each process's new range;
* the int8 store (block 8, a ring of 1,024): codes, scales, gathers and
  the assembled prune losses; the wire gather within one grid step;
* the partitioned checkpoint (blocks ``scores/<leaf>#<offset>``, one
  file a process, the union manifest) restores back into the cluster and
  on one process onto a replicated and a 4-block template; a one-process
  checkpoint restores into the cluster; the int8 checkpoint restores onto
  a replicated int8 store;
* ``allreduce_sum_compressed`` bitwise the reference ``HostComm``'s
  arithmetic on the same inputs (two threads over an in-memory client),
  and an f64 ``allreduce_sum`` stays f64.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import MemoryKV, in_threads
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.core import pruning as jpruning
from repro.core import scores as jscores
from repro.core.selection import gumbel_topk_select
from repro.distributed.hostcomm import HostComm as JaxHostComm
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import scores as tscores

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, B, T, HALF = 64, 16, 5, 32
METHODS = ("eswp", "infobatch", "ucb", "ka", "random")
QKW = dict(quantize=True, block=8, residual_rows=1024)

_CHILD = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, "src")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import scores as ts
    from repro_torch.distributed.hostcomm import get_comm

    torch.set_num_threads(1)
    pid, out = int(os.environ["RANK"]), os.environ["OUT"]
    N, B, T, HALF = 64, 16, 5, 32
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            + os.environ["PORT"], rank=pid, world_size=2)
    comm = get_comm()
    assert comm is not None and comm.process_count == 2
    res = {}

    def stream():
        rng = np.random.default_rng(0)
        for _ in range(T):
            yield (torch.from_numpy(rng.choice(N, B, replace=False)
                                    .astype(np.int32)),
                   torch.from_numpy(rng.uniform(0.1, 3.0, B)
                                    .astype(np.float32)))

    def rows():
        return ts.ScoreSharding(["cpu", "cpu"], n_global=N,
                                offset=pid * HALF)

    st = ts.make_store(rows())
    st.validate(N)
    leaf = st.init_leaf(N)
    for t, (ids, losses) in enumerate(stream()):
        res[f"gs{t}"], res[f"gw{t}"] = st.gather(leaf, ids)
        st.update(leaf, ids, losses, 0.2, 0.9)
    wsel = st.gather(leaf, torch.arange(B, dtype=torch.int32))[1]
    res["sel"] = st.select(wsel, 6, gumbel=torch.from_numpy(
        np.load(os.path.join(out, "gumbel.npy"))))
    prev = np.random.default_rng(1).uniform(0.05, 3.0, N).astype(np.float32)
    for m in ("eswp", "infobatch", "ucb", "ka", "random"):
        r, full = st.prune_epoch(m, np.random.default_rng(3), leaf,
                                 prev_losses=prev, ratio=0.25)
        res[f"kept_{m}"], res[f"full_{m}"] = np.sort(r.kept), full
        if r.grad_scale is not None:
            res[f"scale_{m}"] = r.grad_scale
    for f in ("s", "w", "seen"):
        res[f] = torch.cat(getattr(leaf, f))

    part = st.checkpoint_partition()
    assert part["n_global"] == N and st.checkpoint_spec()[
        "process_count"] == 2
    ck = Checkpointer(os.path.join(out, "ck"))
    ck.save({"scores": st.leaf_state(leaf)}, step=7, partition=part)
    back = ck.restore({"scores": st.leaf_state(st.init_leaf(N))}, step=7,
                      partition=part)["scores"]
    assert torch.equal(back["s"], res["s"]), "restore into the cluster"
    one = Checkpointer(os.path.join(out, "ck1")).restore(
        {"scores": st.leaf_state(st.init_leaf(N))}, step=1,
        partition=part)["scores"]
    res["from_one_s"], res["from_one_seen"] = one["s"], one["seen"]

    st2, leaf2 = st.grow(leaf, N)
    assert st2.sharding.n_global == 2 * N and st2.sharding.offset == pid * N
    res["grown_s"] = torch.cat(leaf2.s)

    q = ts.make_store(rows(), quantize=True, block=8, residual_rows=1024)
    q.validate(N)
    qs = q.init_leaf(N)
    for t, (ids, losses) in enumerate(stream()):
        q.update(qs, ids, losses, 0.2, 0.9)
        res[f"qgs{t}"], res[f"qgw{t}"] = q.gather(qs, ids)
    for f in ("s_q", "w_q", "seen_q", "s_scale", "w_scale"):
        res[f"q_{f}"] = torch.cat(getattr(qs, f))
    res["q_full"] = q.prune_snapshot(qs).full_losses()
    every = torch.arange(N, dtype=torch.int32)
    exact = q.gather(qs, every)[0]
    wired = ts.QuantizedStore(q.inner, block=8, residual_rows=1024,
                              wire=True).gather(qs, every)[0]
    tol = float(exact.abs().max()) / 127.0 + 1e-7
    assert float((wired - exact).abs().max()) <= tol, "wire gather"
    qpart = q.checkpoint_partition()
    assert qpart["per_leaf"] and qpart["rank"] == pid
    Checkpointer(os.path.join(out, "qck")).save(
        {"scores": q.leaf_state(qs)}, step=9, partition=qpart)

    x = np.random.default_rng(10 + pid).standard_normal(300).astype(
        np.float32) * 10.0 ** pid
    res["comp"] = comm.allreduce_sum_compressed(x)
    res["sum64"] = comm.allreduce_sum(
        np.random.default_rng(20 + pid).standard_normal(7))
    np.savez(os.path.join(out, f"rank{pid}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()
    print("OK")
""")


def _stream():
    rng = np.random.default_rng(0)
    for _ in range(T):
        yield (jnp.asarray(rng.choice(N, B, replace=False), jnp.int32),
               jnp.asarray(rng.uniform(0.1, 3.0, B).astype(np.float32)))


def _reference(key):
    """The reference's one-process results of the workload."""
    out = {}
    ref = jscores.init_scores(N)
    for t, (ids, losses) in enumerate(_stream()):
        out[f"gs{t}"], out[f"gw{t}"] = ref.s[ids], ref.w[ids]
        ref = jscores.update_scores(ref, ids, losses, 0.2, 0.9)
    out["sel"] = gumbel_topk_select(key, ref.w[jnp.arange(B)], 6)
    prev = np.random.default_rng(1).uniform(0.05, 3.0, N).astype(np.float32)
    ref = jax.device_get(ref)
    for m in METHODS:
        r = jpruning.prune_epoch(m, np.random.default_rng(3), weights=ref.w,
                                 losses=ref.s, prev_losses=prev,
                                 seen=ref.seen, ratio=0.25)
        out[f"kept_{m}"], out[f"full_{m}"] = np.sort(r.kept), ref.s
        if r.grad_scale is not None:
            out[f"scale_{m}"] = r.grad_scale
    _, grown = jscores.ReplicatedStore().grow(ref, N)
    q = jscores.make_store(None, **QKW)
    qs = q.init_leaf(N)
    for t, (ids, losses) in enumerate(_stream()):
        qs = q.update(qs, ids, losses, 0.2, 0.9)
        out[f"qgs{t}"], out[f"qgw{t}"] = q.gather(qs, ids)
    return ref, jax.device_get(grown), q, qs, out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_store_matches_one_process_reference(tmp_path):
    key = jax.random.PRNGKey(7)
    gumbel = jax.random.gumbel(key, (B,), jnp.float32)
    np.save(tmp_path / "gumbel.npy", np.asarray(gumbel))
    # the one-process checkpoint the cluster restores (the reference's
    # final store, written by the port's checkpointer)
    ref_final = jscores.init_scores(N)
    for ids, losses in _stream():
        ref_final = jscores.update_scores(ref_final, ids, losses, 0.2, 0.9)
    Checkpointer(tmp_path / "ck1").save({"scores": {
        f: torch.from_numpy(np.array(getattr(ref_final, f)))
        for f in ("s", "w", "seen")}}, step=1)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, RANK=str(p), PORT=port, OUT=str(tmp_path),
                 PYTHONPATH=os.path.join(ROOT, "src")))
        for p in range(2)]
    try:
        ref, grown, q, qs, want = _reference(key)
        xs = [np.random.default_rng(10 + p).standard_normal(300).astype(
            np.float32) * 10.0 ** p for p in range(2)]
        kv = MemoryKV(2)
        comp = in_threads(lambda p: JaxHostComm(kv, p, 2)
                          .allreduce_sum_compressed(xs[p]))
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in enumerate(outs):
        assert procs[p].returncode == 0 and "OK" in o, f"rank {p}:\n{o}"
    q_full = q.prune_snapshot(qs).full_losses()
    for p in range(2):
        got = dict(np.load(tmp_path / f"rank{p}.npz"))
        lo, hi = p * HALF, (p + 1) * HALF
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        for f in ("s", "w", "seen"):
            np.testing.assert_array_equal(got[f], getattr(ref, f)[lo:hi])
        np.testing.assert_array_equal(got["from_one_s"], ref.s[lo:hi])
        np.testing.assert_array_equal(got["from_one_seen"], ref.seen[lo:hi])
        np.testing.assert_array_equal(got["grown_s"],
                                      grown.s[2 * lo:2 * hi])
        for f in ("s_q", "w_q", "seen_q"):
            np.testing.assert_array_equal(
                got[f"q_{f}"], np.asarray(getattr(qs, f))[lo:hi])
        for f in ("s_scale", "w_scale"):
            np.testing.assert_array_equal(
                got[f"q_{f}"], np.asarray(getattr(qs, f))[lo // 8:hi // 8])
        np.testing.assert_array_equal(got["q_full"], q_full)
        np.testing.assert_array_equal(got["comp"], comp[p])
        assert got["sum64"].dtype == np.float64
        np.testing.assert_array_equal(got["comp"], comp[0])

    # the 2-process checkpoint on one process: replicated and 4 blocks
    ck = Checkpointer(tmp_path / "ck")
    md = ck.manifest(7)["metadata"]
    assert md["process_count"] == 2 and md["partitioned"]["n_global"] == N
    assert any("#" in k for k in ck.manifest(7)["leaves"])
    for store in (tscores.make_store(None),
                  tscores.make_store(tscores.ScoreSharding(["cpu"] * 4))):
        like = store.init_leaf(N, "cpu")
        got = store.load_leaf_state(ck.restore(
            {"scores": store.leaf_state(like)}, step=7)["scores"], like)
        for f in ("s", "w", "seen"):
            leaf = getattr(got, f)
            full = torch.cat(leaf) if isinstance(leaf, list) else leaf
            np.testing.assert_array_equal(full.numpy(), getattr(ref, f))
    rq = tscores.make_store(None, **QKW)
    like = rq.init_leaf(N, "cpu")
    got = rq.load_leaf_state(Checkpointer(tmp_path / "qck").restore(
        {"scores": rq.leaf_state(like)}, step=9)["scores"], like)
    for f in ("s_q", "w_q", "seen_q", "s_scale", "w_scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(qs, f)), err_msg=f)
    # every live residual rode along in the ring blocks
    np.testing.assert_array_equal(rq.prune_snapshot(got).full_losses(),
                                  q_full)
    every = np.arange(N, dtype=np.int32)
    for g, w in zip(rq.gather(got, torch.from_numpy(every)),
                    q.gather(qs, jnp.asarray(every))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
