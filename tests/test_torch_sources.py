"""PyTorch port: the file sources, the growing stream and multi-host
slicing against the JAX package.

* every source kind's batches equal JAX's bitwise: a token file and a
  glob of shards written into ``tmp_path`` (uint16), an SFT JSONL file
  and the synthetic SFT set, the packed and synthetic sources through
  ``get_source``, and a ``StreamingSource`` that stitches base and
  appended rows, with its checkpoint extras;
* the sampler's ids (``epoch_id_stream``, ``batch_ids``, ``host_slice``)
  with ``num_hosts`` 1, 2 and 4, across a grow and a kept-set installed
  before it (drop_last on and off), equal JAX's, and so do the cursors;
* ``DataPipeline`` streams a host's slice and its ``grow`` refuses rows
  the source has not appended;
* a cursor of another seed, meta-batch, host count or ``drop_last``
  raises on ``load_state``, and a matching one restores the growth;
* the trainer runs ``--source tokens|sharded|sft`` with ``--num-hosts
  2 --host-id 1``: its batches' sample ids are host 1's half of the
  sampler's global meta-batches.
"""
import json

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.data.pipeline import StreamingSource as JaxStreaming
from repro.data.pipeline import get_source as jax_get_source
from repro.data.pipeline.sampler import ESSampler as JaxSampler
from repro_torch.data.pipeline import (DataPipeline, HostPlacer,
                                       StreamingSource, get_source,
                                       write_token_bin)
from repro_torch.data.sampler import ESSampler
from repro_torch.launch import train as ttrain

S = 16


@pytest.fixture
def files(tmp_path):
    """Token files (the smoke vocabulary's, and one over the uint16
    range), three shards (one too short for a window) and a JSONL of
    prompt/response pairs."""
    rng = np.random.default_rng(0)
    write_token_bin(tmp_path / "corpus.bin",
                    rng.integers(0, 256, 40 * S + 5))
    write_token_bin(tmp_path / "wide.bin",
                    rng.integers(0, 1 << 16, 40 * S + 5))
    for i, n in enumerate((7 * S + 3, S - 2, 11 * S + 1)):
        write_token_bin(tmp_path / "shards" / f"s{i}.bin",
                        rng.integers(0, 64, n))
    with open(tmp_path / "sft.jsonl", "w") as f:
        for i in range(24):
            p = rng.integers(1, 64, rng.integers(1, 12)).tolist()
            r = rng.integers(1, 64, rng.integers(0, 14)).tolist()
            f.write(json.dumps({"prompt": p, "response": r}) + "\n")
            if i % 7 == 0:
                f.write("\n")
    return tmp_path


def _kinds(d):
    return {"tokens": dict(path=str(d / "corpus.bin")),
            "tokens-wide": dict(path=str(d / "wide.bin")),
            "sharded": dict(path=str(d / "shards" / "*.bin")),
            "sft": dict(path=str(d / "sft.jsonl")),
            "sft-synthetic": dict(n_samples=40),
            "synthetic": dict(n_samples=40),
            "packed": dict(n_samples=60, max_segments=3)}


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["tokens", "tokens-wide", "sharded", "sft",
                                  "sft-synthetic", "synthetic", "packed"])
def test_source_batches_match_jax(files, kind):
    kw = dict(seq_len=S, vocab_size=64, seed=3, **_kinds(files)[kind])
    name = kind.split("-")[0]
    ts, js = get_source(name, **kw), jax_get_source(name, **kw)
    assert type(ts).__name__ == type(js).__name__
    assert len(ts) == len(js) > 8
    rng = np.random.default_rng(1)
    for ids in (np.arange(len(js)), rng.permutation(len(js))[:9],
                np.asarray([len(js) - 1, 0, len(js) - 1])):
        _same_batch(ts.batch(ids), js.batch(ids))
    if name == "sharded":      # the too-short shard holds no window
        assert len(ts) == 7 + 11


def test_file_sources_refuse_bad_input(tmp_path):
    write_token_bin(tmp_path / "short.bin", np.arange(S))
    for kind, path in (("tokens", tmp_path / "short.bin"),
                       ("sharded", tmp_path / "none*.bin"),
                       ("tokens", None), ("sharded", None)):
        with pytest.raises(ValueError):
            get_source(kind, path=None if path is None else str(path),
                       seq_len=S)
    with pytest.raises(ValueError):
        get_source("parquet", seq_len=S)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 64, (n, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((n, 1), -1, np.int32)],
                            axis=1)
    return tokens, labels


def test_streaming_source_matches_jax(files):
    kw = dict(path=str(files / "corpus.bin"), seq_len=S)
    ts = StreamingSource(get_source("tokens", **kw))
    js = JaxStreaming(jax_get_source("tokens", **kw))
    assert ts.stream_state_arrays() == js.stream_state_arrays() == {}
    n0 = len(js)
    for seed in (5, 6):
        tok, lab = _rows(3, seed)
        np.testing.assert_array_equal(ts.append(tok, lab),
                                      js.append(tok, lab))
    assert len(ts) == len(js) == n0 + 6 and ts.n_streamed == 6
    for ids in (np.arange(4), np.asarray([n0 + 4, 2, n0, n0 - 1, n0 + 5]),
                np.arange(n0, n0 + 6)):
        _same_batch(ts.batch(ids), js.batch(ids))
    with pytest.raises(ValueError, match="append"):
        ts.append(np.zeros((2, S - 1), np.int32),
                  np.zeros((2, S - 1), np.int32))
    extras = ts.stream_state_arrays()
    _same_batch(extras, js.stream_state_arrays())
    again = StreamingSource(get_source("tokens", **kw))
    again.load_stream_state(extras)
    _same_batch(again.batch(np.arange(n0 - 2, n0 + 6)),
                js.batch(np.arange(n0 - 2, n0 + 6)))


def _drive(s, steps):
    """Every step's host ids of epochs 0-2, with a kept-set installed
    before epoch 0, a grow during epoch 0 and another during epoch 1."""
    out = []
    s.apply_pruning(np.arange(0, 40, 3))
    for epoch in range(3):
        out.append([(b, ids.copy()) for b, ids in
                    s.epoch_id_stream(epoch)])
        out.append([s.host_slice(s.batch_ids(epoch, b)) for b in steps])
        out.append((s.steps_per_epoch(epoch), s.population(epoch),
                    s.cursor(epoch, 1)))
        if epoch < 2:
            s.grow(5 + 6 * epoch, epoch)
    out.append(s.grad_scale_for(np.asarray([0, 39, 50])))
    return out


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_sampler_hosts_and_growth_match_jax(num_hosts, drop_last):
    for host_id in range(num_hosts):
        kw = dict(seed=7, host_id=host_id, num_hosts=num_hosts,
                  drop_last=drop_last)
        got = _drive(ESSampler(40, 8, **kw), (0, 1))
        want = _drive(JaxSampler(40, 8, **kw), (0, 1))
        assert len(got) == len(want)
        for g, w in zip(got[:-1], want[:-1]):
            if isinstance(w, tuple):
                assert g == w
                continue
            assert len(g) == len(w)
            for a, b in zip(g, w):
                if isinstance(b, tuple):
                    assert a[0] == b[0]
                    a, b = a[1], b[1]
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[-1], want[-1])
    # the hosts' slices stitch back into the global batch, in order
    ts = [ESSampler(40, 8, seed=7, host_id=h, num_hosts=num_hosts)
          for h in range(num_hosts)]
    np.testing.assert_array_equal(
        np.concatenate([t.host_slice(t.batch_ids(0, 2)) for t in ts]),
        ts[0].batch_ids(0, 2))


def test_sampler_cursor_mismatch_raises_and_growth_restores():
    ref = ESSampler(16, 8, seed=0)
    ref.grow(8, epoch=0)
    ref.apply_pruning(np.arange(0, 24, 2))
    ref.grow(4, epoch=1)
    cur = ref.cursor(1, 0)
    jref = JaxSampler(16, 8, seed=0)
    jref.grow(8, epoch=0)
    jref.apply_pruning(np.arange(0, 24, 2))
    jref.grow(4, epoch=1)
    assert cur == jref.cursor(1, 0)
    assert cur["growth"] == [[1, 24], [2, 28]] and cur["kept_pop"] == 24
    for s, msg in ((ESSampler(16, 8, seed=1), "seed"),
                   (ESSampler(16, 4, seed=0), "meta_batch"),
                   (ESSampler(16, 8, seed=0, num_hosts=2), "num_hosts"),
                   (ESSampler(16, 8, seed=0, drop_last=False),
                    "drop_last")):
        with pytest.raises(ValueError, match=msg):
            s.load_state(ref.state_arrays(), cur)
    ok = ESSampler(16, 8, seed=0)
    ok.load_state(ref.state_arrays(), cur)
    assert ok.cursor(1, 0) == cur
    for e in range(3):
        np.testing.assert_array_equal(ok.epoch_indices(e),
                                      jref.epoch_indices(e))
    with pytest.raises(ValueError):
        ESSampler(16, 8, host_id=2, num_hosts=2)
    with pytest.raises(ValueError):
        ESSampler(16, 6, num_hosts=4)
    with pytest.raises(ValueError):
        ok.grow(0, epoch=0)


def test_pipeline_host_slice_and_grow_match_jax(files):
    kw = dict(path=str(files / "corpus.bin"), seq_len=S)
    js = JaxStreaming(jax_get_source("tokens", **kw))
    ts = StreamingSource(get_source("tokens", **kw))
    jp = JaxPipeline(js, 8, seed=2, host_id=1, num_hosts=2, prefetch=False,
                     place=lambda b: b)
    tp = DataPipeline(ts, 8, seed=2, host_id=1, num_hosts=2,
                      prefetch=True, place=HostPlacer())
    with pytest.raises(ValueError, match="append"):
        tp.grow(3, epoch=0)
    tok, lab = _rows(3, 9)
    for src, p in ((ts, tp), (js, jp)):
        src.append(tok, lab)
        p.grow(3, epoch=0)
    assert tp.steps_per_epoch(1) == jp.steps_per_epoch(1)
    for epoch in range(2):
        with tp.epoch(epoch) as stream:
            got = list(stream)
        want = list(jp.epoch(epoch))
        assert len(got) == len(want) == jp.steps_per_epoch(epoch)
        for g, w in zip(got, want):
            assert len(w["sample_ids"]) == 4
            _same_batch({k: v.numpy() for k, v in g.items()}, w)
        _same_batch(tp.batch_at(epoch, 1), jp.batch_at(epoch, 1))
    assert tp.cursor(1, 0) == jp.cursor(1, 0)
    _same_batch(tp.state_arrays(), jp.state_arrays())


@pytest.mark.parametrize("kind", ["tokens", "sharded", "sft"])
def test_trainer_takes_a_host_slice_of_a_file_source(files, kind):
    """``--num-hosts 2 --host-id 1``: each step's sample ids are the
    second half of the sampler's global meta-batch."""
    path = _kinds(files)[kind]["path"]
    argv = ["--arch", "qwen1.5-0.5b", "--method", "es", "--meta-batch",
            "8", "--minibatch", "2", "--seq-len", str(S), "--max-steps",
            "2", "--device", "cpu", "--source", kind, "--data-path", path,
            "--num-hosts", "2", "--host-id", "1", "--epochs", "1"]
    ns = ttrain.build_parser().parse_args(argv)
    fields = set(ttrain.TrainerConfig.__dataclass_fields__)
    tr = ttrain.Trainer(ttrain.TrainerConfig(
        **{k: v for k, v in vars(ns).items() if k in fields}))
    assert (tr.host_id, tr.num_hosts) == (1, 2)
    seen = []
    inner = tr.engine.session

    def session(*a, **k):
        sess = inner(*a, **k)
        step = sess.step

        def spy(state, batch):
            seen.append(batch["sample_ids"].numpy().copy())
            return step(state, batch)
        sess.step = spy
        return sess
    tr.engine.session = session
    out = tr.train()
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    for b, ids in enumerate(seen):
        np.testing.assert_array_equal(ids, tr.sampler.batch_ids(0, b)[4:])
