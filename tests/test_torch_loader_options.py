"""The port's loader options and BPTT iterator against the JAX package's.

Both loaders iterate one epoch of the same dataset with ``shuffle``,
``seed`` and ``drop_last`` set alike; the batches they yield (a column of
row ids, so the index streams themselves) must be equal, for a dict of
arrays and for indexable datasets of dicts, tuples and arrays. Two named
loaders of one job checkpoint and restore side by side, and the trailing
partial batch of ``drop_last=False`` steps through the trainer.
``TokenWindowDataset`` and ``AdaptiveBPTTLoader`` yield what the JAX ones
yield.
"""

import numpy as np
import pytest
import torch

from adaptdl_tpu import checkpoint as jcheckpoint
from adaptdl_tpu import collective as jcollective
from adaptdl_tpu import data as jdata
from adaptdl_tpu import epoch as jepoch
from adaptdl_tpu import iterator as jiterator
from adaptdl_tpu import metrics as jmetrics
from adaptdl_tpu_torch import _signal, checkpoint, data, epoch, iterator, metrics
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401



@pytest.fixture(autouse=True)
def _state():
    def reset():
        checkpoint._reset_registry()
        metrics._reset_state()
        epoch._reset_state()
        jmetrics._reset_state()
        jepoch._reset_state()
        jcheckpoint._reset_registry()
        # An iterated JAX loader leaves a one-process reducer behind,
        # which processes forked by later tests would inherit.
        jcollective.teardown()
        _signal.set_exit_flag(False)

    reset()
    yield
    reset()


def _epoch(loader):
    return list(loader)


def _rows(batches, key="id"):
    return [np.asarray(b[key] if isinstance(b, dict) else b[0]).tolist() for b in batches]


class _Samples:
    """An indexable dataset whose samples are ``kind``: dicts, tuples or
    bare arrays, each carrying its row id."""

    def __init__(self, n, kind):
        self.n, self.kind = n, kind

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        row = np.array([i, 2 * i], np.int64)
        if self.kind == "dict":
            return {"id": np.int64(i), "x": row}
        if self.kind == "tuple":
            return (np.int64(i), row)
        return row


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_index_streams_match_jax(shuffle, drop_last, seed):
    dataset = {"id": np.arange(100), "x": np.arange(200).reshape(100, 2)}
    kw = dict(batch_size=32, shuffle=shuffle, drop_last=drop_last, seed=seed)
    got = _epoch(data.AdaptiveDataLoader(dataset, **kw))
    want = _epoch(jdata.AdaptiveDataLoader(dataset, **kw))
    assert _rows(got) == _rows(want)
    assert [len(b["id"]) for b in got] == ([32] * 3 if drop_last else [32] * 3 + [4])
    if not shuffle:
        assert sum(_rows(got), []) == list(range(len(sum(_rows(got), []))))


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
def test_indexable_datasets_match_jax(kind):
    kw = dict(batch_size=16, drop_last=False, seed=3)
    got = _epoch(data.AdaptiveDataLoader(_Samples(40, kind), **kw))
    want = _epoch(jdata.AdaptiveDataLoader(_Samples(40, kind), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for a, b in zip(*(
            (x.values() if isinstance(x, dict) else x if isinstance(x, tuple) else [x])
            for x in (g, w)
        )):
            np.testing.assert_array_equal(a, b)


def test_the_seed_moves_the_permutation():
    dataset = {"id": np.arange(64)}
    streams = [
        _rows(_epoch(data.AdaptiveDataLoader(dataset, batch_size=16, seed=s, name=f"l{s}")))
        for s in (0, 1)
    ]
    assert streams[0] != streams[1]
    assert sorted(sum(streams[0], [])) == sorted(sum(streams[1], [])) == list(range(64))


def test_two_named_loaders_restore_side_by_side(tmp_path, monkeypatch):
    """A train loader stopped mid-epoch and an eval loader that finished
    its loop checkpoint under their own names; fresh loaders of a
    restarted job resume each where it was."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    train_data = {"id": np.arange(96)}
    eval_data = {"id": np.arange(40)}
    train = data.AdaptiveDataLoader(train_data, batch_size=16)
    evaluate = data.AdaptiveDataLoader(
        eval_data, batch_size=16, shuffle=False, drop_last=False, name="eval-loader"
    )
    with pytest.raises(ValueError, match="duplicate"):
        data.AdaptiveDataLoader(eval_data, batch_size=16, name="eval-loader")
    assert _rows(_epoch(evaluate)) == [list(range(16)), list(range(16, 32)), list(range(32, 40))]
    seen = []
    for batch in train:
        seen.append(batch["id"].tolist())
        if len(seen) == 2:
            break
    checkpoint.save_all_states()
    rest = _rows(list(train))  # what the uninterrupted loop yields next
    checkpoint._reset_registry()

    train2 = data.AdaptiveDataLoader(train_data, batch_size=16)
    evaluate2 = data.AdaptiveDataLoader(
        eval_data, batch_size=16, shuffle=False, drop_last=False, name="eval-loader"
    )
    # The second batch's step never completed: it is fed again.
    assert train2.sampler.index == 16 and evaluate2.sampler.index == 0
    assert evaluate2._loops_finished == {0: 1}
    assert _rows(list(train2)) == rest
    assert list(evaluate2) == []  # its loop of this epoch finished before


def test_partial_batch_steps_through_the_trainer(tmp_path, monkeypatch):
    """drop_last=False: 40 rows at batch 16 yield 16, 16 and 8; the last
    steps as one microbatch of 8 rows and profiles nothing."""
    from adaptdl_tpu_torch.optim import SGD
    from adaptdl_tpu_torch.scaling_rules import AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    rng = np.random.default_rng(0)
    dataset = {"x": rng.normal(size=(40, 3)).astype(np.float32)}
    dataset["y"] = dataset["x"] @ np.array([1.0, -2.0, 0.5], np.float32)
    model = torch.nn.Linear(3, 1, bias=False)

    def loss_fn(m, batch, generator=None):
        return torch.mean((m(batch["x"])[:, 0] - batch["y"]) ** 2)

    trainer = ElasticTrainer(
        loss_fn, model, SGD(model.parameters(), lr=0.1), 16,
        scaling_rule=AdaScale(), device="cpu",
    )
    loader = data.AdaptiveDataLoader(dataset, batch_size=16, drop_last=False)
    loader.autoscale_batch_size(32, local_bsz_bounds=(8, 16), gradient_accumulation=True)
    state = trainer.init_state()
    sizes = []
    for batch in loader:
        state, m = trainer.run_step(state, batch, loader)
        sizes.append((len(batch["x"]), float(m["scale"])))
        assert np.isfinite(float(m["loss"]))
    assert sizes == [(16, 1.0), (16, 1.0), (8, 0.5)]
    assert trainer._calibrated == {16}
    assert int(state.step) == 3


def test_token_windows_match_jax():
    tokens = np.random.default_rng(0).integers(0, 50, 1000)
    got, want = iterator.TokenWindowDataset(tokens, 32), jiterator.TokenWindowDataset(tokens, 32)
    assert len(got) == len(want) == 31
    for i in (0, 5, 30):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(got[i][key], want[i][key])
            assert got[i][key].dtype == np.int32
    with pytest.raises(ValueError, match="flat"):
        iterator.TokenWindowDataset(tokens.reshape(10, 100), 8)


@pytest.mark.parametrize("shuffle", [True, False])
def test_bptt_loader_matches_jax(shuffle):
    tokens = np.random.default_rng(1).integers(0, 50, 2000)
    got = _epoch(iterator.AdaptiveBPTTLoader(tokens, 8, 16, shuffle=shuffle, seed=2))
    want = _epoch(jiterator.AdaptiveBPTTLoader(tokens, 8, 16, shuffle=shuffle, seed=2))
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(g[key], w[key])
            assert g[key].shape == (8, 16)


def test_a_second_loader_leaves_the_job_sized_by_the_first():
    """An evaluation loader made after the training loader keeps the
    training loader's batch-size configuration (the one the goodput model
    is relative to) and adds nothing to the step profile. The JAX loader
    replaces the configuration with its own batch size, so a restarted
    tutorial step 5 evaluates the training batch below it and fails
    goodput's assertion."""
    dataset = {"id": np.arange(64)}
    for package, metrics_mod in ((data, metrics), (jdata, jmetrics)):
        train = package.AdaptiveDataLoader(dataset, batch_size=16)
        train.autoscale_batch_size(64, local_bsz_bounds=(8, 32), gradient_accumulation=True)
        package.AdaptiveDataLoader(dataset, batch_size=32, shuffle=False, name="eval-loader")
        sized = metrics_mod._state.init_batch_size
        assert sized == (16 if package is data else 32)
    # The port's eval loader profiles no step; the training loader does.
    evaluate = checkpoint.registered_states()
    evaluate = [s._loader for s in evaluate if s.name == "eval-loader"][0]
    for _ in range(3):
        _epoch(evaluate)
    assert not metrics._state.profile
    train = [s._loader for s in checkpoint.registered_states()
             if s.name == "adaptdl_dataloader"][0]
    for _ in range(3):
        _epoch(train)
    assert metrics._state.profile
