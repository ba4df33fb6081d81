"""paddle_tpu_torch's io, metric and hapi against paddle_tpu's.

- the samplers, `BatchSampler`, `DistributedBatchSampler`, the datasets,
  `random_split`, `default_collate_fn` and the `DataLoader`'s batches
  after `np.random.seed` (both draw from numpy's global RNG): equal;
- `Accuracy` (top-1 and top-3), `Precision`, `Recall`, `Auc` and
  `accuracy` on the same scores: equal (float32 sums);
- the order of the callbacks' calls through `fit` with `eval_data`;
- LeNet (no BatchNorm) through `Model`: `fit` (per-step losses, with
  `accumulate_grad_batches=2` too), `evaluate`, `predict`,
  `train_batch`, `eval_batch`, `save` + `load` against the reference's
  `Model` on the same weights and batches, losses within 1e-4 relative
  and metrics equal; `summary` and `flops` equal;
- the options that are not ported raise NotImplementedError naming
  their queue item.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.vision.models as ref_zoo
from paddle_tpu import io as ref_io
from paddle_tpu import metric as ref_metric
from paddle_tpu.hapi import callbacks as ref_cb
from paddle_tpu.hapi.model import Model as RefModel
import paddle_tpu_torch as port
import paddle_tpu_torch.vision.models as port_zoo
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import metric as port_metric
from paddle_tpu_torch.hapi import callbacks as port_cb
from paddle_tpu_torch.models import load_paddle_tpu_state
from test_torch_vision_models import numpy_init

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else x


def _draw(fn, seed=5):
    np.random.seed(seed)
    return fn()


# -- samplers and datasets -------------------------------------------------

class Squares:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2,), i, np.float32), i * i)


SAMPLERS = {
    "SequenceSampler": lambda io: list(io.SequenceSampler(Squares(7))),
    "RandomSampler": lambda io: list(io.RandomSampler(Squares(9))),
    "RandomSampler replacement": lambda io: list(io.RandomSampler(
        Squares(9), replacement=True, num_samples=12)),
    "WeightedRandomSampler": lambda io: list(io.WeightedRandomSampler(
        [0.1, 0.5, 2.0, 1.0], 10)),
    "BatchSampler shuffle": lambda io: list(io.BatchSampler(
        Squares(10), shuffle=True, batch_size=3)),
    "BatchSampler drop_last": lambda io: list(io.BatchSampler(
        Squares(10), batch_size=3, drop_last=True)),
    "DistributedBatchSampler": lambda io: _distributed(io),
    "random_split": lambda io: [list(s.indices) for s in io.random_split(
        Squares(10), [3, 7])],
    "ConcatDataset": lambda io: [io.ConcatDataset([Squares(3), Squares(4)])[
        i][1] for i in (0, 2, 3, 6, -1)],
    "Subset": lambda io: [io.Subset(Squares(9), [8, 1, 4])[i][1]
                          for i in range(3)],
    "ComposeDataset": lambda io: [v if np.isscalar(v) else v.tolist()
                                  for v in io.ComposeDataset(
                                      [Squares(3), Squares(3)])[2]],
    "ChainDataset": lambda io: [v for v in io.ChainDataset(
        [range(3), range(2)])],
    "TensorDataset": lambda io: [float(v) for v in io.TensorDataset(
        [np.arange(4.0), np.arange(4.0) * 2])[3]],
}


def _distributed(io):
    s = io.DistributedBatchSampler(Squares(10), 2, num_replicas=3, rank=1,
                                   shuffle=True)
    s.set_epoch(2)
    return list(s), len(s)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_and_dataset_match_reference(name):
    want = _draw(lambda: SAMPLERS[name](ref_io))
    got = _draw(lambda: SAMPLERS[name](port_io))
    assert got == want


def test_distributed_batch_sampler_defaults_to_one_process():
    s = port_io.DistributedBatchSampler(Squares(5), 2)
    assert (s.local_rank, s.nranks) == (0, 1)
    assert list(s) == [[0, 1], [2, 3], [4]]


def test_default_collate_fn_matches_reference():
    batch = [{"x": np.ones((2, 3), np.float32) * i, "id": i,
              "w": float(i) / 2, "tag": f"s{i}",
              "pair": (np.int64(i), np.full(2, i, np.int32))}
             for i in range(3)]
    want = _np(ref_io.default_collate_fn(batch))
    got = port_io.default_collate_fn(batch)
    assert isinstance(got["x"], port.Tensor)
    got = _np(got)
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k] if k == "pair" else [got[k]],
                        want[k] if k == "pair" else [want[k]]):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match_reference(shuffle):
    def batches(io):
        loader = io.DataLoader(Squares(11), batch_size=4, shuffle=shuffle)
        return len(loader), [_np(b) for b in loader]
    (n_want, want) = _draw(lambda: batches(ref_io))
    (n_got, got) = _draw(lambda: batches(port_io))
    assert n_got == n_want == 3
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            assert gf.dtype == wf.dtype
            np.testing.assert_array_equal(gf, wf)


class Stream(port_io.IterableDataset):
    def __iter__(self):
        return iter(np.arange(7, dtype=np.int64))


def test_iterable_dataset_batches_in_its_order():
    got = [_np(b).tolist() for b in port_io.DataLoader(
        Stream(), batch_size=3, drop_last=True)]
    assert got == [[0, 1, 2], [3, 4, 5]]
    assert port_io.get_worker_info() is None


def test_batches_land_on_the_current_device():
    (x, y), = list(port_io.DataLoader(Squares(2), batch_size=2))
    assert isinstance(x, port.Tensor) and x.value.device.type == "cpu"
    assert y.dtype == port.int64


# -- metrics ---------------------------------------------------------------

def _scores():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((16, 5)).astype(np.float32),
            rng.integers(0, 5, (16, 1)).astype(np.int64),
            rng.uniform(0, 1, (16, 1)).astype(np.float32),
            rng.integers(0, 2, (16, 1)).astype(np.int64))


METRICS = {
    "Accuracy top-1": lambda m: m.Accuracy(),
    "Accuracy top-1, top-3": lambda m: m.Accuracy(topk=(1, 3)),
    "Precision": lambda m: m.Precision(),
    "Recall": lambda m: m.Recall(),
    "Auc": lambda m: m.Auc(num_thresholds=63),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_reference(name):
    logits, labels, probs, binary = _scores()
    out = {}
    for pkg, mod in ((ref, ref_metric), (port, port_metric)):
        m = METRICS[name](mod)
        steps = []
        for half in (slice(0, 8), slice(8, 16)):
            if name.startswith("Accuracy"):
                res = m.compute(pkg.to_tensor(logits[half]),
                                pkg.to_tensor(labels[half]))
                steps.append(m.update(res))
            else:
                m.update(pkg.to_tensor(probs[half]),
                         pkg.to_tensor(binary[half]))
        out[pkg] = (steps, m.accumulate(), m.name())
    assert out[port] == out[ref]


def test_accuracy_function_matches_reference():
    logits, labels, _, _ = _scores()
    for k in (1, 2):
        want = _np(ref_metric.accuracy(ref.to_tensor(logits),
                                       ref.to_tensor(labels), k=k))
        got = _np(port_metric.accuracy(port.to_tensor(logits),
                                       port.to_tensor(labels), k=k))
        assert got.dtype == want.dtype and got == want


# -- hapi.Model on LeNet ---------------------------------------------------

class Digits:
    """n seeded 1 x 28 x 28 images and labels (the dataset protocol)."""

    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.rand(n, 1, 28, 28).astype(np.float32)
        self.y = rng.randint(0, 10, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


@pytest.fixture(scope="module")
def lenet_state():
    with numpy_init(seed=7):
        net = ref_zoo.LeNet()
    return {k: _np(v) for k, v in net.state_dict().items()}


class Recorder:
    """Logs every callback call ("on_train_batch_end 2") and the losses
    of the train batches; a mixin over each package's Callback."""

    def init(self):
        self.calls, self.losses = [], []

    def __getattribute__(self, name):
        if name.startswith("on_"):
            calls = object.__getattribute__(self, "calls")
            losses = object.__getattribute__(self, "losses")

            def record(*args):
                calls.append(" ".join([name] + [str(a) for a in args
                                                if isinstance(a, int)]))
                logs = args[-1] if args else None
                if name == "on_train_batch_end" and logs:
                    losses.append(float(logs["loss"][0]))
            return record
        return object.__getattribute__(self, name)


def _model(pkg, state, recorder_base):
    zoo = ref_zoo if pkg is ref else port_zoo
    with numpy_init():
        net = zoo.LeNet()
    if pkg is ref:
        net.set_state_dict(state)
    else:
        load_paddle_tpu_state(net, state)
    model = (RefModel if pkg is ref else port.Model)(net)
    model.prepare(pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                         parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss(),
                  (ref_metric if pkg is ref else port_metric).Accuracy(
                      topk=(1, 2)))
    rec = type("Rec", (Recorder, recorder_base), {})()
    rec.init()
    return model, net, rec


@pytest.fixture(scope="module")
def fits(lenet_state):
    """Each package's LeNet Model after fit(2 epochs, eval each) and
    fit(1 epoch, accumulate_grad_batches=2): (model, net, recorders)."""
    out = {}
    for pkg, io, cb in ((ref, ref_io, ref_cb), (port, port_io, port_cb)):
        model, net, rec = _model(pkg, lenet_state, cb.Callback)
        np.random.seed(11)
        model.fit(io.DataLoader(Digits(24), batch_size=8, shuffle=True),
                  io.DataLoader(Digits(8, seed=1), batch_size=4), epochs=2,
                  verbose=0, callbacks=[rec])
        rec2 = type(rec)()
        rec2.init()
        model.fit(io.DataLoader(Digits(20, seed=2), batch_size=4),
                  epochs=1, verbose=0, accumulate_grad_batches=2,
                  callbacks=[rec2])
        out[pkg] = (model, net, rec, rec2)
    return out


def test_callback_calls_in_the_reference_order(fits):
    assert fits[port][2].calls == fits[ref][2].calls
    assert fits[port][2].calls[:3] == ["on_train_begin", "on_epoch_begin 0",
                                       "on_train_batch_begin 0"]
    assert fits[port][3].calls == fits[ref][3].calls


def test_fit_losses_match_reference(fits):
    np.testing.assert_allclose(fits[port][2].losses, fits[ref][2].losses,
                               rtol=RTOL)
    # 20 samples in batches of 4, two a step: 2 + 2 + 1 updates
    assert len(fits[port][3].losses) == 3
    np.testing.assert_allclose(fits[port][3].losses, fits[ref][3].losses,
                               rtol=RTOL)


def test_evaluate_and_predict_match_reference(fits):
    data = Digits(12, seed=3)
    res = {}
    for pkg, io in ((ref, ref_io), (port, port_io)):
        model = fits[pkg][0]
        ev = model.evaluate(io.DataLoader(data, batch_size=4), verbose=0)
        pred = model.predict(io.DataLoader(data, batch_size=6),
                             stack_outputs=True)
        res[pkg] = (ev, pred)
    (rev, rpred), (pev, ppred) = res[ref], res[port]
    np.testing.assert_allclose(pev["loss"], rev["loss"], rtol=RTOL)
    assert pev["acc"] == rev["acc"]
    np.testing.assert_allclose(ppred[0], rpred[0], rtol=RTOL, atol=1e-5)


def test_train_and_eval_batch_match_reference(lenet_state):
    data = Digits(4, seed=4)
    res = {}
    for pkg, cb in ((ref, ref_cb), (port, port_cb)):
        model, _, _ = _model(pkg, lenet_state, cb.Callback)
        x, y = pkg.to_tensor(data.x), pkg.to_tensor(data.y)
        res[pkg] = (model.train_batch([x], [y]), model.train_batch([x], [y]),
                    model.eval_batch([x], [y]),
                    model.predict_batch([x])[0])
    for got, want in zip(res[port][:2], res[ref][:2]):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    (pl, pm), (rl, rm) = res[port][2], res[ref][2]
    np.testing.assert_allclose(pl, rl, rtol=RTOL)
    assert pm == rm
    np.testing.assert_allclose(res[port][3], res[ref][3], rtol=RTOL,
                               atol=1e-5)


def test_save_and_load_round_trip_and_read_reference_files(fits, tmp_path):
    model, net = fits[port][:2]
    model.save(str(tmp_path / "port"))
    assert os.path.exists(tmp_path / "port.pdparams")
    assert os.path.exists(tmp_path / "port.pdopt")
    fresh, fresh_net, _ = _model(port, {k: _np(v) for k, v in
                                        net.state_dict().items()},
                                 port_cb.Callback)
    with torch.no_grad():
        for p in fresh_net.parameters():
            p.zero_()
    fresh.load(str(tmp_path / "port"))
    for (k, a), b in zip(net.state_dict().items(),
                         fresh_net.state_dict().values()):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=k)
    fits[ref][0].save(str(tmp_path / "ref"))
    fresh.load(str(tmp_path / "ref"), reset_optimizer=True)
    for (k, a), b in zip(fits[ref][1].state_dict().items(),
                         fresh_net.state_dict().values()):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=k)


def test_summary_and_flops_match_reference(capsys):
    with numpy_init():
        rnet = ref_zoo.LeNet()
    pnet = port_zoo.LeNet()
    assert port.summary(pnet, (1, 1, 28, 28)) == \
        ref.summary(rnet, (1, 1, 28, 28))
    out = capsys.readouterr().out
    assert "features.0 (Conv2D)" in out and "[1, 6, 28, 28]" in out
    assert port.flops(pnet, [1, 1, 28, 28]) == \
        ref.flops(rnet, [1, 1, 28, 28])
    assert port.Model(pnet).summary((1, 1, 28, 28))["total_params"] == \
        61610


def test_unported_options_raise(lenet_state, tmp_path):
    # the loader's worker and prefetch options are ported since: taken
    assert port_io.DataLoader(Squares(4), num_workers=2).num_workers == 2
    assert port_io.DataLoader(
        Squares(4), prefetch_to_device=True).prefetch_to_device == 2
    model, _, _ = _model(port, lenet_state, port_cb.Callback)
    with pytest.raises(NotImplementedError, match="A.13"):
        model.fit(Digits(4), resume=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.14"):
        model.save(str(tmp_path / "m"), training=False)


def test_early_stopping_stops_as_the_reference():
    logs = [{"loss": [1.0]}, {"loss": [0.9]}, {"loss": [0.95]},
            {"loss": [0.97]}, {"loss": [0.5]}]
    stopped = {}
    for cb in (ref_cb, port_cb):
        class Holder:
            stop_training = False
        es = cb.EarlyStopping(patience=2)
        es.set_model(Holder())
        for epoch, log in enumerate(logs):
            es.on_epoch_end(epoch, log)
            if es.model.stop_training:
                break
        stopped[cb] = (es.stopped_epoch, es.best)
    assert stopped[port_cb] == stopped[ref_cb] == (3, 0.9)
