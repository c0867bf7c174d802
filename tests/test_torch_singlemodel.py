"""The single-model baselines and the retrain specs against the JAX package.

``data/retrain.py``'s ``time_weights`` and ``is_retrain_spec`` must equal
the reference's exactly for every spec on a grid of (C, t, T1).
``WindowBaseline`` (win-1, all, oblivious, window) and ``RecencyWeighted``
(exp, lin) must hand ``TrainStep`` the reference's time weights at every
step, on one model (M = 1), every step chunkable.
"""

import types

import numpy as np
import pytest

from feddrift_torch.algorithms import make_algorithm
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.core.pool import ModelPool
from feddrift_torch.data import retrain
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models.mlp import FeedForwardNN
from torch_threads import one_intra_op_thread  # noqa: F401

SPECS = ("all", "win-1", "win-2", "win-5", "weight-linear", "weight-exp",
         "sel-0,2", "sel-",
         "clientsel-[[0], [1, 2], [0, 1, 2], [2], [0], [1]]", "poisson")
BAD = ("win-abc", "weight-bogus", "sel-9", "clientsel-[[0]]", "bogus", "")


@pytest.mark.parametrize("spec", SPECS)
def test_time_weights_equal_the_reference(spec):
    from feddrift_tpu.data import retrain as jretrain
    for C in (1, 6):
        for T1 in (3, 8):
            for t in range(T1):
                if spec.startswith("clientsel") and (C < 6 or t < 2):
                    continue
                got = retrain.time_weights(spec, C, t, T1)
                want = jretrain.time_weights(spec, C, t, T1)
                assert got.dtype == want.dtype == np.float32
                assert np.array_equal(got, want), (C, T1, t)


@pytest.mark.parametrize("spec", SPECS + BAD)
def test_is_retrain_spec_equals_the_reference(spec):
    from feddrift_tpu.data import retrain as jretrain
    for dims in ((), (6, 8), (2, 3)):
        assert retrain.is_retrain_spec(spec, *dims) \
            == jretrain.is_retrain_spec(spec, *dims), dims


def _pair(algo, **kw):
    from feddrift_tpu.algorithms import make_algorithm as jmake
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.data.registry import make_dataset as jdata
    kw = dict(client_num_in_total=6, client_num_per_round=6,
              train_iterations=5, sample_num=20, concept_drift_algo=algo,
              **kw)
    jcfg, cfg = JCfg(**kw), ExperimentConfig(**kw)
    pool = ModelPool.create(FeedForwardNN((3,), 2, 4), None, cfg.num_models,
                            device="cpu")
    jalgo = jmake(jcfg, jdata(jcfg), types.SimpleNamespace(num_models=1),
                  None)
    algo_ = make_algorithm(cfg, make_dataset(cfg), pool,
                           types.SimpleNamespace(device="cpu"))
    return jalgo, algo_


@pytest.mark.parametrize("algo,kw", [
    ("win-1", {}), ("all", {}), ("oblivious", {}), ("window", {}),
    ("window", {"retrain_data": "win-3"}),
    ("window", {"retrain_data": "weight-exp"}),
    ("window", {"retrain_data": "poisson"}),
    ("win-1", {"retrain_data": "all"}), ("exp", {}), ("lin", {})])
def test_round_inputs_equal_the_reference(algo, kw):
    jalgo, port = _pair(algo, **kw)
    assert port.M == jalgo.M == 1 == port.pool.num_models
    for t in range(5):
        jalgo.begin_iteration(t)
        port.begin_iteration(t)
        tw, sw, fm, lr_scale = port.round_inputs(t, 3)
        jtw, _, _, jlr = jalgo.round_inputs(t, 3)
        assert tw.shape == (1, 6, 6)
        assert np.array_equal(tw.numpy(), np.asarray(jtw))
        assert lr_scale == float(jlr) == 1.0 and sw is None and fm is None
        assert port.chunkable(t) and jalgo.chunkable(t)
        assert np.array_equal(port.test_model_idx(t), jalgo.test_model_idx(t))
    if algo == "oblivious":       # one model on all data, not win-1
        assert (tw.numpy()[0, :, :5] == 1).all()


def test_window_refuses_what_it_cannot_train():
    """A string outside the retrain grammar is refused; ``poisson*`` is
    not (since the weighted draw landed): the reference's window trains it
    as win-1 with unit sample weights."""
    jalgo, port = _pair("window", retrain_data="poisson-2")
    for t in range(3):
        jalgo.begin_iteration(t)
        port.begin_iteration(t)
        tw, sw, _, _ = port.round_inputs(t, 0)
        assert np.array_equal(tw.numpy(), np.asarray(jalgo.round_inputs(t, 0)[0]))
        assert np.array_equal(tw.numpy()[0], retrain.time_weights("win-1", 6, t, 6))
        assert sw is None and not port.uses_sample_weights
    with pytest.raises(ValueError, match="not a retrain spec"):
        _pair("window", retrain_data="win-abc")


def test_baseline_trains_one_model_on_the_fused_path():
    from feddrift_torch.kernels.local_sgd import local_sgd
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(
        concept_drift_algo="lin", train_iterations=3, comm_round=10,
        sample_num=100, batch_size=50), device="cpu")
    fused = []
    orig = exp._run_iteration_fused
    exp._run_iteration_fused = lambda t, o: (fused.append(t), orig(t, o))
    exp.run()
    assert fused == [0, 1, 2] and local_sgd.launches == 0
    assert all(v.shape[0] == 1 for v in exp.pool.params.values())
    assert 0.6 < exp.logger.last("Test/Acc") <= 1.0
