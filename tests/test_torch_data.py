"""The port's data layer against the reference: numpy code, so the arrays
must be bitwise equal for the same config."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import feddrift_torch.data.changepoints as tcp
from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.data.registry import make_dataset as torch_make
from torch_threads import one_intra_op_thread  # noqa: F401


def _both(tmp_path, **kw):
    from feddrift_tpu.config import ExperimentConfig as JaxConfig
    from feddrift_tpu.data.registry import make_dataset as jax_make
    kw.setdefault("data_dir", str(tmp_path))
    # both configs check the per-round cohort against the client count
    kw.setdefault("client_num_per_round",
                  min(10, kw.get("client_num_in_total", 10)))
    return torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(dataset="shakespeare", sample_num=3, train_iterations=10),
    dict(dataset="fed_shakespeare", sample_num=2, train_iterations=4,
         change_points="rand", seed=3, text_seq_len=16),
    dict(dataset="shakespeare", sample_num=4, train_iterations=6,
         change_points="rand", drift_together=1, time_stretch=2,
         noise_prob=0.3, seed=11, text_seq_len=12, client_num_in_total=5),
    dict(dataset="shakespeare", sample_num=2, train_iterations=3,
         change_points="0 1;1 2;2 3;3 0", client_num_in_total=2,
         text_seq_len=8),
], ids=["defaults", "rand", "together-stretch-noise", "literal"])
def test_dataset_bitwise_equal(tmp_path, kw):
    t, j = _both(tmp_path, **kw)
    for name in ("x", "y", "concepts"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (t.num_classes, t.name, t.is_sequence, t.meta) == \
        (j.num_classes, j.name, j.is_sequence, j.meta)
    assert t.feature_shape == j.feature_shape


def test_defaults_shape(tmp_path):
    ds = torch_make(TorchConfig(dataset="shakespeare", sample_num=2,
                                data_dir=str(tmp_path)))
    assert ds.x.shape == (10, 11, 2, 80) and ds.y.shape == (10, 11, 2)
    assert ds.num_classes == 90 and ds.is_sequence
    assert 0 <= ds.x.min() and ds.x.max() < 90
    assert ds.feature_shape == (80,) and ds.concepts.shape == (11, 10)


def test_config_fields_and_defaults_match():
    from feddrift_tpu.config import ExperimentConfig as JaxConfig
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(TorchConfig):
        assert f.default == ref[f.name], f.name
    for algo in ("softcluster", "aue", "driftsurf", "win-1", "ifca"):
        assert TorchConfig(concept_drift_algo=algo).num_models == \
            JaxConfig(concept_drift_algo=algo).num_models
    with pytest.raises(ValueError):
        TorchConfig(time_stretch=0)


def test_presets_are_copies():
    from feddrift_tpu.data import changepoints as jcp
    assert tcp.available_presets() == jcp.available_presets()
    for name in tcp.available_presets():
        assert filecmp.cmp(os.path.join(tcp._PRESET_DIR, f"{name}.cp"),
                           os.path.join(jcp._PRESET_DIR, f"{name}.cp"),
                           shallow=False), name
    for args in ((10, 10, 0, 1, 3), (12, 6, 1, 2, 9)):
        assert np.array_equal(tcp.generate_random_change_points(*args),
                              jcp.generate_random_change_points(*args))


def test_errors(tmp_path):
    with pytest.raises(KeyError):             # neither package's name
        torch_make(TorchConfig(dataset="imagenet"))
    with pytest.raises(FileNotFoundError):
        torch_make(TorchConfig(dataset="shakespeare", change_points="nope",
                               data_dir=str(tmp_path)))
    with pytest.raises(ValueError):
        torch_make(TorchConfig(dataset="shakespeare", sample_num=1,
                               client_num_in_total=11,
                               data_dir=str(tmp_path)))
    # a real corpus under data_dir is refused, not silently replaced
    os.makedirs(tmp_path / "shakespeare" / "train")
    with pytest.raises(NotImplementedError):
        torch_make(TorchConfig(dataset="shakespeare", sample_num=1,
                               data_dir=str(tmp_path)))
