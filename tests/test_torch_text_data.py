"""The token-sequence datasets (``data/text.py``) against the JAX
package's on the CPU: ``stackoverflow_nwp`` (and its alias
``stackoverflow``) and ``fed_shakespeare`` arrays bitwise the reference's
for the same configuration, through both registries and through
``generate_word_drift`` directly; a real StackOverflow corpus under
``data_dir`` is refused, not silently replaced."""

import numpy as np
import pytest

from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_torch.data.text import generate_word_drift
from torch_threads import one_intra_op_thread  # noqa: F401


def _same(got, want):
    assert got.x.dtype == want.x.dtype == np.int32
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert (got.num_classes, got.name, got.is_sequence, got.meta) == \
        (want.num_classes, want.name, want.is_sequence, want.meta)


@pytest.mark.parametrize("dataset,kw", [
    ("stackoverflow_nwp", dict(sample_num=12)),
    ("stackoverflow_nwp", dict(sample_num=9, seed=3, noise_prob=0.2,
                               change_points="rand", train_iterations=3)),
    ("stackoverflow", dict(sample_num=7, change_points="A",
                           time_stretch=2)),
    ("fed_shakespeare", dict(sample_num=6, text_seq_len=12, seed=5,
                             noise_prob=0.1, change_points="rand"))],
    ids=["nwp", "nwp_noisy_rand", "alias_stretched", "shakespeare"])
def test_bitwise_the_reference(dataset, kw, tmp_path):
    from feddrift_tpu.config import ExperimentConfig as JaxConfig
    from feddrift_tpu.data.registry import make_dataset as jax_make
    kw = dict(kw, dataset=dataset, data_dir=str(tmp_path))
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    _same(got, want)
    if dataset.startswith("stackoverflow"):
        assert got.x.shape[-1] == 20 and got.num_classes == 10000
        assert got.x.max() < 10000 and got.y.max() < 10000


def test_direct_call_at_other_sizes():
    from feddrift_tpu.data.text import generate_word_drift as jax_word
    cp = np.array([[0, 1, 2, 1], [1, 1, 0, 2], [2, 0, 0, 1]])
    args = (cp, 2, 4, 10)
    kw = dict(noise_prob=0.05, seed=9, seq_len=7, vocab=50,
              data_dir="/nonexistent")
    _same(generate_word_drift(*args, **kw), jax_word(*args, **kw))


def test_real_corpus_is_refused(tmp_path):
    base = tmp_path / "stackoverflow" / "datasets"
    base.mkdir(parents=True)
    (base / "stackoverflow_train.h5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="The other datasets"):
        torch_make(TorchConfig(dataset="stackoverflow_nwp", sample_num=2,
                               data_dir=str(tmp_path)))
