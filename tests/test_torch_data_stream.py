"""The port's synthetic LM stream (``repro_torch.data.pipeline``:
``StreamConfig``, ``synth_batch``, ``DataStream``) against the
reference's.  Both are numpy, so every batch is compared bitwise: tokens,
labels, mask and the ``_poisoned`` flag of ``corrupt_every``."""
import numpy as np
import pytest

pytest.importorskip("torch")   # the optional `torch` extra

from repro.data import pipeline as jp  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402

CONFIGS = [dict(vocab_size=100, seq_len=8, global_batch=4, seed=3),
           dict(vocab_size=512, seq_len=16, global_batch=8, seed=1,
                corrupt_every=13),
           dict(vocab_size=50304, seq_len=128, global_batch=2, seed=0,
                corrupt_every=3)]


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"V{kw['vocab_size']}")
def test_batches_bitwise_clean_and_poisoned(kw):
    jcfg, tcfg = jp.StreamConfig(**kw), tp.StreamConfig(**kw)
    assert tcfg == tp.StreamConfig(**jcfg.__dict__)
    poisoned = 0
    for step in range(30):
        jb, tb = jp.synth_batch(jcfg, step), tp.synth_batch(tcfg, step)
        _same(jb, tb)
        poisoned += "_poisoned" in tb
    every = kw.get("corrupt_every", 0)
    assert poisoned == (30 // every if every else 0)


def test_state_dict_round_trip_and_restart_position():
    kw = CONFIGS[1]
    s1, j1 = tp.DataStream(tp.StreamConfig(**kw)), \
        jp.DataStream(jp.StreamConfig(**kw))
    batches = [next(s1) for _ in range(15)]
    for b in batches:
        _same(next(j1), b)
    assert s1.state_dict() == j1.state_dict() == {"step": 15}
    s2 = tp.DataStream(tp.StreamConfig(**kw))
    s2.load_state_dict({"step": np.int64(12)})
    assert s2.state_dict() == {"step": 12} and iter(s2) is s2
    _same(next(s2), batches[12])           # a poisoned batch (step 12)
    _same(next(s2), batches[13])
    s3 = tp.DataStream(tp.StreamConfig(**kw), start_step=14)
    _same(next(s3), batches[14])
