"""The port's synthetic LM stream against the reference's law, on the CPU.

JAX's threefry streams cannot be reproduced in torch, so the port's
``SyntheticLM`` draws other tokens from the same law: each row starts at a
token uniform in the vocabulary and steps by a stride uniform in 1..6
modulo the vocabulary, with 2 % of the tokens replaced by uniform ones.
Held here: seekability (``batch_at`` depends on the step alone, and
``iterate(start)`` yields ``batch_at``), shape and dtype as the
reference's, and the law, on the port's batches and the reference's alike:
every row's stride in 1..6 and every stride seen, the starts spread over
the vocabulary, and the share of tokens off their row's progression within
five standard deviations of 2 %.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro_torch.data import SyntheticLM
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

VOCAB, SEQ, BATCH = 49152, 256, 256


def _port(**kw):
    return SyntheticLM(vocab=VOCAB, seq_len=SEQ, global_batch=BATCH, device="cpu", **kw)


def test_batch_at_is_seekable_and_iterate_follows_it():
    data = _port(seed=3)
    late = data.batch_at(7)["tokens"]
    for step in (0, 1, 2):
        data.batch_at(step)
    assert torch.equal(data.batch_at(7)["tokens"], late)
    assert not torch.equal(data.batch_at(8)["tokens"], late)
    assert not torch.equal(_port(seed=4).batch_at(7)["tokens"], late)
    for step, batch in itertools.islice(data.iterate(5), 3):
        assert torch.equal(batch["tokens"], data.batch_at(step)["tokens"])
    assert [step for step, _ in itertools.islice(data.iterate(5), 3)] == [5, 6, 7]
    with pytest.raises(ValueError, match="negative"):
        data.batch_at(-1)


def test_shape_and_dtype_match_the_reference():
    small = dict(vocab=100, seq_len=12, global_batch=3)
    want = np.asarray(RefSyntheticLM(**small).batch_at(0)["tokens"])
    got = SyntheticLM(**small, device="cpu").batch_at(0)["tokens"]
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32
    assert want.dtype == np.int32


def _law(toks: np.ndarray, vocab: int) -> tuple[np.ndarray, float, np.ndarray]:
    """Each row's stride (the most common step), the share of tokens off
    the row's progression, and the row starts read back from the stride."""
    steps = np.diff(toks, axis=1) % vocab
    strides = np.array([np.bincount(row, minlength=vocab).argmax() for row in steps])
    t = np.arange(toks.shape[1])[None, :]
    # the start agrees with most tokens: start = tok - stride * t
    starts = np.array([np.bincount(row, minlength=vocab).argmax()
                       for row in (toks - strides[:, None] * t) % vocab])
    on = (starts[:, None] + strides[:, None] * t) % vocab == toks
    return strides, 1.0 - on.mean(), starts


@pytest.mark.parametrize("package", ["port", "reference"])
def test_stream_law(package):
    if package == "port":
        toks = _port().batch_at(0)["tokens"].numpy()
    else:
        toks = np.asarray(RefSyntheticLM(VOCAB, SEQ, BATCH).batch_at(0)["tokens"])
    assert toks.min() >= 0 and toks.max() < VOCAB
    strides, off, starts = _law(toks, VOCAB)
    assert set(strides.tolist()) == {1, 2, 3, 4, 5, 6}
    n = toks.size
    sigma = np.sqrt(0.02 * 0.98 / n)
    assert abs(off - 0.02) < 5 * sigma, off
    # starts uniform over the vocabulary: every eighth of it is hit
    assert len(np.unique(starts * 8 // VOCAB)) == 8
