"""Faults planted in the measured package's timed path, for the tests and
for ``calibrate.py``'s readings: each a context manager that breaks one
thing underneath and puts it back. A run under one must come out with
``correct`` false."""
import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def streamed_answer_altered():
    """Every fifth chunk's scores come back 0.05 higher."""
    from lidbox_tpu_torch import serve
    score = serve.StreamingClassifier._score_chunk
    calls = []

    def altered(self, chunk):
        calls.append(1)
        out = score(self, chunk)
        return out + 0.05 if len(calls) % 5 == 0 else out
    with _patched(serve.StreamingClassifier, "_score_chunk", altered):
        yield


@contextlib.contextmanager
def state_unchanged():
    """A train step that computes its loss and writes nothing of the
    state."""
    from lidbox_tpu_torch.train.loop import Trainer

    def unchanged(self, state, batch, generator, scalars, loss_out):
        loss, _, _ = self._loss_and_grads(state, batch, generator)
        loss_out.copy_(loss)
    with _patched(Trainer, "_donating_step", unchanged):
        yield


@contextlib.contextmanager
def half_batch():
    """The loss is the mean over the first half of the batch alone."""
    from lidbox_tpu_torch.train.loop import Trainer

    def half(losses, batch):
        return torch.mean(losses[:losses.shape[0] // 2])
    with _patched(Trainer, "_masked_mean", staticmethod(half)):
        yield


FAULTS = {f.__name__: f for f in (streamed_answer_altered, state_unchanged,
                                  half_batch)}
