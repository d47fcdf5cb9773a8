"""Faults planted under the timed path, for the tests that show a run
with each of them comes out not correct. Each is a context manager that
patches one function of the program under test and puts it back."""

from __future__ import annotations

import contextlib

import torch

import adaptive_voice_conversion_tpu_torch.infer.inferencer as inferencer
import adaptive_voice_conversion_tpu_torch.train.optim as optim
import adaptive_voice_conversion_tpu_torch.train.step as step


@contextlib.contextmanager
def patched(owner, name: str, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def state_unchanged():
    """The optimiser returns the gradients' norm and changes nothing."""
    def make(old):
        def step_(self, closure=None):
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        return step_
    return patched(optim.TorchAdam, "step", make)


def half_batch_train():
    """Each step's batch keeps its first half: the loss is the mean over it."""
    return patched(step, "sample_segments", lambda old: lambda *a, **k: old(*a, **k)[: a[3] // 2])


def half_batch_grid():
    """The masked model converts the first half of the pairs and hands the
    second half the same mels."""
    def make(old):
        def f(*a):
            return tuple(t[: t.shape[0] // 2].repeat(2, *[1] * (t.dim() - 1)) for t in old(*a))
        return f
    return patched(inferencer, "ae_inference_masked", make)


def altered_oneshot():
    """The vocoder's wav is returned back to front."""
    return patched(inferencer, "melspectrogram2wav", lambda old: lambda *a, **k: old(*a, **k)[::-1].copy())


def altered_grid():
    """The last pair's wav is returned back to front."""
    def make(old):
        def f(self, *a, **k):
            w = old(self, *a, **k)
            return torch.cat([w[:-1], w[-1:].flip(-1)])
        return f
    return patched(inferencer.Inferencer, "_vocode", make)


# the faults each driver's cells can have
FAULTS = {
    "train_device": {"state_unchanged": state_unchanged, "half_batch": half_batch_train},
    "oneshot": {"altered": altered_oneshot},
    "grid": {"half_batch": half_batch_grid, "altered": altered_grid},
}
