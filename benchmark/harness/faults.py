"""Faults planted underneath the timed path, for the readings that show
the comparison catches them (``calibrate.py --fault``, and the CPU test
``tests/test_benchmark_faults.py``).  Each is a context manager that
patches the program for its duration:

* ``altered``: an answer altered where it is produced (eval: the first
  image's logits rolled by one class; train: the first leaf's gradient
  doubled as the optimizer gets it);
* ``half``: half of the batch left out (eval: the forward of the first
  half, its logits standing for the second; train: the step on the first
  half, its mean standing for the batch's);
* ``unchanged`` (train): a step that returns its state unchanged (the
  parameters, momentum and BN statistics put back after it).
"""

from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import torch


def _entry(cfg: dict, path: str):
    module, name = cfg["program"][path].split(":")
    return importlib.import_module(module), name


def _altered_logits(fn):
    def apply(*a, **k):
        out = fn(*a, **k).clone()
        out[0] = out[0].roll(1)
        return out
    return apply


def _half_logits(fn):
    def apply(*a, **k):
        *front, x = a
        out = fn(*front, x[:x.shape[0] // 2], **k)
        return torch.cat([out, out])
    return apply


def _train_step_patch(wrap):
    from scale_imagenet_tpu_torch.train import steps

    make = steps.make_train_step

    def patched(model, opt, *a, **k):
        return wrap(make(model, opt, *a, **k), model)
    return mock.patch.object(steps, "make_train_step", patched)


def _half_step(step, model):
    def half(ts, images, labels, *rest):
        n = images.shape[0] // 2
        return step(ts, images[:n], labels[:n], *rest)
    return half


def _unchanged_step(step, model):
    def unchanged(ts, *rest):
        tensors = [*model.parameters(), *model.buffers(),
                   *ts.opt_state["momentum"].values()]
        saved = [t.detach().clone() for t in tensors]
        ts, metrics = step(ts, *rest)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return ts, metrics
    return unchanged


def _altered_update():
    from scale_imagenet_tpu_torch.train import optim

    update = optim.SGD.update

    def altered(self, params, grads, state, step):
        first = next(iter(grads))
        return update(self, params, {**grads, first: 2.0 * grads[first]},
                      state, step)
    return mock.patch.object(optim.SGD, "update", altered)


@contextlib.contextmanager
def plant(kind: str, cell):
    """The fault ``kind`` planted for ``cell``'s path."""
    tr = cell.traffic
    if tr["mode"] == "eval":
        module, name = _entry(cell.config, tr["path"])
        wrap = {"altered": _altered_logits, "half": _half_logits}[kind]
        patch = mock.patch.object(module, name, wrap(getattr(module, name)))
    elif kind == "altered":
        patch = _altered_update()
    else:
        patch = _train_step_patch({"half": _half_step,
                                   "unchanged": _unchanged_step}[kind])
    with patch:
        yield
