"""Checkpoints and resume (counterpart of
``scale_imagenet_tpu/runtime/checkpoint.py:147-257``).

A checkpoint is a directory::

    model.pth          the weights and BN statistics as a reference-layout
                       state dict: the file ``--ckpt`` of eval and serve
                       loads strict
    train_state.pth    the optimizer state (momentum, EMA) by parameter
                       name, and the step
    metadata.json      {"model_name", "config", ...}, as the JAX
                       package's ``save_model`` writes them

``CheckpointManager`` keeps the JAX package's layout and rules: step dirs
``<root>/step_XXXXXXXX``, relative ``last`` and ``best`` links, ``best.json``
at ``best_root`` (the stable ``ckpt/<log_name>/`` parent, so best tracking
runs across resumed runs), and the newest ``keep`` step dirs besides the
linked ones.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

MODEL_FILE = "model.pth"
STATE_FILE = "train_state.pth"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, payload: dict,
                    metadata: dict | None = None) -> None:
    """``payload``: ``{"model": state_dict, "opt_state": {...}, "step":
    int}``; every tensor is written from the CPU."""
    os.makedirs(path, exist_ok=True)
    torch.save(_cpu(payload["model"]), os.path.join(path, MODEL_FILE))
    torch.save({"opt_state": _cpu(payload["opt_state"]),
                "step": int(payload["step"])},
               os.path.join(path, STATE_FILE))
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, default=str)


def train_payload(ts) -> dict:
    """The checkpoint payload of a ``TrainState``."""
    return {"model": ts.model.state_dict(), "opt_state": ts.opt_state,
            "step": ts.step}


def load_train_state(path: str, ts) -> None:
    """Restore ``ts`` (a ``TrainState``) in place from a checkpoint dir:
    the optimizer tensors (same names, same keys) and the step.  Raises
    ``FileNotFoundError`` when the dir holds weights only and ``KeyError``
    when its optimizer state has other keys than ``ts`` (an EMA on one side
    only, another model)."""
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(state_file):
        raise FileNotFoundError(f"{path} holds no {STATE_FILE} (weights "
                                "only)")
    saved = torch.load(state_file, map_location="cpu", weights_only=True)
    opt = saved["opt_state"]
    if {k: set(v) for k, v in opt.items()} != \
            {k: set(v) for k, v in ts.opt_state.items()}:
        raise KeyError(f"the checkpoint's optimizer state holds "
                       f"{sorted(opt)} of other tensors than the run's "
                       f"{sorted(ts.opt_state)}")
    with torch.no_grad():
        for part, tensors in ts.opt_state.items():
            for name, t in tensors.items():
                t.copy_(opt[part][name])
    ts.step = int(saved["step"])


def _wrote(path: str, root: str) -> bool:
    """True if ``path`` is inside ``root`` (this run's own step dirs)."""
    path = os.path.realpath(path)
    root = os.path.realpath(root)
    return path == root or path.startswith(root + os.sep)


class CheckpointManager:
    """Timestamped run-dir checkpoints with ``last``/``best`` links (the
    reference keeps ``ckpt/<log_name>/<date>/``).  ``best_root``: where the
    ``best`` link and ``best.json`` live (default ``root``)."""

    def __init__(self, root: str, keep: int = 3,
                 best_root: str | None = None):
        self.root = root
        self.best_root = best_root or root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        os.makedirs(self.best_root, exist_ok=True)
        self._saved: list[str] = []
        self.best_metric = -float("inf")
        best_json = os.path.join(self.best_root, "best.json")
        if os.path.exists(best_json):
            with open(best_json) as f:
                self.best_metric = float(json.load(f)["metric"])

    def save(self, step: int, payload: dict, metric: float | None = None,
             metadata: dict | None = None) -> str:
        path = os.path.join(self.root, f"step_{step:08d}")
        save_checkpoint(path, payload, metadata)
        self._saved.append(path)
        self._update_link("last", path)
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            with open(os.path.join(self.best_root, "best.json"), "w") as f:
                json.dump({"metric": metric, "step": step}, f)
            self._update_link("best", path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if not self._is_linked(old):
                shutil.rmtree(old, ignore_errors=True)
        return path

    def _link_path(self, name: str) -> str:
        root = self.best_root if name == "best" else self.root
        return os.path.join(root, name)

    def _update_link(self, name: str, target: str) -> None:
        link = self._link_path(name)
        old = None
        if os.path.islink(link):
            old = os.path.normpath(
                os.path.join(os.path.dirname(link), os.readlink(link)))
            os.unlink(link)
        # relative, so the tree stays relocatable
        os.symlink(os.path.relpath(target, os.path.dirname(link)), link)
        # reap a former target that aged out of the keep window while
        # linked; only step dirs this run wrote
        target = os.path.normpath(target)
        if old and old != target and old not in self._saved \
                and _wrote(old, self.root) and not self._is_linked(old):
            shutil.rmtree(old, ignore_errors=True)

    def _is_linked(self, path: str) -> bool:
        for name in ("last", "best"):
            link = self._link_path(name)
            if os.path.islink(link) and \
                    os.path.realpath(link) == os.path.realpath(path):
                return True
        return False
