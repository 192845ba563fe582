"""Placements over one process's devices (the port's counterpart of
``scale_imagenet_tpu/parallel/sharding.py::batch_sharding``,
``spatial_sharding`` and ``replicate``, and of ``shard_map_dp_apply``'s
replicated tables), for ``--mode serve`` over a ``LocalMesh``
(``parallel/mesh.py``).

JAX places one jitted program's operands with ``NamedSharding``s and lets
GSPMD move the data.  Here each device runs a replica of the served
function in a thread of its own (``runtime/server.py``), and the data moves
by explicit copies:

* ``replicate(state, device)``: the replica's copy of what the served
  function closes over (the model, its tables, its circuit), every tensor
  copied to ``device``, modules deep-copied, dataclasses rebuilt through
  their constructors (so that what a ``__post_init__`` derives, as
  ``MultiHeadLUT``'s merged words, is derived again on the device);
* ``split_batch``: a padded NHWC batch's data slices, data index ``d``
  taking rows ``[d B/D, (d+1) B/D)``; under ``--sp`` model rank ``m`` of
  it takes its ``local_rows`` (``parallel/sp.py``) alone.  The pieces stay
  on the host: each replica copies its own piece to its device;
* ``gather_probs``: each data index's probabilities, from its model rank
  0, in data order, in one host copy;
* ``LocalGroup``: the model axis's exchange under ``--sp``, in place of a
  process group: ``member(i).all_reduce(t)`` sums every member's ``t`` in
  member order, each term brought to the member's device with ``.to``,
  so that every member gets the same bits.  Two barriers with a timeout
  order it (all terms written, then all read), so a member that calls it
  out of turn raises ``threading.BrokenBarrierError`` instead of hanging.
  On the card each member runs on a stream of its own: a term is read
  only after the event that its member recorded when it was written, and
  a member overwrites its ``t`` only after every reader's event.
"""

from __future__ import annotations

import copy
import dataclasses
import threading

import numpy as np
import torch

from .sp import RowShard, local_rows

#: seconds a member waits at a barrier for the others
GROUP_TIMEOUT_S = 60.0


def _event(t: torch.Tensor):
    """An event on ``t``'s device's current stream (None on the CPU)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _after(ev, *devices) -> None:
    """The current streams of ``devices`` wait for ``ev``."""
    if ev is None:
        return
    for d in devices:
        if d.type == "cuda":
            torch.cuda.current_stream(d).wait_event(ev)


class LocalGroup:
    """The members ``0 .. n-1`` of one exchange, member ``i`` on
    ``devices[i]``: ``member(i)`` is an object whose ``all_reduce(t)``
    sums ``t`` over the members in place (``RowShard.group``)."""

    def __init__(self, devices: list, timeout: float = GROUP_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        self._terms = [None] * n          # (t, written event) a member
        self._read = [None] * n           # its "terms read" event
        self._barrier = threading.Barrier(n, timeout=timeout)

    def member(self, i: int) -> "_Member":
        return _Member(self, i)

    def abort(self) -> None:
        """Break the barrier: every member waiting or arriving raises."""
        self._barrier.abort()

    def reset(self) -> None:
        """Mend a broken barrier; only while no member is in a call."""
        self._barrier.reset()


class _Member:
    def __init__(self, group: LocalGroup, index: int):
        self.group, self.index = group, index

    def all_reduce(self, t: torch.Tensor) -> None:
        g, i = self.group, self.index
        device = g.devices[i]
        g._terms[i] = (t, _event(t))
        g._barrier.wait()
        total = None
        for term, written in g._terms:            # member order
            _after(written, device, term.device)
            term = term.to(device)
            total = term.clone() if total is None else total.add_(term)
        g._read[i] = _event(total)
        g._barrier.wait()
        g._terms[i] = None
        for j, read in enumerate(g._read):
            if j != i:
                _after(read, device)
        t.copy_(total)


def split_batch(xs: np.ndarray, mesh, spatial: bool = False) -> dict:
    """``{(d, m): piece}`` of the padded NHWC batch ``xs``, host tensors:
    data index ``d``'s slice for ``(d, 0)``, or under ``spatial`` model
    rank ``m``'s rows of it for every ``(d, m)``."""
    n, m_axis = mesh["data"], mesh["model"]
    b = xs.shape[0] // n
    pieces = {}
    for d in range(n):
        part = torch.from_numpy(xs[d * b:(d + 1) * b])
        if not spatial:
            pieces[d, 0] = part
            continue
        for m in range(m_axis):
            pieces[d, m] = local_rows(part, RowShard(m_axis, m))
    return pieces


def gather_probs(probs: dict, mesh) -> np.ndarray:
    """Data index ``d``'s probabilities from ``probs[d, 0]``, in data
    order, on the host in one copy (brought to ``(0, 0)``'s device
    first)."""
    first = mesh.device(0, 0)
    parts = [probs[d, 0].to(first) for d in range(mesh["data"])]
    return torch.cat(parts).cpu().numpy()


def replicate(obj, device: torch.device):
    """A copy of ``obj`` with every tensor in it on ``device``: tensors
    copied, modules deep-copied and moved, lists, tuples, dicts and
    dataclasses rebuilt around their copied contents; anything holding
    no tensor is returned as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, (list, tuple)):
        items = [replicate(v, device) for v in obj]
        if all(a is b for a, b in zip(items, obj)):
            return obj
        return type(obj)(items)
    if isinstance(obj, dict):
        items = {k: replicate(v, device) for k, v in obj.items()}
        if all(items[k] is obj[k] for k in obj):
            return obj
        return type(obj)(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            if f.init:
                v = getattr(obj, f.name)
                r = replicate(v, device)
                if r is not v:
                    changed[f.name] = r
        return dataclasses.replace(obj, **changed) if changed else obj
    return obj


__all__ = ["GROUP_TIMEOUT_S", "LocalGroup", "gather_probs", "replicate",
           "split_batch"]
