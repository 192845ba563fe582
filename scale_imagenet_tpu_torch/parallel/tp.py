"""Channel-group tensor parallelism over ranks (counterpart of
``scale_imagenet_tpu/parallel/tp.py``).

TT blocks are grouped convolutions whose channel groups are independent,
so every channel-indexed tensor splits blockwise over the mesh's model
axis and the whole block stack runs with no model-axis communication
(``tp.py:1-28``):

* the stem conv's output channels split: the activations land
  channel-split;
* the heads' grouped convs are channel-local wherever ``(p / model)`` keeps
  the group alignment (``local_config``);
* a rank's channel interleave of its local head slices IS the contiguous
  global slice ``[d*4L, (d+1)*4L)`` of the interleaved tensor, so the fuse
  head's groups stay local;
* flatten is channel-major (NCHW), so the flattened features split
  blockwise and the classifier's first matmul is row-parallel: one sum
  over the model group, the only model collective of the network
  (``_SumOverModel``), after which the head runs replicated.

A rank holds the model at its local width: a ``TPTTnetImageNet`` built
from ``local_config`` whose channel-indexed tensors are its slice of the
whole model's (``shard_model``, the counterpart of ``tp_param_specs`` and
``shard_params_tp``, ``tp.py:60-84``); its classifier's BN, ``lin2`` and any
``lin1`` bias are whole.  ``gather_tensors`` is the inverse
(``scale_imagenet_tpu/main.py:1470-1486``): checkpoints, the momentum
buffers and the EMA are written whole, so a TP checkpoint loads in one
process and a one-process checkpoint resumes under ``--tp``.

Data parallelism composes on the data axis: the train step is
``train/steps.py::make_train_step`` over the local model, with its one
``all_reduce`` over the mesh's ``data_group`` (gradients, new BN
statistics, loss, top-1/5); the eval sums go over the same group.
JAX's TP step ``pmean``s the gradient of a data-replicated parameter
over ``data`` (``tp.py:350``), and on a 2x2 mesh its collectives take the
sum of the data shards' gradients, not their mean (``ROADMAP.md``, queue
C); the port takes the mean.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..compile.lut_eval import BlockLUT, MultiHeadLUT, lut_ttnet_features
from ..models.classifier import ClassifierScale
from ..models.ttnet_imagenet import TTnetImageNet, TTnetImageNetConfig, \
    ttnet_imagenet_features
from ..layers.linear import linear
from ..layers.norm import batch_norm
from ..ops.poly import polynome_act
from .data_parallel import _dist

# what ``scale_imagenet_tpu/parallel/tp.py::local_config`` meets on a
# config it cannot take: an attribute the TTnetImageNetConfig has
TP_FAMILY = ("--tp: the JAX package's tensor-parallel steps build their "
             "per-shard config with parallel/tp.py::local_config, which "
             "fails on {kind} (AttributeError: '{kind}' object has no "
             "attribute '{attr}')")


def local_config(cfg: TTnetImageNetConfig, n_model: int) \
        -> TTnetImageNetConfig:
    """The per-shard config: ``p / n_model`` channels everywhere
    (``tp.py:45-57``, its two refusals and their texts).  A config that is
    not the ttnet_imagenet family's raises a ``ValueError`` naming the
    ``AttributeError`` JAX's function meets on it."""
    kind = type(cfg).__name__
    for attr in ("p", "variant"):
        if not hasattr(cfg, attr):
            raise ValueError(TP_FAMILY.format(kind=kind, attr=attr))
    p = cfg.p
    if p % n_model:
        raise ValueError(f"p={p} not divisible by model axis {n_model}")
    p_local = p // n_model
    min_group = 16 if cfg.variant == "small" else 4
    if p_local % min_group:
        raise ValueError(
            f"local width {p_local} breaks the {min_group}-channel group "
            f"alignment; use a smaller model axis")
    return dataclasses.replace(cfg, nfilter=p_local, tfilter=1)


# ------------------------------------------------------------- slicing

def split_axis(full: tuple, local: tuple, n_model: int) -> int | None:
    """The axis along which a tensor of shape ``full`` splits into
    ``n_model`` blocks of shape ``local`` (None: it is whole on every
    rank).  The local model's shapes say it: the one axis where they
    differ, ``local * n_model == full`` there (``tp_param_specs``: conv
    weights on their output axis, BN vectors and statistics, ``lin1``'s
    ``(out, in)`` weight on its input axis)."""
    if tuple(full) == tuple(local):
        return None
    diff = [a for a, (f, l) in enumerate(zip(full, local)) if f != l]
    if len(full) != len(local) or len(diff) != 1 \
            or local[diff[0]] * n_model != full[diff[0]]:
        raise ValueError(f"shape {tuple(full)} does not split into "
                         f"{n_model} blocks of {tuple(local)}")
    return diff[0]


def shard_tensor(t: torch.Tensor, axis: int | None, n_model: int,
                 index: int) -> torch.Tensor:
    """Model index ``index``'s contiguous block of ``t`` along ``axis``
    (``t`` itself when whole)."""
    if axis is None:
        return t
    size = t.shape[axis] // n_model
    return t.narrow(axis, index * size, size)


class _SumOverModel(torch.autograd.Function):
    """The row-parallel matmul's sum over the model group: forward an
    ``all_reduce`` of the partial products; backward the identity.  Every
    model rank computes the same loss from the same summed logits, so the
    gradient of its partial product is the upstream gradient itself; a
    backward that summed again would scale every gradient by the model
    size (the failure ``tp.py:21-23`` records under ``check_vma=False``).
    """

    @staticmethod
    def forward(ctx, partial, group):
        dist = _dist(group)
        if dist is None:
            return partial.clone()
        # gloo sums f32/f64; a bf16 partial (``--bf16``) sums in f32, which
        # rounds the two-term sum as a bf16 add does
        wide = partial.dtype in (torch.float32, torch.float64)
        out = partial.clone() if wide else partial.float()
        dist.all_reduce(out, group=group)
        return out if wide else out.to(partial.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_model(partial: torch.Tensor, group) -> torch.Tensor:
    return _SumOverModel.apply(partial, group)


def tp_classifier(head: ClassifierScale, feats: torch.Tensor,
                  stats: dict | None, group) -> torch.Tensor:
    """``_tp_classifier`` (``tp.py:87-105``): the local partial matmul over
    this rank's rows of ``lin1``, the sum over the model group, then the
    replicated head; a folded ``lin1`` bias is added once, after the sum.
    Eval, or training when ``stats`` is given."""
    y = sum_over_model(linear(feats, head.lin1.weight), group)
    if head.lin1.bias is not None:
        y = y + head.lin1.bias
    y = polynome_act(batch_norm(head.BN2, y, stats))
    return linear(y, head.lin2.weight, head.lin2.bias)


class TPTTnetImageNet(TTnetImageNet):
    """A rank's channel slice of a ttnet_imagenet model: the module tree of
    ``TTnetImageNet`` at ``local_config``'s width, whose forward sums the
    classifier's partial products over ``model_group`` (None: every
    rank; ``_forward_local``, ``tp.py:121-127``).  ``full_cfg`` is the whole
    model's config; ``n_model``/``model_index`` its place."""

    def __init__(self, full_cfg: TTnetImageNetConfig, n_model: int,
                 model_index: int, model_group=None):
        super().__init__(local_config(full_cfg, n_model))
        self.full_cfg = full_cfg
        self.n_model, self.model_index = n_model, model_index
        self.model_group = model_group

    def forward(self, x: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
        return tp_ttnet_imagenet_apply(self, x, stats)


def tp_ttnet_imagenet_apply(model: TPTTnetImageNet, x: torch.Tensor,
                            stats: dict | None = None) -> torch.Tensor:
    """The local feature stack and the row-parallel classifier: NHWC
    images -> the whole logits, the same on every model rank."""
    return tp_classifier(model.classifier,
                         ttnet_imagenet_features(model, x, stats), stats,
                         model.model_group)


def _with_biases(local: nn.Module, sd: dict) -> None:
    """Give ``local`` the conv and linear biases that BN folding added to
    the whole model (``convert/bn_fold.py``), so its state dict has the
    same keys."""
    own = local.state_dict()
    for key in sd:
        if key in own:
            continue
        path, leaf = key.rsplit(".", 1)
        mod = local.get_submodule(path)
        if leaf != "bias" or not isinstance(mod, (nn.Conv2d, nn.Linear)):
            raise KeyError(f"{key}: no such tensor in the local model")
        mod.bias = nn.Parameter(torch.empty(
            mod.weight.shape[0], dtype=mod.weight.dtype,
            device=mod.weight.device))


def shard_model(model: TTnetImageNet, n_model: int, model_index: int,
                model_group=None) -> TPTTnetImageNet:
    """The rank's ``TPTTnetImageNet``: the local-width module on ``model``'s
    device, dtype and mode, holding ``model_index``'s slice of every
    channel-indexed tensor and the whole of the rest (``shard_params_tp``,
    ``tp.py:80-84``).  ``model`` must be a ttnet_imagenet model."""
    w = model.stem_conv.weight
    with torch.device("meta"):
        local = TPTTnetImageNet(model.cfg, n_model, model_index,
                                model_group)
    local = local.to_empty(device=w.device).to(w.dtype)
    full = model.state_dict()
    _with_biases(local, full)
    own = local.state_dict()
    local.load_state_dict({
        k: shard_tensor(v, split_axis(v.shape, own[k].shape, n_model),
                        n_model, model_index)
        for k, v in full.items()}, strict=True)
    local.train(model.training)
    for p, q in zip(model.parameters(), local.parameters()):
        q.requires_grad_(p.requires_grad)
    return local


def split_axes(local: nn.Module, full_shapes: dict) -> dict:
    """Each tensor name of ``local``'s state dict (and parameter names) ->
    its split axis against the whole model's shapes ``full_shapes``."""
    n = local.n_model
    return {k: split_axis(full_shapes[k], v.shape, n)
            for k, v in local.state_dict().items()}


def full_shapes(cfg: TTnetImageNetConfig, local: nn.Module) -> dict:
    """The whole model's tensor shapes by name, from its config (no
    allocation), with ``local``'s biases."""
    with torch.device("meta"):
        full = TTnetImageNet(cfg)
    _with_biases(full, local.state_dict())
    return {k: tuple(v.shape) for k, v in full.state_dict().items()}


@torch.no_grad()
def gather_tensors(tensors: dict, axes: dict, mesh) -> dict:
    """The whole tensors from every model rank's slices (the inverse of
    ``shard_model``; ``ckpt_payload``'s gather,
    ``scale_imagenet_tpu/main.py:1470-1486``): each rank writes its block
    into zeros of the whole shape and one ``all_reduce`` a dtype over the
    model group adds them (gloo takes CUDA tensors for ``all_reduce`` and
    ``broadcast`` only).  Every rank of the group must call it; every rank
    gets the whole tensors.  A tensor with no split axis is returned as it
    is (it is the same on every model rank)."""
    n, index, group = mesh["model"], mesh.model_index, mesh.model_group
    out = {}
    split = {k: t for k, t in tensors.items() if axes[k] is not None}
    for k, t in tensors.items():
        if axes[k] is None:
            out[k] = t
            continue
        shape = list(t.shape)
        shape[axes[k]] *= n
        whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
        shard_tensor(whole, axes[k], n, index).copy_(t)
        out[k] = whole
    dist = _dist(group)
    if dist is None:
        return out
    by_dtype: dict = {}
    for k in split:
        by_dtype.setdefault((out[k].dtype, out[k].device), []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([out[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        for k, v in zip(keys, flat.split([out[k].numel() for k in keys])):
            out[k] = v.view_as(out[k])
    return out


# --------------------------------------------------------------- LUTs

def _local_block_lut(lut: BlockLUT, cfg, n_model: int,
                     index: int) -> BlockLUT:
    return BlockLUT(cfg=cfg, packed=shard_tensor(
        lut.packed, 0, n_model, index).contiguous(),
        nonconstant=lut.nonconstant)


def shard_luts(luts: list, model: TPTTnetImageNet) -> list:
    """A rank's tables from the whole model's (``shard_luts_tp`` and
    ``_local_luts``, ``tp.py:170-210``): every head's and fuse head's
    table split on its group axis (bit words ``(G, F, W)`` and float
    tables ``(G, 2^n, F)`` alike), under the local configs.  Heads 1 and
    2 merge again at the local width (``MultiHeadLUT``), so each rank's
    merged words are its own contiguous tensor, as the gather kernel's
    contract asks.  ``nonconstant`` stays the whole table's count."""
    n, index = model.n_model, model.model_index
    out = []
    for lut, block in zip(luts, model.blocks):
        bcfg = block.cfg
        heads = {i: _local_block_lut(lut.heads[i], hcfg, n, index)
                 for i, hcfg in bcfg.head_cfgs().items()}
        convf = None if lut.convf is None else _local_block_lut(
            lut.convf, bcfg.convf_cfg(), n, index)
        out.append(MultiHeadLUT(bcfg, heads, convf))
    return out


@torch.no_grad()
def tp_lut_apply(luts: list, model: TPTTnetImageNet,
                 x: torch.Tensor) -> torch.Tensor:
    """``make_tp_lut_eval_step``'s forward (``tp.py:213-254``): the local
    float stem, the rank's tables, the row-parallel classifier.  NHWC
    images -> the whole logits."""
    feats = lut_ttnet_features(luts, model, x)
    return tp_classifier(model.classifier, feats, None, model.model_group)


# -------------------------------------------------------------- train

def shard_train_state(model: TTnetImageNet, opt_state: dict, mesh):
    """``shard_train_state_tp`` (``tp.py:382-404``): the rank's local model
    and optimizer state from the whole ones (momentum and EMA split as
    their parameters, ``_opt_specs``): ``(local model, opt_state)``, for a
    ``TrainState`` at the same step."""
    n, index = mesh["model"], mesh.model_index
    local = shard_model(model, n, index, mesh.model_group)
    own = dict(local.named_parameters())
    opt = {part: {k: shard_tensor(
        v, split_axis(v.shape, own[k].shape, n), n, index).clone()
        for k, v in tensors.items()} for part, tensors in opt_state.items()}
    return local, opt


def gather_train_payload(ts, mesh) -> dict:
    """The whole train state as ``runtime/checkpoint.py::train_payload``
    writes it: every rank of the model group calls it (a collective)."""
    local = ts.model
    shapes = full_shapes(local.full_cfg, local)
    axes = split_axes(local, shapes)
    sd = gather_tensors(local.state_dict(), axes, mesh)
    opt = {part: gather_tensors(tensors, axes, mesh)
           for part, tensors in ts.opt_state.items()}
    return {"model": {k: sd[k] for k in shapes}, "opt_state": opt,
            "step": ts.step}
