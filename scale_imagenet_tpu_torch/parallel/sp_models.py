"""The families' row-sharded eval forwards under ``--sp``, and their
interval twins for ``--certify`` (the port's counterpart of GSPMD
partitioning any model's eval, ``scale_imagenet_tpu/train/steps.py::
make_eval_step(spatial=True)``).

Each forward is its family's eval forward (``models/``) with the
row-mixing calls swapped for ``parallel/sp.py``'s row ops and the global
height ``h`` threaded beside every tensor; the row-local code is the
family's own: BN in eval, the activations and quantizers, the cells
after their first conv (``pre_padded``), the k = 1 ``block_tt`` (the
fused kernel among them), and the classifier after the gather.  Every
forward takes a rank's rows of NHWC images (their height ``n`` times the
rank's rows) and returns the whole logits, the same on every rank of the
model group; a stochastic one takes the batch's ``NoiseKey`` as
``noise`` and flips exactly the bits the unsharded forward flips
(``sp.RowNoise``).

``SP_FAMILIES`` maps every config type of ``main.py``'s ``_FAMILIES`` to
its forward and, for the three interval families, its interval twin:
``sp_forward`` and ``sp_interval_logits`` dispatch on it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels.stem import s2d_conv, stem_pad
from ..layers.conv import bin_conv2d, conv2d
from ..layers.linear import linear
from ..layers.norm import batch_norm, bn_scale_bias
from ..models.classifier import classifier_scale
from ..models.multihead import channel_interleave
from ..models.resnet import ResNet, ResNetConfig, quan_conv, quan_linear, \
    res_plan
from ..models.tt_certif import TTCertif, TTCertifConfig, _fixups, \
    tt_certif_head, tt_certif_interval_head
from ..models.tt_fhe import TTFHE, TTFHEAlexnet, TTFHEAlexnetConfig, \
    TTFHEConfig, tt_fhe_classifier, tt_fhe_stem_act
from ..models.ttnet_cifar import Cifar10LowNoise, Cifar10LowNoiseConfig, \
    ModelGeneral, ModelGeneralConfig, MobilenetV1TT, MobilenetV1TTConfig, \
    MobilenetV2TT, MobilenetV2TTConfig, _ball, _bin_weight, _crop_k3, \
    block_resnet, blocks_of, cifar10lownoise_head, \
    cifar10lownoise_interval_head, model_general_head, \
    model_general_interval_head, nchw
from ..models.ttnet_general_float import FLOAT_VARIANTS, \
    TTGeneralCorrectBN, TTGeneralCorrectBNConfig, TTGeneralFloat, \
    TTGeneralFloatConfig, _act, _correctbn_crops, block_resnet_float
from ..models.ttnet_imagenet import TTnetImageNet, TTnetImageNetConfig, \
    TTnetVGGStem, TTnetVGGStemConfig, _nchw
from ..models.ttnet_imagenet_v1 import TTnetV1, TTnetV1Config, \
    _fixups_v1, block_resnet_bn
from ..ops.binarize import binarize01_act
from ..ops.quantize import activation_quantize, input_quantize
from ..robust.interval import Interval, interval_batch_norm, \
    interval_conv2d, interval_from_eps_ball, interval_heaviside, \
    interval_heaviside_noisy, interval_mono, interval_struct
from .sp import RowShard, row_noise, sp_avg_pool, sp_block_tt, sp_cell, \
    sp_conv2d, sp_crop_cat, sp_flatten, sp_interval, sp_interval_block_tt, \
    sp_interval_conv2d, sp_interval_flatten, sp_max_pool, \
    sp_multihead_block, sp_window, sp_zero_pad2d, window_rows

# ``[:, :, :-1, :-1]``
_CROP = (0, -1, 0, -1)


def _height(x: torch.Tensor, shard: RowShard) -> int:
    """The global height of NHWC images of which ``x`` holds a rank's
    rows."""
    return x.shape[1] * shard.n


# ---------------------------------------------------------------------------
# models/ttnet_imagenet.py


def sp_stem(model: TTnetImageNet, x: torch.Tensor, h: int,
            shard: RowShard) -> tuple:
    """``models/ttnet_imagenet.py::stem`` over the rank's rows of NCHW
    images of height ``h``: ``(bits, height)``."""
    conv = model.stem_conv
    if model.cfg.stem_impl == "s2d":
        h_out = (h + sum(stem_pad(h))) // 4 - 3
        slab = window_rows(x, h, h_out, 4, -6, 16, shard)
        y = s2d_conv(F.pad(slab, (*stem_pad(x.shape[3]), 0, 0)),
                     conv.weight)
        if conv.bias is not None:
            y = y + conv.bias.view(1, -1, 1, 1)
    else:
        x, h = sp_avg_pool(x, h, shard)
        y, h_out = sp_conv2d(x, h, shard, conv.weight, conv.bias, stride=2,
                             padding=3)
    return binarize01_act(batch_norm(model.stem_bn, y)), h_out


def sp_ttnet_imagenet_apply(model: TTnetImageNet, x: torch.Tensor,
                            shard: RowShard) -> torch.Tensor:
    y, h = sp_stem(model, _nchw(x, model), _height(x, shard), shard)
    for block in model.blocks:
        y, h = sp_multihead_block(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    return classifier_scale(model.classifier, sp_flatten(y, h, shard))


def sp_ttnet_vgg_stem_apply(model: TTnetVGGStem, x: torch.Tensor,
                            shard: RowShard) -> torch.Tensor:
    """AvgPool 4, two 3x3 convs, BN, MaxPool 5 (56 -> 11 rows: a rank's
    output rows read across the slice edge), the block's raw concat."""
    c1, c2 = model.stem_conv, model.stem_conv2
    y, h = sp_avg_pool(_nchw(x, model), _height(x, shard), shard, 4)
    y, h = sp_conv2d(y, h, shard, c1.weight, c1.bias, padding=1)
    y, h = sp_conv2d(torch.relu(y), h, shard, c2.weight, c2.bias, padding=1)
    y = batch_norm(model.stem_bn, torch.relu(y))
    y, h = sp_max_pool(y, h, shard, 5)
    y, h = sp_multihead_block(model.blocks[0], binarize01_act(y), h, shard)
    return classifier_scale(model.classifier, sp_flatten(y, h, shard))


# ---------------------------------------------------------------------------
# models/tt_fhe.py


def sp_tt_fhe_apply(model: TTFHE, x: torch.Tensor, shard: RowShard,
                    noise=None) -> torch.Tensor:
    spec = model.cfg.spec
    keyed = noise is not None and model.cfg.stochastic
    conv = model.stem_conv
    y, h = sp_conv2d(_nchw(x, model), _height(x, shard), shard,
                     conv.weight, conv.bias, stride=2, padding=spec["pad"])
    y = tt_fhe_stem_act(model, y, noise=row_noise(
        noise.child("stem") if keyed else None, h, shard))
    for i, block in enumerate(model.blocks):
        y, h = sp_multihead_block(block, y, h, shard,
                                  noise.child(i) if keyed else None)
    pool = sp_max_pool if spec["pool"] == "max" else sp_avg_pool
    y, h = pool(y, h, shard)
    return tt_fhe_classifier(model, sp_flatten(y, h, shard))


def sp_tt_fhe_alexnet_apply(model: TTFHEAlexnet, x: torch.Tensor,
                            shard: RowShard) -> torch.Tensor:
    conv = model.stem_conv
    y, h = sp_conv2d(_nchw(x, model), _height(x, shard), shard,
                     conv.weight, conv.bias, padding=1)
    y = batch_norm(model.stem_bn, torch.relu(y))
    y, h = sp_max_pool(y, h, shard, model.cfg.maxpool)
    y, h = sp_multihead_block(model.blocks[0], binarize01_act(y), h, shard)
    return classifier_scale(model.classifier, sp_flatten(y, h, shard))


# ---------------------------------------------------------------------------
# models/ttnet_imagenet_v1.py


def sp_v1_multihead(block, x: torch.Tensor, h: int,
                    shard: RowShard) -> tuple:
    """``v1_multihead``: the heads, head 4 (a zero pad of 1 and AvgPool 2 at
    stride 2), the fix-ups, the crop to the smallest, the fuse head."""
    cfg = block.cfg
    outs = {i: sp_cell(block_resnet_bn, getattr(block, f"Block_conv{i}"),
                       x, h, shard) for i in cfg.conv_heads}
    outs[4] = sp_avg_pool(x, h, shard, 2, padding=1) if cfg.stride == 2 \
        else (x, h)
    crops, pads = _fixups_v1(cfg.spec.get("fixup"), cfg.stride, x.shape[3])
    for i in crops:
        outs[i] = sp_zero_pad2d(*outs[i], shard, _CROP)
    for i in pads:
        outs[i] = sp_zero_pad2d(*outs[i], shard, (1, 0, 1, 0))
    order = sorted(outs)
    cat, th = sp_crop_cat([outs[i][0] for i in order],
                          [outs[i][1] for i in order], shard)
    return sp_cell(block_resnet_bn, block.Block_convf,
                   channel_interleave(cat, cfg.cpt), th, shard)


def sp_ttnet_v1_apply(model: TTnetV1, x: torch.Tensor,
                      shard: RowShard) -> torch.Tensor:
    conv = model.stem_conv
    y, h = sp_avg_pool(_nchw(x, model), _height(x, shard), shard)
    y, h = sp_conv2d(y, h, shard, conv.weight, conv.bias, stride=2,
                     padding=3)
    y = binarize01_act(batch_norm(model.stem_bn, y))
    for block in model.blocks:
        y, h = sp_v1_multihead(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    return linear(sp_flatten(y, h, shard), model.fc.weight, model.fc.bias)


# ---------------------------------------------------------------------------
# models/ttnet_general_float.py


def sp_float_multihead(block, x: torch.Tensor, h: int,
                       shard: RowShard) -> tuple:
    cfg = block.cfg
    outs = [sp_cell(block_resnet_float, getattr(block, f"conv{i}"), x, h,
                    shard) for i in sorted(cfg.head_cfgs())]
    cat, th = sp_crop_cat([o for o, _ in outs], [ho for _, ho in outs],
                          shard)
    return sp_cell(block_resnet_float, block.convf,
                   channel_interleave(cat, cfg.cpt), th, shard)


def sp_tt_general_float_apply(model: TTGeneralFloat, x: torch.Tensor,
                              shard: RowShard) -> torch.Tensor:
    cfg, conv = model.cfg, model.stem_conv
    y, h = nchw(x, model), _height(x, shard)
    if FLOAT_VARIANTS[cfg.variant]["stem"] == "s1":
        y, h = sp_conv2d(y, h, shard, conv.weight, conv.bias, padding=3)
    else:
        y, h = sp_avg_pool(y, h, shard)
        y, h = sp_conv2d(y, h, shard, conv.weight, conv.bias, stride=2,
                         padding=3)
    y = batch_norm(model.stem_bn, _act(y, cfg.a_bit))
    for block in blocks_of(model):
        y, h = sp_float_multihead(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    return linear(sp_flatten(y, h, shard), model.fc.weight, model.fc.bias)


def sp_correctbn_block(block, x: torch.Tensor, h: int,
                       shard: RowShard) -> tuple:
    cfg = block.cfg
    outs = {2: sp_cell(block_resnet_bn, block.conv2, x, h, shard),
            3: sp_cell(block_resnet_bn, block.conv3, x, h, shard),
            1: sp_avg_pool(x, h, shard) if cfg.stride == 2 else (x, h)}
    for i in _correctbn_crops(cfg.stride, x.shape[3]):
        outs[i] = sp_zero_pad2d(*outs[i], shard, _CROP)
    cat, th = sp_crop_cat([outs[i][0] for i in (1, 2, 3)],
                          [outs[i][1] for i in (1, 2, 3)], shard)
    return sp_cell(block_resnet_bn, block.convf,
                   channel_interleave(cat, cfg.cpt), th, shard)


def sp_tt_general_correctbn_apply(model: TTGeneralCorrectBN,
                                  x: torch.Tensor,
                                  shard: RowShard) -> torch.Tensor:
    cfg, conv = model.cfg, model.stem_conv
    y, h = nchw(x, model), _height(x, shard)
    if cfg.image_size != 32:
        y, h = sp_avg_pool(y, h, shard)
    y, h = sp_conv2d(y, h, shard, conv.weight, conv.bias, stride=2,
                     padding=3)
    y = _act(batch_norm(model.stem_bn, y), cfg.a_bit)
    for block in blocks_of(model):
        y, h = sp_correctbn_block(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    y = linear(sp_flatten(y, h, shard), model.fc1.weight, model.fc1.bias)
    return linear(y, model.fc2.weight, model.fc2.bias)


# ---------------------------------------------------------------------------
# models/resnet.py


def sp_res_block(block, x: torch.Tensor, h: int, wbit: int, abit: int,
                 shard: RowShard) -> tuple:
    """``res_block``: each conv on its slab, unpadded (``dorefa_a`` maps
    the slab's zero pad to 0, as the conv's own pad after it); the
    strided 1x1 shortcut reads every ``stride``-th row."""
    out, h_out = x, h
    plan = res_plan(block)
    for i, (conv, bn, stride, pad) in enumerate(plan):
        slab, h_out = sp_window(out, h_out, shard, conv.kernel_size, stride,
                                pad)
        out = batch_norm(bn, quan_conv(slab, conv, wbit, abit, stride))
        if i < len(plan) - 1:
            out = torch.relu(out)
    residual = x
    if block.down_conv is not None:
        slab, _ = sp_window(x, h, shard, 1, block.stride)
        residual = batch_norm(block.down_bn, quan_conv(
            slab, block.down_conv, wbit, abit, stride=block.stride))
    return torch.relu(out + residual), h_out


def sp_resnet_apply(model: ResNet, x: torch.Tensor,
                    shard: RowShard) -> torch.Tensor:
    cfg = model.cfg
    y, h = sp_conv2d(nchw(x, model), _height(x, shard), shard,
                     model.conv1.weight, model.conv1.bias,
                     stride=1 if cfg.cifar else 2,
                     padding=1 if cfg.cifar else 3)
    y = torch.relu(batch_norm(model.bn1, y))
    if not cfg.cifar:
        y, h = sp_max_pool(y, h, shard, 3, 2, 1)
    for name in model.block_names:
        y, h = sp_res_block(getattr(model, name), y, h, cfg.wbit, cfg.abit,
                            shard)
    # the global pool reads the global height, not the rank's rows
    y, h = sp_avg_pool(y, h, shard, h if cfg.cifar else 7, 1)
    return quan_linear(sp_flatten(y, h, shard), model.fc, 8, cfg.abit)


# ---------------------------------------------------------------------------
# models/ttnet_cifar.py


def sp_cifar_multihead(block, x: torch.Tensor, h: int,
                       shard: RowShard) -> tuple:
    """``cifar_multihead``: the heads with their crop rules, the max-pool
    head (the input cropped by a pixel at stride 1), the fuse head."""
    cfg = block.cfg
    crop = _crop_k3(cfg, x.shape[3])
    outs = []
    for i, spec in enumerate(cfg.heads):
        if spec[0] == "conv":
            out = sp_cell(block_resnet, getattr(block, f"conv{i + 1}"), x,
                          h, shard)
            outs.append(sp_zero_pad2d(*out, shard, _CROP)
                        if crop and spec[1] == 3 else out)
        else:
            outs.append(sp_max_pool(x, h, shard) if cfg.stride == 2
                        else sp_zero_pad2d(x, h, shard, _CROP))
    # the heads agree in size (``cifar_multihead_out_size``)
    cat = channel_interleave(torch.cat([o for o, _ in outs], dim=1),
                             cfg.cpt)
    return sp_cell(block_resnet, block.convf, cat, outs[0][1], shard)


def sp_mobilenet_v2_tt_apply(model: MobilenetV2TT, x: torch.Tensor,
                             shard: RowShard) -> torch.Tensor:
    conv = model.stem_conv
    y, h = sp_conv2d(nchw(x, model), _height(x, shard), shard, conv.weight,
                     conv.bias, stride=model.cfg.stem_stride, padding=3)
    y = batch_norm(model.stem_bn, activation_quantize(y, 2))
    for block in blocks_of(model):
        y, h = sp_cifar_multihead(block, y, h, shard)
    y, h = sp_avg_pool(y, h, shard)
    return linear(sp_flatten(y, h, shard), model.fc.weight, model.fc.bias)


def sp_model_general_apply(model: ModelGeneral, x: torch.Tensor,
                           shard: RowShard) -> torch.Tensor:
    cfg, conv = model.cfg, model.stem_conv
    _, k, st = cfg.preprocessing_cnn
    slab, h = sp_window(nchw(x, model), _height(x, shard), shard, k, st, st)
    if cfg.type_weights_preprocessing == "float":
        y = conv2d(slab, conv.weight, conv.bias, stride=st)
    else:
        y = bin_conv2d(slab, conv, stride=st, rounding=False)
    y = binarize01_act(batch_norm(model.stem_bn, y))
    for i in range(len(cfg.filters)):
        g, stv, pad = cfg.groups[i], cfg.strides[i], cfg.paddings[i]
        ca, cb = getattr(model, f"conv{i}a"), getattr(model, f"conv{i}b")
        y, h = sp_conv2d(y, h, shard, ca.weight, ca.bias, stv, pad, g)
        y = torch.relu(batch_norm(getattr(model, f"bn{i}a"), y))
        y = conv2d(y, cb.weight, cb.bias, groups=g)
        y = binarize01_act(batch_norm(getattr(model, f"bn{i}b"), y))
    return model_general_head(model, sp_flatten(y, h, shard))


def sp_mobilenet_v1_tt_apply(model: MobilenetV1TT, x: torch.Tensor,
                             shard: RowShard) -> torch.Tensor:
    conv = model.stem_conv
    y, h = sp_conv2d(nchw(x, model), _height(x, shard), shard, conv.weight,
                     conv.bias, padding=3)
    y = binarize01_act(batch_norm(model.stem_bn, y))
    blocks = blocks_of(model)
    for i, block in enumerate(blocks):
        y, h = sp_cell(block_resnet, block, y, h, shard)
        if i != len(blocks) - 1:
            y = binarize01_act(y)
    y, h = sp_avg_pool(y, h, shard)
    return linear(sp_flatten(y, h, shard), model.fc.weight, model.fc.bias)


def sp_cifar10lownoise_apply(model: Cifar10LowNoise, x: torch.Tensor,
                             shard: RowShard) -> torch.Tensor:
    y = input_quantize(nchw(x, model), model.cfg.quant_step)
    y = activation_quantize(batch_norm(model.bn0, y), 2)
    slab, h = sp_window(y, _height(x, shard), shard, 3, 2)
    y = binarize01_act(bin_conv2d(slab, model.conv1, stride=2,
                                  rounding=False))
    y, h = sp_conv2d(y, h, shard, model.conv2.weight, model.conv2.bias,
                     stride=2, groups=48)
    y = torch.relu(batch_norm(model.bn2, y))
    y = conv2d(y, model.conv3.weight, model.conv3.bias, groups=48)
    y = binarize01_act(batch_norm(model.bn3, y))
    return cifar10lownoise_head(model, sp_flatten(y, h, shard))


# ---------------------------------------------------------------------------
# models/tt_certif.py


def _to_size(y: torch.Tensor, h: int, shard: RowShard, target: int):
    """``tt_certif._to_size``: cropped or zero-padded bottom-right."""
    return sp_zero_pad2d(y, h, shard, (0, target - h, 0, target - h))


def sp_certif_block(block, x: torch.Tensor, h: int, shard: RowShard,
                    noise=None) -> tuple:
    cfg = block.cfg
    keys = [None] * 3 if noise is None else [noise.child(i)
                                            for i in range(3)]
    out1 = sp_block_tt(block.conv1, x, h, shard, noise=keys[0])
    out2, target = sp_block_tt(block.conv2, x, h, shard, noise=keys[1])
    out4 = (x, h) if cfg.stride == 1 else sp_avg_pool(x, h, shard)
    crops, pad4 = _fixups(x.shape[3], cfg.stride)
    if 1 in crops:
        out1 = sp_zero_pad2d(*out1, shard, _CROP)
    if 4 in crops:
        out4 = sp_zero_pad2d(*out4, shard, _CROP)
    if pad4:
        out4 = sp_zero_pad2d(*out4, shard, (0, 1, 0, 1))
    cat = torch.cat([_to_size(*out1, shard, target)[0], out2,
                     _to_size(*out4, shard, target)[0]], dim=1)
    return sp_block_tt(block.convf, channel_interleave(cat, cfg.cpt),
                       target, shard, noise=keys[2])


def sp_tt_certif_apply(model: TTCertif, x: torch.Tensor, shard: RowShard,
                       noise=None) -> torch.Tensor:
    h = _height(x, shard)
    y = batch_norm(model.bn1, batch_norm(model.bn0, nchw(x, model)))
    root = None if noise is None else noise.child(0)
    y = binarize01_act(y, model.cfg.T, row_noise(
        None if noise is None else noise.child(1), h, shard))
    for i, block in enumerate(blocks_of(model)):
        y, h = sp_certif_block(block, y, h, shard,
                               None if root is None else root.child(i))
    return tt_certif_head(model, sp_flatten(y, h, shard))


# ---------------------------------------------------------------------------
# the interval twins (``--certify``)


def _sp_interval_certif_block(block, iv: Interval, h: int,
                              shard: RowShard) -> tuple:
    """``tt_certif._interval_certif_block`` over the rank's rows."""
    cfg = block.cfg
    in_loss = iv.loss
    out1 = sp_interval_block_tt(block.conv1, iv, h, shard)
    out2, target = sp_interval_block_tt(block.conv2, iv, h, shard)
    out4 = (iv, h) if cfg.stride == 1 \
        else sp_interval(sp_avg_pool, iv, h, shard)
    crops, pad4 = _fixups(iv.vmin.shape[3], cfg.stride)
    if 1 in crops:
        out1 = sp_interval(sp_zero_pad2d, *out1, shard, _CROP)
    if 4 in crops:
        out4 = sp_interval(sp_zero_pad2d, *out4, shard, _CROP)
    if pad4:
        out4 = sp_interval(sp_zero_pad2d, *out4, shard, (0, 1, 0, 1))
    out1, _ = sp_interval(_to_size, *out1, shard, target)
    out4, _ = sp_interval(_to_size, *out4, shard, target)
    cat = Interval(
        torch.cat([out1.vmin, out2.vmin, out4.vmin], dim=1),
        torch.cat([out1.vmax, out2.vmax, out4.vmax], dim=1),
        in_loss + (out1.loss - in_loss) + (out2.loss - in_loss)
        + (out4.loss - in_loss))
    cat = interval_struct(cat, lambda v: channel_interleave(v, cfg.cpt))
    return sp_interval_block_tt(block.convf, cat, target, shard)


def sp_tt_certif_interval(model: TTCertif, x: torch.Tensor, eps,
                          inputs_min=0.0, inputs_max=1.0, *,
                          shard: RowShard) -> Interval:
    """``tt_certif_interval`` over the rank's rows: the whole logit
    bounds on every rank."""
    h = _height(x, shard)
    iv = interval_from_eps_ball(x, eps, inputs_min, inputs_max)
    iv = interval_struct(iv, lambda v: nchw(v, model))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn0))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn1))
    iv = interval_heaviside_noisy(iv, model.cfg.T)
    for block in blocks_of(model):
        iv, h = _sp_interval_certif_block(block, iv, h, shard)
    return tt_certif_interval_head(model, sp_interval_flatten(iv, h, shard))


def sp_cifar10lownoise_interval(model: Cifar10LowNoise, x: torch.Tensor,
                                eps, inputs_min=0.0, inputs_max=1.0, *,
                                shard: RowShard) -> Interval:
    """``cifar10lownoise_interval_logits`` over the rank's rows."""
    iv = _ball(model, x, eps, inputs_min, inputs_max)
    iv = interval_mono(iv, lambda v: input_quantize(v, model.cfg.quant_step))
    iv = interval_batch_norm(iv, *bn_scale_bias(model.bn0))
    iv = interval_mono(iv, lambda v: activation_quantize(v, 2))
    iv, h = sp_interval_conv2d(iv, _height(x, shard), shard,
                               _bin_weight(model.conv1), stride=2)
    iv, h = sp_interval_conv2d(interval_heaviside(iv), h, shard,
                               model.conv2.weight, stride=2, groups=48,
                               bias=model.conv2.bias)
    iv = interval_mono(interval_batch_norm(iv, *bn_scale_bias(model.bn2)),
                       torch.relu)
    iv = interval_conv2d(iv, model.conv3.weight, groups=48,
                         bias=model.conv3.bias)
    iv = interval_heaviside(interval_batch_norm(
        iv, *bn_scale_bias(model.bn3)))
    return cifar10lownoise_interval_head(
        model, sp_interval_flatten(iv, h, shard))


def sp_model_general_interval(model: ModelGeneral, x: torch.Tensor, eps,
                              inputs_min=0.0, inputs_max=1.0, *,
                              shard: RowShard) -> Interval:
    """``model_general_interval_logits`` over the rank's rows."""
    cfg = model.cfg
    _, _, st = cfg.preprocessing_cnn
    iv = _ball(model, x, eps, inputs_min, inputs_max)
    stem = model.stem_conv
    if cfg.type_weights_preprocessing == "float":
        iv, h = sp_interval_conv2d(iv, _height(x, shard), shard,
                                   stem.weight, st, st, bias=stem.bias)
    else:
        iv, h = sp_interval_conv2d(iv, _height(x, shard), shard,
                                   _bin_weight(stem), st, st)
    iv = interval_heaviside(interval_batch_norm(
        iv, *bn_scale_bias(model.stem_bn)))
    for i in range(len(cfg.filters)):
        g, stv, pad = cfg.groups[i], cfg.strides[i], cfg.paddings[i]
        ca, cb = getattr(model, f"conv{i}a"), getattr(model, f"conv{i}b")
        iv, h = sp_interval_conv2d(iv, h, shard, ca.weight, stv, pad, g,
                                   ca.bias)
        iv = interval_mono(interval_batch_norm(
            iv, *bn_scale_bias(getattr(model, f"bn{i}a"))), torch.relu)
        iv = interval_conv2d(iv, cb.weight, groups=g, bias=cb.bias)
        iv = interval_heaviside(interval_batch_norm(
            iv, *bn_scale_bias(getattr(model, f"bn{i}b"))))
    return model_general_interval_head(model,
                                       sp_interval_flatten(iv, h, shard))


# ---------------------------------------------------------------------------
# the dispatch


@dataclasses.dataclass(frozen=True)
class SpFamily:
    """A config type's row-sharded forward ``(model, x, shard[, noise])
    -> logits`` and, for the interval families, its interval twin
    ``(model, x, eps, inputs_min, inputs_max, *, shard) -> Interval``."""
    forward: Callable
    interval: Callable | None = None


SP_FAMILIES = {
    TTnetImageNetConfig: SpFamily(sp_ttnet_imagenet_apply),
    TTnetVGGStemConfig: SpFamily(sp_ttnet_vgg_stem_apply),
    TTFHEConfig: SpFamily(sp_tt_fhe_apply),
    TTFHEAlexnetConfig: SpFamily(sp_tt_fhe_alexnet_apply),
    TTnetV1Config: SpFamily(sp_ttnet_v1_apply),
    TTGeneralFloatConfig: SpFamily(sp_tt_general_float_apply),
    TTGeneralCorrectBNConfig: SpFamily(sp_tt_general_correctbn_apply),
    MobilenetV2TTConfig: SpFamily(sp_mobilenet_v2_tt_apply),
    MobilenetV1TTConfig: SpFamily(sp_mobilenet_v1_tt_apply),
    ModelGeneralConfig: SpFamily(sp_model_general_apply,
                                 sp_model_general_interval),
    Cifar10LowNoiseConfig: SpFamily(sp_cifar10lownoise_apply,
                                    sp_cifar10lownoise_interval),
    TTCertifConfig: SpFamily(sp_tt_certif_apply, sp_tt_certif_interval),
    ResNetConfig: SpFamily(sp_resnet_apply),
}


def sp_forward(model: torch.nn.Module, shard: RowShard):
    """``x -> logits`` (and ``noise=`` for a stochastic model) of ``model``
    over a rank's rows."""
    return functools.partial(SP_FAMILIES[type(model.cfg)].forward, model,
                             shard=shard)


def sp_interval_logits(model: torch.nn.Module, shard: RowShard):
    """``(x, eps, inputs_min, inputs_max) -> Interval`` of ``model`` over a
    rank's rows: the whole logit bounds on every rank."""
    return functools.partial(SP_FAMILIES[type(model.cfg)].interval, model,
                             shard=shard)
