"""Command-line entry (counterpart of ``scale_imagenet_tpu/main.py``): the
``--mode eval [--fold_bn] [--bf16] [--lut | --gates dnf|cnf]``, ``--mode
serve`` (the same serving flags), ``--mode compile [--verilog]``, ``--mode
export`` and single-device ``--mode train`` subsets, and ``--list_models``.

    python -m scale_imagenet_tpu_torch.main --mode eval --shards_dir D \\
        [--fold_bn] [--bf16] [--lut [--lut_path F] | --gates dnf] \\
        --eval_batch_size 256
    python -m scale_imagenet_tpu_torch.main --mode serve --lut --port 8000
    python -m scale_imagenet_tpu_torch.main --mode export --export_out F \\
        [--ckpt X.pth]
    python -m scale_imagenet_tpu_torch.main --model ttnet_imagenet_vgg_stem \\
        --mode eval --shards_dir D [--lut | --gates cnf]
    python -m scale_imagenet_tpu_torch.main --model TT_FHE_SMALL \\
        --mode eval --shards_dir D32 [--lut | --gates dnf]
    python -m scale_imagenet_tpu_torch.main --model TT_FHE_small \\
        --mode eval --shards_dir D32 --seed S
    python -m scale_imagenet_tpu_torch.main --model TT_vf_19lv2_imgnet \\
        --mode eval|serve|train ...
    python -m scale_imagenet_tpu_torch.main --mode compile \\
        --compile_out D [--verilog] [--ckpt X.pth]
    python -m scale_imagenet_tpu_torch.main --mode train --shards_dir T \\
        --eval_shards_dir V [--amp --remat --grad_accum 2 --ema 0.999 \\
        --label_smooth 0.1] [--ckpt <step dir> | --ckpt X.pth]

``--mode eval`` scores the model on pre-decoded uint8 shards
(``--shards_dir``, normalized on the device) or on an ImageFolder
(``--data_dir``/val, decoded on host threads), padding the last batch and
masking its pad rows, and prints ``final: top1 … top5 … loss …`` as the
JAX CLI does.  ``--lut`` evaluates the compiled truth tables instead of the
conv forward; ``--lut_path`` loads them from an archive, or writes it after
compiling.  ``--gates dnf|cnf`` evaluates the network as its boolean
circuit instead (``compile/gate_net.py``): the minimized DNF covers, or the
CNF form (the inverted complement covers); it runs on the card through the
``gate_cubes`` kernel when the circuit fits
``config.performance.gates_device_budget``, else on the host native
evaluator, and says which (serving takes the card's circuit only).
``--mode compile`` writes the truth-table artifacts (CSVs, DNF/CNF
expressions, cube arrays, DIMACS) and ``summary.json`` with the gate count
under ``--compile_out``, plus Verilog modules under ``--verilog``.
``--write_shards`` decodes ``--data_dir``/<shards_split> into
shards (the eval crop, or the 256x256 train pre-crop) and exits.
``--mode serve`` serves the model over HTTP (``runtime/server.py``).
Eval and serve apply the serving transforms in the JAX CLI's order
(``main.py:578-618``): ``--fold_bn`` folds every BN into its conv
(``convert/bn_fold.py``), then ``--bf16`` casts the floating parameters and
buffers to bfloat16, then ``--lut`` or ``--gates`` compile the network
(which refuse both transforms, with the JAX CLI's messages).  ``--mode
export`` writes the unmodified weights as a reference-layout ``.pth``
(``--export_out``, ``convert/export.py``).  ``--list_models`` prints the
registry's names.  The families dispatch their conv, LUT and gate forwards
through ``_family``: the ttnet_imagenet variants (``v2`` among them, whose
n = 30 heads have no tables, so its ``--lut``, ``--gates`` and ``--mode
compile`` refuse with the JAX package's enumeration error), the VGG-stem
variant, and the TT_FHE family (``--model TT_FHE_SMALL`` and the rest of
its models, 32x32 CIFAR-size inputs: eval, serve, train, compile and, for
``TTFHEConfig``, export; no ``--fold_bn``, as in JAX; ``TT_FHE_small``,
whose dead zones draw coin flips, has no tables or circuit and takes a
``NoiseKey`` from ``--seed``: fresh flips for every batch, the same
flips for the same seed), and the v1 ImageNet family (``V1_STAGES`` and
their ``_cifar`` clones) as its conv network only: eval, serve and train,
with ``--lut``, ``--gates``, ``--mode compile`` and ``--mode export``
refused as the JAX CLI refuses them.  The same holds for the families of
``ZOO_MODULES``: the TT_general float family and its correctBN twins, the
mobilenets, ``model_general``, ``cifar10lownoise``, ``tt_certif`` (its
dead zones keyed from ``--seed`` in eval, serve and train, like
``TT_FHE_small``'s) and the DoReFa ResNets, which alone take ``--fold_bn``
(their conv/BN pairs, ``convert/bn_fold.py``) and ``--fuse_quant`` (the
weights DoReFa-quantized offline, every BN folded, served at ``wbit =
32``; ``convert/fuse_quant.py``).  ``--mode compile`` ends on them where
the JAX CLI ends, with its error or a ``ValueError`` naming its crash
(``_refuse_compile``).  ``--model_arg KEY=VALUE`` (repeatable) passes a
keyword to the registry factory, parsed as the JAX CLI parses it
(``--model_arg wbit=2``, ``--model_arg groups=1,None,4,None``).  32x32
models read an ImageFolder through the CIFAR transforms
(``_pick_transforms``).
``--mode train`` trains with SGD + momentum from shards (the full
augmentation on the card from pre-crop shards, a random flip from
same-size ones) or from ``--data_dir``/train (the PIL train transform),
validates each epoch (``--eval_shards_dir`` or ``--data_dir``/val, also
with the EMA weights under ``--ema``), checkpoints every epoch under
``<root_dir>/ckpt/<log_name>/<date>`` and snapshots the state on a crash.
Weights come from ``--seed`` or from ``--ckpt``: a reference-layout
``.pth`` (loaded strict), or a checkpoint dir, from which training resumes
its full state.  ``config.performance`` is not a flag, as in the JAX
package.

Every other flag of the JAX CLI arrives with a later slice and raises here
naming ``ROADMAP.md``; the flags that the JAX CLI refuses in a mode raise
with its messages.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import os
import random
from datetime import datetime

import torch

from .compile.gate_device import build_device_gates, \
    gate_tt_fhe_alexnet_apply_device, gate_tt_fhe_apply_device, \
    gate_ttnet_apply_device, gate_ttnet_vgg_stem_apply_device
from .compile.gate_net import compile_tt_fhe_gates, compile_ttnet_gates, \
    gate_tt_fhe_alexnet_apply, gate_tt_fhe_apply, gate_ttnet_apply, \
    gate_ttnet_vgg_stem_apply, total_gates
from .compile.lut_eval import compile_tt_fhe_lut, compile_ttnet_lut, \
    lut_tt_fhe_alexnet_apply, lut_tt_fhe_apply, lut_ttnet_apply, \
    lut_ttnet_vgg_stem_apply
from .compile.lut_store import load_luts, save_luts
from .compile.truth_table import compile_model_truth_tables, \
    model_block_items, table_cache
from .compile.verilog import export_model_verilog
from .config import performance
from .convert.bn_fold import fold_model_bns
from .convert.export import save_torch_checkpoint
from .data import DataLoader, ImageFolder, IMAGENET_MEAN, IMAGENET_STD, \
    cifar_eval_transform, cifar_train_transform, device_prefetch, \
    imagenet_eval_crop_u8, imagenet_eval_transform, imagenet_train_crop_u8, \
    imagenet_train_transform, pad_batches, shard_loader, write_shards
from .device import resolve_device
from .convert.from_jax import state_dict_from_jax
from .convert.fuse_quant import fuse_resnet
from .convert.torch_import import IMPORTERS
from .models import get_model, list_models
from .models.multihead import MultiHeadBlock
from .models.registry import ZOO_MODULES
from .models.resnet import ResNetConfig, resnet_apply
from .models.tt_certif import TTCertifConfig, tt_certif_apply
from .models.ttnet_cifar import Cifar10LowNoiseConfig, MobilenetV1TTConfig, \
    MobilenetV2TTConfig, ModelGeneralConfig, cifar10lownoise_apply, \
    mobilenet_v1_tt_apply, mobilenet_v2_tt_apply, model_general_apply
from .models.ttnet_general_float import TTGeneralCorrectBNConfig, \
    TTGeneralFloatConfig, tt_general_correctbn_apply, tt_general_float_apply
from .models.tt_fhe import TTFHEAlexnetConfig, TTFHEConfig, \
    tt_fhe_alexnet_apply, tt_fhe_apply
from .models.ttnet_imagenet import TTnetImageNetConfig, \
    TTnetVGGStemConfig, ttnet_imagenet_apply, ttnet_vgg_stem_apply
from .models.ttnet_imagenet_v1 import TTnetV1Config, ttnet_v1_apply
from .ops.binarize import NoiseKey
from .runtime.checkpoint import MODEL_FILE, CheckpointManager, \
    load_train_state, train_payload
from .runtime.evaluate import evaluate
from .runtime.server import serve
from .train import MetricsLogger, TrainState, get_ema, make_eval_step, \
    make_optimizer, make_train_step, params_ema

# ``scale_imagenet_tpu/main.py:961-983``: training flags the JAX CLI
# refuses in eval, with its messages
_EVAL_REFUSALS = {
    "--amp": "--amp is bf16 mixed-precision TRAINING; bf16 serving is "
             "--bf16",
    "--stability_eps": "--stability_eps/--abstract_eps/--bias_decay enable "
                       "robust TRAINING (--mode train); they do not affect "
                       "eval",
    "--grad_accum": "--grad_accum microbatches TRAINING steps (--mode "
                    "train); eval has no gradients",
    "--remat": "--remat trades backward-pass HBM for recompute (--mode "
               "train); eval keeps no activations",
    "--ema": "--ema accumulates during TRAINING (--mode train); to eval EMA "
             "weights, load the checkpoint of an --ema run (best tracking "
             "already scored them)",
    "--label_smooth": "--label_smooth shapes the TRAIN loss; eval reports "
                      "plain CE",
}
_EVAL_REFUSALS["--abstract_eps"] = _EVAL_REFUSALS["--stability_eps"]
_EVAL_REFUSALS["--bias_decay"] = _EVAL_REFUSALS["--stability_eps"]

# ``scale_imagenet_tpu/main.py:1184-1221``: serving and eval flags the JAX
# CLI refuses in training, with its messages
_TRAIN_REFUSALS = {
    "--lut": "--lut is a serving mode: train the float model, then serve "
             "its compiled tables with --mode eval --lut (or export them "
             "with --mode compile)",
    "--gates": "--gates is a serving mode: train the float model, then "
               "serve its boolean circuit with --mode eval --gates dnf|cnf",
    "--certify": "--certify is certified EVAL; robust training is "
                 "--abstract_eps/--stability_eps/--bias_decay",
    "--attack": "--attack is adversarial EVAL; robust training is "
                "--stability_eps (multi-sample perturbations)",
    "--bf16": "--bf16 is bf16 *serving* (eval); bf16 mixed-precision "
              "training is --amp",
    "--native_data": "--native_data drives the eval decode pipeline "
                     "(center crop); the train path decodes with PIL, or "
                     "pre-decode once with --write_shards and train from "
                     "--shards_dir (on-device augmentation)",
    "--fold_bn": "--fold_bn rewrites weights for SERVING (--mode eval); "
                 "training needs live BN statistics",
    "--fuse_quant": "--fuse_quant is fused-quant SERVING (--mode eval); "
                    "DoReFa training quantizes on the fly (--model_arg "
                    "wbit=N)",
    "--sp": "--sp is spatially-partitioned EVAL; training shards the batch "
            "('data' axis) and channel groups (--tp)",
}
_TRAIN_REFUSALS["--attack_eps"] = _TRAIN_REFUSALS["--attack"]

# ``scale_imagenet_tpu/main.py:777-808``: flags the JAX CLI refuses in
# compile, in its order, with its messages
_COMPILE_REFUSALS = {
    "--fold_bn": "--fold_bn rewrites conv-serving weights; truth-table "
                 "compilation evaluates the float blocks (their BNs are "
                 "inside the tables) — drop the flag",
    "--fuse_quant": "--fuse_quant is resnet serving; truth-table "
                    "compilation applies to the TTnet families",
    "--sp": "--sp/--tp shard EVAL over the mesh; truth-table compilation "
            "is per-block",
    "--grad_accum": "--grad_accum microbatches TRAINING steps; compilation "
                    "has no gradients",
    "--remat": "--remat is a TRAINING memory lever; compilation has no "
               "backward pass",
    "--ema": "--ema accumulates during TRAINING; compile the weights you "
             "pass in",
    "--label_smooth": "--label_smooth shapes the TRAIN loss; compilation "
                      "evaluates the forward only",
    "--gates": "--gates is an eval serving mode (--mode eval --gates "
               "dnf|cnf); --mode compile writes the artifacts it runs",
    "--certify": "--certify is certified EVAL (--mode eval)",
    "--attack": "--attack is adversarial EVAL (--mode eval)",
}
_COMPILE_REFUSALS["--tp"] = _COMPILE_REFUSALS["--sp"]
_COMPILE_REFUSALS["--attack_eps"] = _COMPILE_REFUSALS["--attack"]

# ``scale_imagenet_tpu/main.py:887,986``
_GATES_WITH_LUT = ("--gates and --lut are two serving modes for the same "
                   "compiled network — pick one")
# ``scale_imagenet_tpu/main.py:932-937``, with the port's own count: the
# bytes its covers take on the card, where JAX counts its padded tensors
_GATES_ON_HOST = ("--gates: this circuit's covers, counted as the port "
                  "holds them on the card (cubes, offsets and constants; "
                  "JAX counts its padded cube tensors instead), exceed "
                  "config.performance.gates_device_budget, so it would run "
                  "on the HOST evaluator — which cannot enter the server's "
                  "batched forward.  Raise the budget, or serve --lut")

# ``scale_imagenet_tpu/main.py:890-899,993-1002``: the serving transforms
# --gates refuses
_GATES_WITH_BF16 = ("--gates executes boolean covers (its float "
                    "stem/classifier stay f32); --bf16 cannot apply")
_GATES_WITH_FOLD = ("--fold_bn perturbs pre-Heaviside values at float "
                    "precision, which can flip truth-table rows; gate "
                    "circuits compile from the unfolded model — drop "
                    "--fold_bn")
# ``scale_imagenet_tpu/main.py:587-590,604-607``: and --lut
_LUT_WITH_FOLD = ("--fold_bn rewrites conv-mode serving weights; --lut "
                  "serves integer tables (BN is already inside them) — "
                  "drop one")
_LUT_WITH_BF16 = ("--bf16 applies to conv-mode serving; LUT serving is "
                  "integer-table execution (its float stem stays f32)")
# the JAX CLI takes --bf16 in compile and leaves it unused; the port
# refuses a flag that would do nothing
_COMPILE_WITH_BF16 = ("--bf16 casts conv-serving weights; truth-table "
                      "compilation evaluates the float blocks in their own "
                      "precision — drop the flag")
_COMPILE_CACHE = ("--compile_cache is the JAX package's persistent XLA "
                  "compilation cache; the port runs no XLA programs (its "
                  "CUDA kernels are built once into build/kernels/) — drop "
                  "the flag")

# ``scale_imagenet_tpu/main.py:1222-1229``
_REMAT_FAMILY = ("--remat rematerializes the ttnet_imagenet block stack, "
                 "not {}")
# ``scale_imagenet_tpu/main.py:345-362,386-404``: the families without
# tables or a circuit
_SERVING_FAMILY = ("{} serving supports the ttnet_imagenet and TT_FHE "
                   "families, not {}")
# what ``scale_imagenet_tpu/main.py:809-854`` meets on a v1 model whose
# first head has n <= 24 bits: the enumerator builds a Block_TT from a
# resnet cell's config and fails with this AttributeError
_V1_COMPILE = ("--mode compile: the v1 family's heads are Block_resnet_BN "
               "cells, not Block_TT cells; the JAX package's truth-table "
               "compiler fails on them ('BlockResnetConfig' object has no "
               "attribute 'quant')")

# what ``scale_imagenet_tpu/main.py:809-854`` meets on the other
# families, by the first item it compiles: a head whose config has no
# ``quant``, a config with no ``block_configs``, a block config with no
# ``head_cfgs``, a head table keyed from 0, a dead-zone head run without a
# key
_COMPILE_NO_QUANT = ("--mode compile: the {} heads are Block_resnet "
                     "cells, not Block_TT cells; the JAX package's "
                     "truth-table compiler fails on them ({!r})")
_COMPILE_CRASH = ("--mode compile: the JAX package's truth-table compiler "
                  "walks block_configs() and each block's head_cfgs(); it "
                  "fails on {} ({}: {})")
_CERTIF_COMPILE = ("--mode compile: tt_certif's heads are dead-zone "
                   "Block_TT cells (T_block = {}); the JAX package's "
                   "enumerator runs them without a key and fails "
                   "({!r})")
_KEYLESS = "binarize01_act with T != 0 needs a PRNG key"

# ``scale_imagenet_tpu/main.py:536-566``: the --fuse_quant refusals
_FUSE_WITH_FOLD = ("--fuse_quant already folds every BN after quantizing "
                   "the weights; drop --fold_bn")
_FUSE_WITH_COMPILED = ("--fuse_quant is DoReFa-ResNet serving; the "
                       "compiled TTnet modes (--lut/--gates) do not apply")
_FUSE_FAMILY = ("--fuse_quant pre-applies DoReFa weight quantization — "
                "the resnet family, not {}")
_FUSE_FLOAT = ("--fuse_quant: {} has float weights (wbit={}) — nothing to "
               "pre-quantize; BN-fold-only serving is --fold_bn")
# ``scale_imagenet_tpu/main.py:280-303``: --ckpt X.pth
_NO_IMPORTER = ("no .pth importer for the {} family; convert the checkpoint "
                "with scale_imagenet_tpu.convert.torch_import or load a "
                "native checkpoint dir instead")
_CKPT_MISMATCH = ("checkpoint {} does not match the {} architecture built "
                  "from the CLI flags (missing torch key {}); check "
                  "--model/--nfilter/--tfilter/--layers/--model_arg against "
                  "the run that saved it")
_CKPT_MISSING = ("checkpoint {} is missing {} for the {} architecture built "
                 "from the CLI flags; check --model/--nfilter/--tfilter/"
                 "--layers/--model_arg")
_CKPT_SHAPE = ("checkpoint {} has {} of shape {} but the CLI-built {} "
               "expects {}; check --nfilter/--tfilter/--layers/--model_arg "
               "against the run that saved it")

_MODES = ("eval", "serve", "train", "compile", "export")


def _coerce_model_arg(raw: str):
    """int, float, bool or None when the text reads as one
    (``scale_imagenet_tpu/main.py:240``)."""
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.lower() in ("none", ""):
        return None
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


def parse_model_args(pairs: list) -> dict:
    """``KEY=VALUE`` strings -> keyword arguments; a comma-separated value
    is a tuple (``groups=1,None,4,None``), as in the JAX CLI
    (``main.py:253``)."""
    out = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep or not key:
            raise SystemExit(f"--model_arg expects KEY=VALUE, got {pair!r}")
        out[key] = tuple(_coerce_model_arg(v) for v in raw.split(",")) \
            if "," in raw else _coerce_model_arg(raw)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TTnet PyTorch/CUDA harness")
    p.add_argument("--mode", default="eval",
                   help="eval, serve, train, compile or export")
    p.add_argument("--list_models", action="store_true",
                   help="print every registry model name and exit")
    p.add_argument("--compile_cache", type=str, default=None,
                   help="the JAX CLI's XLA compilation cache: refused here "
                        "(the port runs no XLA programs)")
    p.add_argument("--export_out", type=str, default="./exported.pth",
                   help="--mode export: write the weights as a reference-"
                        "layout .pth (loads strict into the reference "
                        "classes and into the JAX package's importer)")
    p.add_argument("--model", type=str, default="ttnet_imagenet_small")
    p.add_argument("--nfilter", type=int, default=8)
    p.add_argument("--tfilter", type=int, default=8)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--model_arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="extra model-config keyword for the registry factory "
                        "(repeatable), e.g. --model_arg wbit=4 --model_arg "
                        "abit=4 for the DoReFa ResNets; values parse as "
                        "int/float/bool/None when they look like one, "
                        "comma-separated ones as tuples")
    p.add_argument("--lut", action="store_true",
                   help="evaluate / serve the compiled truth tables instead "
                        "of the conv forward")
    p.add_argument("--lut_path", type=str, default=None,
                   help="LUT archive (.npz): loaded if present, else "
                        "written after compilation")
    p.add_argument("--gates", choices=["dnf", "cnf"], default=None,
                   help="evaluate / serve the network as its boolean "
                        "circuit: the minimized DNF covers, or the CNF "
                        "form (on the card when it fits "
                        "config.performance.gates_device_budget)")
    p.add_argument("--fold_bn", action="store_true",
                   help="eval / serve with every BatchNorm folded into the "
                        "conv before it (composes with --bf16)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 serving: cast the floating parameters and BN "
                        "statistics to bfloat16 for eval / serve")
    p.add_argument("--fuse_quant", action="store_true",
                   help="DoReFa-ResNet serving: quantize the weights once, "
                        "fold every BN, and serve at wbit=32 (eval / serve)")
    p.add_argument("--compile_out", type=str, default="./truth_tables",
                   help="artifact directory for --mode compile")
    p.add_argument("--max_minimize_bits", type=int, default=16)
    p.add_argument("--verilog", action="store_true",
                   help="--mode compile: also export the gate circuits "
                        "as synthesizable Verilog modules "
                        "(<compile_out>/verilog/, + manifest.json)")
    p.add_argument("--root_dir", type=str, default="./",
                   help="logs go to <root_dir>/logs/<log_name>/<date>, "
                        "checkpoints to <root_dir>/ckpt/<log_name>/<date>")
    p.add_argument("--log_name", type=str, default="ttnet_imagenet_small")
    p.add_argument("--data_dir", type=str, default=None,
                   help="ImageFolder root: eval reads <data_dir>/val, "
                        "training <data_dir>/train (and validates on "
                        "<data_dir>/val when it exists)")
    p.add_argument("--shards_dir", type=str, default=None,
                   help="pre-decoded uint8 shard dir (data/shards.py) to "
                        "eval or train from; normalization and the train "
                        "augmentation run on the device")
    p.add_argument("--eval_shards_dir", type=str, default=None,
                   help="pre-decoded val shards for the per-epoch "
                        "validation during training")
    p.add_argument("--write_shards", type=str, default=None,
                   help="decode <data_dir>/<shards_split> once into this "
                        "shard dir, then exit")
    p.add_argument("--shards_split", choices=["val", "train"], default="val",
                   help="val stores the 224x224 eval crop, train the "
                        "256x256 pre-crop for the on-device augmentation")
    p.add_argument("--shard_size", type=int, default=2048,
                   help="images per shard file for --write_shards")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr_schedule", choices=["multistep", "cosine"],
                   default="multistep",
                   help="multistep = the reference recipe; cosine = warmup "
                        "+ cosine decay over --max_epochs")
    p.add_argument("--warmup_epochs", type=float, default=0.0,
                   help="linear LR warmup epochs (both schedules)")
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--train_batch_size", type=int, default=256)
    p.add_argument("--eval_batch_size", type=int, default=100)
    p.add_argument("--max_epochs", type=int, default=90)
    p.add_argument("--amp", action="store_true",
                   help="bf16 mixed-precision training: bf16 forward/"
                        "backward, f32 master params + optimizer")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the "
                        "backward instead of keeping them (memory for "
                        "operations; the same values)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="run each step's batch as N sequential "
                        "microbatches, one optimizer update")
    p.add_argument("--ema", type=float, default=0.0,
                   help="keep an EMA of the params (decay, e.g. 0.999); "
                        "per-epoch validation also scores the EMA weights "
                        "and best tracking uses them")
    p.add_argument("--label_smooth", type=float, default=0.0,
                   help="label smoothing of the train CE (torch semantics)")
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--log_interval", type=int, default=40)
    p.add_argument("--serve_batch", type=int, default=8,
                   help="dynamic-batcher batch (one padded shape "
                        "regardless of load)")
    p.add_argument("--serve_wait_ms", type=float, default=2.0,
                   help="max straggler wait before a partial batch runs")
    p.add_argument("--port", type=int, default=8000,
                   help="HTTP port (0 = ephemeral)")
    p.add_argument("--serve_host", type=str, default="127.0.0.1",
                   help="bind address (0.0.0.0 to accept remote clients)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference-layout .pth state dict (loaded strict), "
                        "or a checkpoint dir (its model.pth; training "
                        "resumes its full state)")
    args, unknown = p.parse_known_args(argv)
    if args.list_models:
        return args
    if args.mode not in _MODES:
        raise ValueError(f"--mode {args.mode}: the modes are "
                         f"{', '.join(_MODES)}")
    if args.compile_cache:
        raise ValueError(_COMPILE_CACHE)
    if args.verilog and args.mode != "compile":
        raise ValueError("--verilog exports --mode compile artifacts; "
                         f"it does nothing in --mode {args.mode}")
    if args.grad_accum < 1:
        raise ValueError("--grad_accum must be >= 1")
    if args.ema and not (0.0 < args.ema < 1.0):
        raise ValueError(f"--ema decay must be in (0, 1), got {args.ema}")
    if not (0.0 <= args.label_smooth < 1.0):
        raise ValueError(f"--label_smooth must be in [0, 1), got "
                         f"{args.label_smooth}")
    training_flags = {"--amp": args.amp, "--grad_accum": args.grad_accum > 1,
                      "--remat": args.remat, "--ema": args.ema > 0,
                      "--label_smooth": args.label_smooth > 0}
    if args.mode == "eval":
        for flag in [f for f, on in training_flags.items() if on] + unknown:
            refusal = _EVAL_REFUSALS.get(flag.split("=")[0])
            if refusal:
                raise ValueError(refusal)
    if args.mode == "serve":
        for flag, on in {**training_flags,
                         "--shards_dir": args.shards_dir is not None}.items():
            if on:
                raise ValueError(f"--mode serve is single-host inference "
                                 f"serving; {flag} does not apply")
    serving_flags = {"--lut": args.lut, "--gates": bool(args.gates),
                     "--fold_bn": args.fold_bn, "--bf16": args.bf16,
                     "--fuse_quant": args.fuse_quant}
    if args.mode == "train":
        flags = [f for f, on in serving_flags.items() if on] + unknown
        for flag in flags:
            refusal = _TRAIN_REFUSALS.get(flag.split("=")[0])
            if refusal:
                raise ValueError(refusal)
    if args.mode == "compile":
        given = {f for f, on in training_flags.items() if on} | {
            f.split("=")[0] for f in unknown}
        for flag in ("--gates", "--fold_bn", "--fuse_quant"):
            if serving_flags[flag]:
                given.add(flag)
        for flag, refusal in _COMPILE_REFUSALS.items():
            if flag in given:
                raise ValueError(refusal)
        if args.bf16:
            raise ValueError(_COMPILE_WITH_BF16)
    if args.mode == "export":
        # ``scale_imagenet_tpu/main.py:743-770``, for the flags the port has
        for flag, on in {**serving_flags, **training_flags,
                         "--shards_dir": args.shards_dir is not None}.items():
            if on:
                raise ValueError(f"--mode export writes the UNMODIFIED "
                                 f"weights in the reference layout; {flag} "
                                 "does not apply")
    if unknown:
        raise ValueError(f"not ported yet: {' '.join(unknown)} (the port "
                         "has the --mode eval/serve/train/compile/export "
                         "subset; see ROADMAP.md)")
    if args.gates:
        if args.lut:
            raise ValueError(_GATES_WITH_LUT)
        if args.bf16:
            raise ValueError(_GATES_WITH_BF16)
        if args.fold_bn:
            raise ValueError(_GATES_WITH_FOLD)
    if args.fuse_quant:
        if args.fold_bn:
            raise ValueError(_FUSE_WITH_FOLD)
        if args.lut or args.gates:
            raise ValueError(_FUSE_WITH_COMPILED)
    if args.lut and args.fold_bn:
        raise ValueError(_LUT_WITH_FOLD)
    if args.lut and args.bf16:
        raise ValueError(_LUT_WITH_BF16)
    if args.lut_path and not args.lut:
        raise ValueError("--lut_path is the archive of --lut; add --lut")
    if args.write_shards and not args.data_dir:
        raise ValueError("--write_shards decodes --data_dir/<shards_split>; "
                         "give --data_dir")
    if args.mode in ("eval", "train") and not (args.shards_dir
                                               or args.data_dir):
        raise ValueError(f"--mode {args.mode} reads --shards_dir or "
                         "--data_dir; give one")
    return args


def load_checkpoint(model: torch.nn.Module, path: str,
                    name: str | None = None) -> None:
    """A reference-layout ``.pth`` (a state dict, or one under
    ``model_state_dict`` as the JAX exporter writes it), or a checkpoint
    dir holding one (``runtime/checkpoint.py``), loaded strict.  A model of
    ``ZOO_MODULES`` (``name`` its registry name, for the messages) loads
    its own state dict as it is (a checkpoint dir's, or a ``.pth`` with
    its keys), and a reference file through the JAX package's key map
    (``convert/torch_import.py``), refused as the JAX CLI refuses a family
    it has none for."""
    own_dir = os.path.isfile(os.path.join(path, MODEL_FILE))
    if own_dir:
        path = os.path.join(path, MODEL_FILE)
    if not path.endswith(".pth"):
        raise ValueError(f"--ckpt {path}: the port loads .pth state dicts "
                         f"and checkpoint dirs holding {MODEL_FILE}; other "
                         "checkpoint formats: see ROADMAP.md")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model_state_dict", sd)
    cfg = model.cfg
    own = model.state_dict()
    optional = ("grad_scale", "num_batches_tracked")
    if type(cfg) in ZOO_MODULES and not own_dir and set(sd) != set(own):
        kind = type(cfg).__name__
        if kind not in IMPORTERS:
            raise ValueError(_NO_IMPORTER.format(kind))
        try:
            trees = IMPORTERS[kind](
                {k: v.numpy() for k, v in sd.items()}, cfg)
        except KeyError as e:
            raise ValueError(_CKPT_MISMATCH.format(path, name, e)) from e
        sd = state_dict_from_jax(*trees, cfg)
        _check_imported(sd, own, path, name)
    # a block without a fuse head (the VGG-stem variant): the reference
    # constructs one and never applies it, and the JAX importer skips its
    # keys (``scale_imagenet_tpu/convert/torch_import.py:233``); every
    # other key loads strict
    dead = tuple(f"{mname}.Block_convf." for mname, m
                 in model.named_modules()
                 if isinstance(m, MultiHeadBlock) and not m.cfg.fuse)
    if dead:
        sd = {k: v for k, v in sd.items() if not k.startswith(dead)}
    if isinstance(cfg, (TTFHEAlexnetConfig, TTnetV1Config)) \
            or type(cfg) in ZOO_MODULES:
        # no exporter writes these models and their importers read weights
        # and BN statistics only (``torch_import.py:190,424``): the buffers
        # inference never reads may be absent or extra
        sd = {**{k: v for k, v in own.items() if k.endswith(optional)},
              **{k: v for k, v in sd.items()
                 if k in own or not k.endswith(optional)}}
    model.load_state_dict(sd, strict=True)


def _check_imported(sd: dict, own: dict, path: str, name: str) -> None:
    """The JAX CLI's check of an imported tree against the model's
    (``scale_imagenet_tpu/main.py:320-339``): every entry present, of the
    model's shape (torch's layout here)."""
    for key, want in own.items():
        *mods, leaf = key.split(".")
        if leaf in ("grad_scale", "num_batches_tracked"):
            continue
        label = "state" if leaf in ("running_mean", "running_var") \
            else "params"
        where = label + "".join(f"['{m}']" for m in (*mods, leaf))
        if key not in sd:
            raise ValueError(_CKPT_MISSING.format(path, where, name))
        if tuple(sd[key].shape) != tuple(want.shape):
            raise ValueError(_CKPT_SHAPE.format(
                path, where, tuple(sd[key].shape), name, tuple(want.shape)))


@dataclasses.dataclass(frozen=True)
class Family:
    """A config's family: its conv forward, table compiler and LUT
    forward, circuit compiler and host and device gate forwards (the
    dispatch of ``scale_imagenet_tpu/main.py:345,420``)."""
    conv: object
    lut_compile: object
    lut: object
    gate_compile: object
    gate_host: object
    gate_device: object


_FAMILIES = {
    TTnetImageNetConfig: Family(
        ttnet_imagenet_apply, compile_ttnet_lut, lut_ttnet_apply,
        compile_ttnet_gates, gate_ttnet_apply, gate_ttnet_apply_device),
    # the generic block walk compiles the single-block variants too
    TTnetVGGStemConfig: Family(
        ttnet_vgg_stem_apply, compile_ttnet_lut, lut_ttnet_vgg_stem_apply,
        compile_ttnet_gates, gate_ttnet_vgg_stem_apply,
        gate_ttnet_vgg_stem_apply_device),
    TTFHEConfig: Family(
        tt_fhe_apply, compile_tt_fhe_lut, lut_tt_fhe_apply,
        compile_tt_fhe_gates, gate_tt_fhe_apply, gate_tt_fhe_apply_device),
    TTFHEAlexnetConfig: Family(
        tt_fhe_alexnet_apply, compile_ttnet_lut, lut_tt_fhe_alexnet_apply,
        compile_ttnet_gates, gate_tt_fhe_alexnet_apply,
        gate_tt_fhe_alexnet_apply_device),
    # the conv networks only: no tables, no circuit
    **{cfg: Family(apply, None, None, None, None, None) for cfg, apply in (
        (TTnetV1Config, ttnet_v1_apply),
        (TTGeneralFloatConfig, tt_general_float_apply),
        (TTGeneralCorrectBNConfig, tt_general_correctbn_apply),
        (MobilenetV2TTConfig, mobilenet_v2_tt_apply),
        (MobilenetV1TTConfig, mobilenet_v1_tt_apply),
        (ModelGeneralConfig, model_general_apply),
        (Cifar10LowNoiseConfig, cifar10lownoise_apply),
        (TTCertifConfig, tt_certif_apply),
        (ResNetConfig, resnet_apply))},
}


def _family(config) -> Family:
    return _FAMILIES[type(config)]


def _pick_transforms(image_size: int):
    """``(eval, train)`` transforms of an ImageFolder
    (``scale_imagenet_tpu/main.py:639-650``): the ImageNet 256 -> 224
    pipeline for 224^2 models, the CIFAR one for the others."""
    if image_size == 224:
        return imagenet_eval_transform, imagenet_train_transform
    return cifar_eval_transform, cifar_train_transform


def _keyed(forward, stochastic: bool, seed: int):
    """``forward(x, **kw)`` as ``x -> logits``.  A stochastic model
    (``TT_FHE_small``) gets fresh coin flips at every call, the key
    ``NoiseKey(seed).child(call index)``, as the JAX eval step folds a
    per-call counter into ``PRNGKey(seed)`` (``main.py:1129-1138``): a run
    repeats from its seed."""
    if not stochastic:
        return forward
    root, calls = NoiseKey(seed), itertools.count()
    return lambda x: forward(x, noise=root.child(next(calls)))


def _refuse_compile(config) -> None:
    """``--mode compile`` of a conv-only family, ended as the JAX CLI ends
    it on the first block item it compiles: its enumeration error where
    that head has more than 24 bits, else a ``ValueError`` naming the
    crash (``_V1_COMPILE`` and the texts above)."""
    kind = type(config).__name__
    if not hasattr(config, "block_configs"):
        raise ValueError(_COMPILE_CRASH.format(
            kind, "AttributeError",
            f"'{kind}' object has no attribute 'block_configs'"))
    block = config.block_configs()[0]
    if not hasattr(block, "head_cfgs"):
        raise ValueError(_COMPILE_CRASH.format(
            kind, "AttributeError",
            f"'{type(block).__name__}' object has no attribute "
            "'head_cfgs'"))
    heads = block.head_cfgs()
    first = min(heads)
    if first == 0:
        # the CLI looks the head up as ``conv{h}``; the model names it
        # ``conv{h + 1}``
        raise ValueError(_COMPILE_CRASH.format(kind, "KeyError", "'conv0'"))
    head = heads[first]
    kh, kw = (head.k, head.k) if isinstance(head.k, int) else head.k
    n = kh * kw * (head.in_planes // head.groupsici)
    if n > 24:
        raise ValueError(f"n={n} bits: 2^n enumeration infeasible")
    if isinstance(config, TTCertifConfig):
        raise ValueError(_CERTIF_COMPILE.format(config.T_block, _KEYLESS))
    if isinstance(config, TTnetV1Config):
        raise ValueError(_V1_COMPILE)
    raise ValueError(_COMPILE_NO_QUANT.format(
        kind, "'BlockResnetConfig' object has no attribute 'quant'"))


def load_or_compile_luts(model, lut_path: str | None = None):
    """The model's truth tables: loaded from ``lut_path`` when it exists,
    else compiled (2^n patterns a head) and written there if given."""
    family = _family(model.cfg)
    if family.lut_compile is None:
        raise ValueError(_SERVING_FAMILY.format(
            "--lut", type(model.cfg).__name__))
    if lut_path and not lut_path.endswith(".npz"):
        lut_path += ".npz"
    if lut_path and os.path.exists(lut_path):
        print(f"loading LUTs from {lut_path}")
        return load_luts(lut_path, model)
    print("compiling truth tables (2^n patterns per head)...")
    luts = family.lut_compile(model)
    if lut_path:
        save_luts(lut_path, luts, model)
        print(f"saved LUTs -> {lut_path}")
    return luts


def _as_gate_model(model, form: str, gnets=None):
    """The gate-circuit twin of ``model`` (``scale_imagenet_tpu/main.py:445``):
    ``(apply, on_device)``.  The covers are compiled (or taken from
    ``gnets``); the circuit runs on the model's device through the
    ``gate_cubes`` kernel when its covers, as the port holds them there,
    fit ``config.performance.gates_device_budget``, else on the host
    native evaluator.  Either way it is bit-identical to the
    LUT forward on the boolean blocks."""
    family = _family(model.cfg)
    if family.gate_compile is None:
        raise ValueError(_SERVING_FAMILY.format(
            "--gates", type(model.cfg).__name__))
    host_apply, device_apply = family.gate_host, family.gate_device
    if gnets is None:
        print("compiling gate circuits (truth tables -> verified covers)...")
        gnets = family.gate_compile(model)
    print(f"circuit size: {total_gates(gnets):,} gates ({form} form)")
    budget = performance.gates_device_budget
    try:
        if budget <= 0:
            raise ValueError("gates_device_budget <= 0 forces the host "
                             "native evaluator")
        gdevs = build_device_gates(gnets, form, max_cube_bytes=budget,
                                   device=model.stem_conv.weight.device)
    except ValueError as e:
        print(f"gate circuit runs on HOST ({e})")
        return (lambda x: host_apply(gnets, model, x, form=form)), False
    print("gate circuit runs ON DEVICE (bit-sliced int32 cube evaluation, "
          "32 positions/lane)")
    return (lambda x: device_apply(gdevs, model, x)), True


def _compile(cfg, md, model) -> dict:
    """``--mode compile`` (``scale_imagenet_tpu/main.py:809-854``): every
    Block_TT of every multi-head block to its artifacts under
    ``--compile_out`` and ``summary.json``; ``--verilog`` adds the gate
    circuits as Verilog modules.  A block without a fuse head (the VGG-stem
    variant) has no ``convf`` item."""
    if _family(md.config).lut_compile is None:
        _refuse_compile(md.config)
    items = model_block_items(model)
    with table_cache():   # --verilog reuses the tables and covers
        summary = compile_model_truth_tables(
            items, cfg.compile_out, max_minimize_bits=cfg.max_minimize_bits)
        # gate counts are a property of the weights the tables were
        # enumerated from: say which inside the artifact itself
        summary["weights"] = (os.path.basename(cfg.ckpt) if cfg.ckpt
                              else "random-init")
        print(json.dumps(summary, indent=2))
        with open(os.path.join(cfg.compile_out, "summary.json"), "w") as f:
            json.dump(summary, f)
        print(f"total gates: {summary['total_gates']:,}")
        if cfg.verilog:
            vdir = os.path.join(cfg.compile_out, "verilog")
            gnets = _family(md.config).gate_compile(model)
            manifest = export_model_verilog(gnets, vdir, model_name=md.name,
                                            include_cnf=True)
            summary["verilog"] = manifest
            print(f"verilog: {len(manifest['modules'])} modules, "
                  f"{manifest['total_gates']:,} gates -> {vdir}")
    return summary


def apply_serving_transforms(cfg, model, name: str = "") -> str:
    """``--fuse_quant``, ``--fold_bn``, then ``--bf16``, on ``model`` in
    place (``scale_imagenet_tpu/main.py:536-618``; ``parse_args`` has
    refused them with ``--lut`` and ``--gates``).  Returns the served
    name (``+fusedquant`` under ``--fuse_quant``)."""
    if cfg.fuse_quant:
        if not isinstance(model.cfg, ResNetConfig):
            raise ValueError(_FUSE_FAMILY.format(type(model.cfg).__name__))
        wbit = model.cfg.wbit
        if wbit >= 32:
            raise ValueError(_FUSE_FLOAT.format(name, wbit))
        fuse_resnet(model)
        name += "+fusedquant"
        print(f"fuse_quant: offline DoReFa w{wbit} -> serving wbit=32, BNs "
              "folded")
    if cfg.fold_bn:
        print(f"folded {fold_model_bns(model)} conv/BN pairs")
    if cfg.bf16:
        # the floating parameters and buffers; ``_nchw`` casts the images
        # to the stem's dtype, and TF32 stays off for every f32 op
        model.to(torch.bfloat16)
    return name


def _run_dir(cfg, kind: str) -> str:
    """``<root_dir>/<kind>/<log_name>/<date>``, the reference's layout."""
    date = str(datetime.now()).replace(" ", "_").replace("-", "_") \
        .replace(":", "_").replace(".", "_")
    return os.path.join(cfg.root_dir, kind, cfg.log_name, date)


def _val_loader(cfg, shards_dir: str | None, image_size: int):
    """``(loader, normalize)`` of an eval pass: uint8 shards (normalized
    on the device with the ImageNet statistics, at every size, as in the
    JAX package), else the ImageFolder ``<data_dir>/val`` through the
    model's eval transform."""
    bs = cfg.eval_batch_size
    if shards_dir:
        return shard_loader(shards_dir, bs), (IMAGENET_MEAN, IMAGENET_STD)
    ds = ImageFolder(os.path.join(cfg.data_dir, "val"),
                     _pick_transforms(image_size)[0])
    return DataLoader(ds, bs, num_workers=cfg.num_workers), None


def _score(cfg, apply, loader, normalize, device, logger, epoch: int = 0,
           verbose: bool = True):
    """One eval pass (last batch padded and masked): ``(top1, top5,
    loss)``."""
    bs = cfg.eval_batch_size
    feed = device_prefetch(pad_batches(iter(loader), bs), device)
    try:
        return evaluate(make_eval_step(apply, normalize), feed,
                        logger=logger, epoch=epoch,
                        log_interval=cfg.log_interval, verbose=verbose)
    finally:
        feed.close()


def _eval(cfg, apply, device, image_size: int):
    loader, normalize = _val_loader(cfg, cfg.shards_dir, image_size)
    if cfg.shards_dir:
        print(f"eval shards: {len(loader.dataset)} images")
    else:
        print(f"eval dataset: {len(loader.dataset)} images / "
              f"{len(loader.dataset.classes)} classes")
    logger = MetricsLogger(_run_dir(cfg, "logs"))
    try:
        top1, top5, loss = _score(cfg, apply, loader, normalize, device,
                                  logger)
    finally:
        logger.close()
    print(f"final: top1 {top1:.3f}% top5 {top5:.3f}% loss {loss:.4f}")
    return top1, top5, loss


def _train_loader(cfg, image_size: int):
    """``(loader, train-step kwargs)``: shards, with the full augmentation
    on the card from pre-crop shards (stored larger than the model input)
    and the flip alone from same-size ones (the 32x32 models' shards); or
    ``<data_dir>/train`` through the model's PIL train transform, drawn
    from a ``random.Random(seed)``."""
    tbs = cfg.train_batch_size
    if cfg.shards_dir:
        loader = shard_loader(cfg.shards_dir, tbs, drop_last=True,
                              shuffle=True, seed=cfg.seed)
        shard_hw = loader.dataset.meta["shape"][0]
        full = shard_hw > image_size
        if full:
            print(f"on-device augmentation: RandomResizedCrop({shard_hw}"
                  f"->{image_size}) + flip + ColorJitter")
        return loader, dict(normalize=(IMAGENET_MEAN, IMAGENET_STD),
                            augment="full" if full else True)
    transform = functools.partial(_pick_transforms(image_size)[1],
                                  rng=random.Random(cfg.seed))
    ds = ImageFolder(os.path.join(cfg.data_dir, "train"), transform)
    return DataLoader(ds, tbs, shuffle=True, num_workers=cfg.num_workers,
                      drop_last=True, seed=cfg.seed), {}


def _step_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed at ``step``: a resumed run draws
    what an uninterrupted one would."""
    return (seed << 32) + step


def _train(cfg, md, model, device):
    """``--mode train`` (``scale_imagenet_tpu/main.py:1178-1551`` without a
    mesh).  Returns a summary: the steps, the logged train metrics, each
    epoch's validation and the checkpoint dir."""
    if cfg.remat:
        model.cfg = dataclasses.replace(model.cfg, remat=True)
    if cfg.train_batch_size % cfg.grad_accum:
        raise ValueError(f"--grad_accum {cfg.grad_accum}: per-shard batch "
                         f"{cfg.train_batch_size}/1 must be divisible by "
                         "grad_accum")
    size = md.config.image_size
    loader, train_kwargs = _train_loader(cfg, size)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(
            f"0 train steps per epoch: rank 0's data slice is smaller than "
            f"its local batch {cfg.train_batch_size} (world=1; the training "
            "data holds fewer images than one batch (drop_last) — shrink "
            "--train_batch_size or add data)")
    # the reference picks its MultiStepLR milestones by run length
    milestones = (30, 60, 90) if cfg.max_epochs == 90 else (60, 100, 140)
    opt, _ = make_optimizer(cfg.lr, weight_decay=cfg.wd,
                            milestones=milestones,
                            steps_per_epoch=steps_per_epoch,
                            schedule=cfg.lr_schedule,
                            max_epochs=cfg.max_epochs,
                            warmup_epochs=cfg.warmup_epochs)
    if cfg.ema > 0:
        opt = dataclasses.replace(opt, ema=params_ema(cfg.ema))
    if cfg.ckpt:
        load_checkpoint(model, cfg.ckpt, md.name)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    if cfg.ckpt:
        try:
            load_train_state(cfg.ckpt, ts)
            print(f"resumed full train state at step {ts.step}")
        except (FileNotFoundError, KeyError) as e:
            print("checkpoint has no optimizer state "
                  f"({type(e).__name__}: {e}); starting optimizer fresh")
    train_step = make_train_step(model, opt, amp=cfg.amp,
                                 accum=cfg.grad_accum,
                                 label_smooth=cfg.label_smooth,
                                 **train_kwargs)
    logger = MetricsLogger(_run_dir(cfg, "logs"))
    validate = None
    if cfg.eval_shards_dir or (
            cfg.data_dir and os.path.isdir(os.path.join(cfg.data_dir,
                                                        "val"))):
        val = _val_loader(cfg, cfg.eval_shards_dir, size)

        def validate(apply, epoch):
            return _score(cfg, apply, *val, device, logger, epoch,
                          verbose=False)

    ckpt_dir = _run_dir(cfg, "ckpt")
    # best tracking lives at the stable <root>/ckpt/<log_name>/ parent, so
    # it runs across resumed runs
    ckpt = CheckpointManager(ckpt_dir, best_root=os.path.dirname(ckpt_dir))
    conv_apply = _family(model.cfg).conv
    noise_root = NoiseKey(cfg.seed) if md.stochastic else None
    metadata = {"model_name": md.name,
                "config": dataclasses.asdict(model.cfg)}
    generator = torch.Generator(device)
    summary = {"start_step": ts.step, "train": [], "val": [],
               "ckpt_dir": ckpt_dir}
    try:
        for epoch in range(ts.step // steps_per_epoch, cfg.max_epochs):
            loader.set_epoch(epoch)
            feed = device_prefetch(iter(loader), device)
            try:
                for i, (images, labels) in enumerate(feed):
                    generator.manual_seed(_step_seed(cfg.seed, ts.step))
                    # the step's coin flips, keyed by the step: a resumed
                    # run draws what an uninterrupted one would
                    noise = None if noise_root is None else \
                        noise_root.child(f"step{ts.step}")
                    ts, metrics = train_step(ts, images, labels, generator,
                                             noise)
                    if i % cfg.log_interval == 0:
                        loss = float(metrics["loss"])
                        top1 = float(metrics["top1"])
                        step = epoch * steps_per_epoch + i
                        print(f"epoch {epoch} [{i}/{steps_per_epoch}] "
                              f"loss {loss:.4f} top1 {top1:.2f}")
                        logger.add_scalar("Loss/train", loss, step)
                        logger.add_scalar("Accuracy/train", top1, step)
                        summary["train"].append((ts.step, loss, top1))
            finally:
                feed.close()
            metric = None
            if validate is not None:
                row = {"epoch": epoch, "step": ts.step}
                top1, top5, vloss = validate(_keyed(
                    lambda x, **k: conv_apply(model, x, **k),
                    md.stochastic, cfg.seed), epoch)
                print(f"epoch {epoch} val: top1 {top1:.3f}% "
                      f"top5 {top5:.3f}% loss {vloss:.4f}")
                logger.add_scalar("Accuracy/val", top1, epoch)
                row["top1"], row["top5"], row["loss"] = top1, top5, vloss
                metric = top1
                ema = get_ema(ts.opt_state)
                if ema is not None:
                    e1, e5, eloss = validate(_keyed(
                        lambda x, **k: torch.func.functional_call(
                            model, ema, (x,), k), md.stochastic, cfg.seed),
                        epoch)
                    print(f"epoch {epoch} val[ema]: top1 {e1:.3f}% "
                          f"top5 {e5:.3f}% loss {eloss:.4f}")
                    logger.add_scalar("Accuracy/val_ema", e1, epoch)
                    row["ema_top1"] = metric = e1   # the deployable weights
                summary["val"].append(row)
            ckpt.save(ts.step, train_payload(ts), metric=metric,
                      metadata=metadata)
    except (KeyboardInterrupt, Exception):
        # a snapshot of the full train state, so the run resumes from the
        # crash point
        ckpt.save(ts.step, train_payload(ts),
                  metadata={**metadata, "crash": True})
        raise
    finally:
        logger.close()
    summary["step"] = ts.step
    return summary


def main(argv=None, *, serve_ready=None, serve_stop=None):
    """CLI entry.  ``--mode eval`` returns ``(top1, top5, loss)``,
    ``--mode train`` its summary (``_train``), ``--mode compile`` its
    summary (``_compile``).  ``serve_ready``/
    ``serve_stop``: optional events for callers that run the server in a
    thread."""
    cfg = parse_args(argv)
    if cfg.list_models:
        names = list_models()
        print("\n".join(names))
        return names
    if cfg.write_shards:
        crop = imagenet_train_crop_u8 if cfg.shards_split == "train" \
            else imagenet_eval_crop_u8
        src = ImageFolder(os.path.join(cfg.data_dir, cfg.shards_split), crop)
        meta = write_shards(src, cfg.write_shards, shard_size=cfg.shard_size,
                            num_workers=cfg.num_workers)
        print(f"wrote {meta['n']} images -> {cfg.write_shards}")
        return meta
    device = resolve_device(cfg.device)
    md = get_model(cfg.model, **{
        "nfilter": cfg.nfilter, "tfilter": cfg.tfilter, "layers": cfg.layers,
        **parse_model_args(cfg.model_arg)})
    model = md.init(seed=cfg.seed, device=device)
    if cfg.mode == "train":
        if cfg.remat and not isinstance(md.config, TTnetImageNetConfig):
            raise ValueError(_REMAT_FAMILY.format(type(md.config).__name__))
        return _train(cfg, md, model, device)
    if cfg.ckpt:
        load_checkpoint(model, cfg.ckpt, md.name)
    if cfg.mode == "compile":
        return _compile(cfg, md, model)
    if cfg.mode == "export":
        path = save_torch_checkpoint(cfg.export_out, model)
        print(f"wrote reference-compatible checkpoint: {path}")
        return path
    name = apply_serving_transforms(cfg, model, md.name)
    family = _family(model.cfg)
    conv_apply, lut_apply = family.conv, family.lut
    if cfg.gates:
        apply, on_device = _as_gate_model(model, cfg.gates)
        name += "+gates"
        if cfg.mode == "serve" and not on_device:
            raise ValueError(_GATES_ON_HOST)
    elif cfg.lut:
        luts = load_or_compile_luts(model, cfg.lut_path)
        name += "+lut"

        def apply(x):
            return lut_apply(luts, model, x)
    else:
        # fresh coin flips a batch for a stochastic model, from --seed
        apply = _keyed(lambda x, **k: conv_apply(model, x, **k),
                       md.stochastic, cfg.seed)
    size = md.config.image_size
    if cfg.mode == "eval":
        return _eval(cfg, apply, device, size)
    return serve(apply, name, (size, size, 3), device=device,
                 host=cfg.serve_host, port=cfg.port,
                 batch_size=cfg.serve_batch, max_wait_ms=cfg.serve_wait_ms,
                 ready_event=serve_ready, stop_event=serve_stop,
                 transform=_pick_transforms(size)[0])


if __name__ == "__main__":
    main()
