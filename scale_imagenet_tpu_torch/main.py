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
    python -m scale_imagenet_tpu_torch.main --mode eval --model tt_certif \\
        --tfilter 6 --shards_dir D32 --certify 0.004 --attack pgd \\
        --attack_eps 0.03
    python -m scale_imagenet_tpu_torch.main --mode train \\
        --model cifar10lownoise --shards_dir T32 --stability_eps 0.01 \\
        --abstract_eps 0.01 --bias_decay 1e-3
    python -m scale_imagenet_tpu_torch.main --mode eval --data_dir R \\
        --native_data
    python -m scale_imagenet_tpu_torch.main --mode train|eval ... \\
        --num_processes 2 --process_id R --coordinator_address HOST:PORT
    torchrun --nproc_per_node 2 -m scale_imagenet_tpu_torch.main \\
        --mode train|eval ...

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
``--mode eval --certify E`` also reports the certified top-1 (sound
interval bounds over the L-inf ball of radius E in pixel units, for the
models whose registry entries carry ``interval_logits``: ``tt_certif``,
``model_general``, ``cifar10lownoise``) and ``--attack fgsm|pgd
--attack_eps E [--attack_steps N --attack_lr S]`` the top-1 under that
white-box attack (``robust/attack.py``): ``final:`` then carries
``certified@eps=`` and ``adversarial@eps=``.  ``--mode train
--stability_eps E [--stability_coeff C] --abstract_eps E
[--abstract_coeff C] --bias_decay D [--bias_thresh T]`` trains with the
robustness losses, which compose (``train/steps.py::
make_robust_train_step``).
``--native_data`` decodes the ImageFolder of ``--mode eval`` with the native
libjpeg loader (``native/ttdata.py``: the same pixels as the PIL route;
224^2 models only, as in JAX).
``--num_processes N --process_id R --coordinator_address HOST:PORT`` (or
torchrun's environment) runs eval and training data-parallel, one process
a card (``parallel/``): each rank reads its slice of the data (the last
batch padded and masked, filler batches keeping the ranks in lockstep in
eval; every rank cut to the fewest full batches in training), the train
step averages the gradients, the new BN statistics and the metrics over
the ranks once a step, eval sums its metrics over them, and rank 0 alone
prints, logs, writes checkpoints and the LUT archive.  ``--mesh_data``
-1 (``world / mesh_model``) or that; ``--platform`` and ``--cpu_devices`` (the
JAX package's platform and virtual devices) are refused: the device is
``--device``, the ranks ``--num_processes``.

``--mesh_model M`` > 1 lays the ranks out as a (data, model) mesh, the
model axis innermost: the ranks of one data index read the same rows and
draw the same augmentation, and the steps reduce over the data axis only;
without ``--tp`` the model axis's ranks run the plain steps replicated.
``--tp`` (the ttnet_imagenet family) gives each model rank its channel
slice of the weights (``parallel/tp.py``): eval as conv or ``--lut`` (each
rank its slice of the tables), and training with ``--grad_accum`` and
``--ema``, rank 0 writing the gathered checkpoint, the same files a
one-process run writes; it refuses ``--amp``, ``--remat``, robust
training, ``--label_smooth``, ``--gates``, ``--certify``, ``--attack``,
serve, compile and export as the JAX CLI does, and the other families
with a ``ValueError`` naming JAX's crash.  ``--sp`` (every family)
splits the image height over the model axis instead (``parallel/sp.py``,
``parallel/sp_models.py``): each model rank of a data index scores the
same images on its rows, with ``--attack`` and (the three interval
families) ``--certify`` too, a stochastic model flipping the bits the
unsharded run flips from the same ``--seed``, and every rank computes
the whole logits; it refuses ``--tp``, ``--lut``, ``--gates``, a model
axis of 1 and a height that the axis does not divide with the JAX CLI's
texts, and training and compile as the JAX CLI does.  The server is one
process on one card, so ``--mode serve --sp`` meets JAX's checks on a
one-device mesh: ``make_mesh``'s refusal of ``--mesh_model`` > 1, else
the model axis of 1.  The flags that the JAX CLI refuses in a mode
raise with its messages.
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
from .data import CIFAR_MEAN, CIFAR_STD, DataLoader, ImageFolder, \
    IMAGENET_MEAN, IMAGENET_STD, \
    cifar_eval_transform, cifar_train_transform, device_prefetch, \
    imagenet_eval_crop_u8, imagenet_eval_transform, imagenet_train_crop_u8, \
    imagenet_train_transform, pad_batches, shard_loader, write_shards
from .device import resolve_device
from .convert.from_jax import state_dict_from_jax
from .convert.fuse_quant import fuse_resnet
from .convert.torch_import import IMPORTERS
from .native.ttdata import NativeImageFolder
from .parallel import backend, barrier, broadcast_module_, initialize, \
    is_coordinator, local_batch_size, make_mesh, rank_key, rank_seed, \
    requested_world
from .parallel.sp import SP_HEIGHT, row_shard
from .parallel.sp_models import sp_forward
from .parallel.tp import gather_train_payload, local_config, shard_luts, \
    shard_model, shard_train_state, tp_lut_apply
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
from .utils import cast_floating
from .runtime.checkpoint import MODEL_FILE, CheckpointManager, \
    load_train_state, train_payload
from .runtime.evaluate import evaluate
from .runtime.server import serve
from .train import MetricsLogger, TrainState, get_ema, make_eval_step, \
    make_optimizer, make_robust_train_step, make_train_step, params_ema

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
# the JAX CLI takes --attack_lr in training and leaves it unused; the port
# refuses a flag that would do nothing, with the --attack text
_TRAIN_REFUSALS["--attack_lr"] = _TRAIN_REFUSALS["--attack"]
# ``scale_imagenet_tpu/main.py:1242-1266,1385-1388``: robust training with
# the plain step's options
_ROBUST_LABEL_SMOOTH = ("--label_smooth applies to the plain/amp train "
                        "step's CE; the --tp and robust steps use their "
                        "own losses — drop one")
_ROBUST_GRAD_ACCUM = ("--grad_accum is not supported with robust "
                      "training (--stability_eps/--abstract_eps/"
                      "--bias_decay); drop one")
_ROBUST_AMP = ("--amp is not supported with robust (--stability_eps/"
               "--abstract_eps/--bias_decay) training")
# ``scale_imagenet_tpu/main.py:1006-1029``: the eval refusals of
# --certify and --attack
_CERTIFY_WITH = ("--certify propagates float intervals through the "
                 "unmodified f32 model; {} cannot apply")
_ATTACK_WITH = ("--attack differentiates the unmodified f32 model; {} "
                "cannot apply")
_ATTACK_EPS = "--attack needs --attack_eps > 0 (radius in [0,1] pixel units)"
_ATTACK_FLAG = ("--attack_eps/--attack_lr configure --attack fgsm|pgd — add "
                "the flag")

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
# the JAX CLI takes these in compile and leaves them unused; the port
# refuses a flag that would do nothing
_COMPILE_REFUSALS["--attack_lr"] = _COMPILE_REFUSALS["--attack"]
_COMPILE_ROBUST = ("--stability_eps/--abstract_eps/--bias_decay enable "
                   "robust TRAINING (--mode train); compilation evaluates "
                   "the forward only — drop the flag")

# ``scale_imagenet_tpu/main.py:553-556,989-992,1230-1233,1256-1269``: the
# --tp refusals
_FUSE_WITH_TP = ("--tp shards TTnet channel groups; --fuse_quant serves the "
                 "resnet family — drop one")
_GATES_WITH_TP = ("--gates is the HOST circuit runtime; mesh-sharded "
                  "compiled serving is --tp --lut")
_TP_REMAT = ("--tp training runs its own shard_map blocks; --remat applies "
             "to the plain/amp step — drop one")
_TP_AMP = ("--tp training runs f32 (channel-sharded amp is not "
           "implemented); drop --amp")
_TP_ROBUST = ("--tp is not supported with robust training (--stability_eps/"
              "--abstract_eps/--bias_decay); drop one")
_TP_TRAIN_FAMILY = "--tp training supports the ttnet_imagenet family, not {}"
_TP_LUT_FAMILY = ("--tp --lut (mesh-sharded compiled serving) supports the "
                  "ttnet_imagenet family; serve {} with --lut alone")
_TP_CRASH = "crash snapshot skipped: TP state is sharded across processes"
# ``scale_imagenet_tpu/main.py:913-929,1030-1045``: the --sp refusals
_SP_WITH_TP = ("--sp and --tp both shard over the 'model' mesh axis — pick "
               "one")
_SP_COMPILED = ("--sp spatially shards conv math; the compiled serving modes "
                "(--lut/--gates) walk tables per window — drop one")
_SP_MODEL_AXIS = ("--sp shards image height over the 'model' axis; run with "
                  "--mesh_model>1")

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
_PLATFORM = ("--platform/--cpu_devices pick the JAX package's platform and "
             "its virtual CPU devices; the port runs one process a device: "
             "pick the device with --device (cuda or cpu) and the ranks "
             "with --num_processes — drop the flag")
# ``scale_imagenet_tpu/main.py:1003-1005,1076-1081``
_GATES_WORLD = ("--gates is a single-host verification runtime; drop "
                "--num_processes")
_NATIVE_SIZE = ("--native_data is the 256->224 ImageNet decode pipeline; "
                "this model's resolution needs the PIL path")
# the port's own rules: flags that would do nothing where they are given
_NATIVE_SHARDS = ("--native_data decodes the JPEGs of --data_dir; "
                  "--shards_dir holds decoded images — drop one")
_ONE_PROCESS = "--{} runs in one process on one device; {} does not apply"
_JOIN_ALONE = ("--coordinator_address/--process_id join a run of several "
               "processes; give --num_processes N > 1 (or torchrun's "
               "WORLD_SIZE)")

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
    p.add_argument("--stability_eps", type=float, default=0.0,
                   help="enable robust training: multi-sample stability "
                        "loss at this perturbation radius")
    p.add_argument("--stability_coeff", type=float, default=1e-4)
    p.add_argument("--abstract_eps", type=float, default=0.0,
                   help="interval-arithmetic stabilization loss "
                        "(compute_act_stabilizing_loss_abstract, "
                        "netbin.py:726-738): eps-ball radius propagated "
                        "by abstract interpretation (cifar10lownoise "
                        "family)")
    p.add_argument("--abstract_coeff", type=float, default=1e-4,
                   help="weight of the abstract stabilization loss "
                        "(active when --abstract_eps > 0)")
    p.add_argument("--bias_decay", type=float, default=0.0,
                   help="BiasRegularizer coefficient ('cardinality bound "
                        "decay', netbin.py:786-864) over stats_bn "
                        "(scale, bias) internals")
    p.add_argument("--bias_thresh", type=float, default=6.0,
                   help="BiasRegularizer threshold: penalize "
                        "-bias/scale above this bound")
    p.add_argument("--certify", type=float, default=0.0,
                   help="certified eval: also report certified top-1 %% "
                        "under an L-inf eps-ball of this radius in [0,1] "
                        "pixel units — sound interval bound propagation "
                        "through the WHOLE model to the logits "
                        "(tt_certif / cifar10lownoise / model_general "
                        "families)")
    p.add_argument("--attack", choices=["fgsm", "pgd"], default=None,
                   help="adversarial eval: also report top-1 %% under a "
                        "white-box L-inf attack of radius --attack_eps "
                        "(robust/attack.py; gradients via the training "
                        "STE surrogates).  Composes with --certify: "
                        "cert <= adv <= clean")
    p.add_argument("--attack_eps", type=float, default=0.0,
                   help="attack radius in [0,1] pixel units")
    p.add_argument("--attack_steps", type=int, default=10,
                   help="PGD iterations")
    p.add_argument("--attack_lr", type=float, default=0.0,
                   help="PGD step size in pixel units (default eps/4)")
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
    p.add_argument("--native_data", action="store_true",
                   help="--mode eval: decode the ImageFolder with the native "
                        "libjpeg loader (native/ttdata.cpp; the same pixels "
                        "as the PIL route, 224^2 models)")
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel axis over the ranks: -1 (every rank) "
                        "or the world (one process a card)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel axis over the ranks (the model axis "
                        "innermost: rank r at data r // M, model r % M); "
                        "without --tp its ranks run replicated")
    p.add_argument("--tp", action="store_true",
                   help="channel-group tensor parallelism over the model "
                        "axis (ttnet_imagenet family): eval (conv, --lut) "
                        "and training, each rank holding its channel slice")
    p.add_argument("--sp", action="store_true",
                   help="spatial partitioning over the model axis "
                        "(eval, every family; --attack, --certify): each "
                        "model rank holds rows of every image")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0's rendezvous (tcp://)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="the number of processes (ranks), one a card")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--platform", type=str, default=None,
                   help="the JAX CLI's platform: refused here (--device)")
    p.add_argument("--cpu_devices", type=int, default=None,
                   help="the JAX CLI's virtual CPU devices: refused here "
                        "(--num_processes)")
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
    if args.platform or args.cpu_devices:
        raise ValueError(_PLATFORM)
    # set by ``main`` once the process group is joined: the rank, the
    # world, the mesh and the rank's data index and data axis size
    args.rank, args.world = 0, 1
    args.mesh, args.shard, args.shards = make_mesh(1, 1), 0, 1
    world = requested_world(args.num_processes)
    if world <= 1 and (args.coordinator_address
                       or args.process_id is not None):
        raise ValueError(_JOIN_ALONE)
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
    robust_flags = {"--stability_eps": args.stability_eps > 0,
                    "--abstract_eps": args.abstract_eps > 0,
                    "--bias_decay": args.bias_decay > 0}
    robust_train = any(robust_flags.values())
    eval_flags = {"--certify": args.certify > 0,
                  "--attack": bool(args.attack),
                  "--attack_eps": args.attack_eps > 0,
                  "--attack_lr": args.attack_lr > 0}
    serving_flags = {"--lut": args.lut, "--gates": bool(args.gates),
                     "--fold_bn": args.fold_bn, "--bf16": args.bf16,
                     "--fuse_quant": args.fuse_quant}
    if args.mode == "eval":
        _refuse_in_eval(args, training_flags, robust_train, world)
    if args.mode == "serve":
        # ``scale_imagenet_tpu/main.py:862-880``, in its order
        for flag, on in {"--tp": args.tp, "--amp": args.amp, **eval_flags,
                         **robust_flags,
                         "--shards_dir": args.shards_dir is not None,
                         "--native_data": args.native_data,
                         **training_flags,
                         "--num_processes": world > 1}.items():
            if on:
                raise ValueError(f"--mode serve is single-host inference "
                                 f"serving; {flag} does not apply")
    if args.mode == "train":
        _refuse_in_train(args, unknown, robust_train)
    if args.mode in ("compile", "export") or args.write_shards:
        what = "write_shards" if args.write_shards else f"mode {args.mode}"
        for flag, on in (("--mesh_data", args.mesh_data != -1),
                         ("--native_data", args.native_data
                          and args.mode == "compile"),
                         ("--num_processes", world > 1
                          and args.mode != "export")):
            if on:
                raise ValueError(_ONE_PROCESS.format(what, flag))
    if args.mode == "compile":
        given = {f for f, on in {**training_flags, **eval_flags}.items()
                 if on} | {f.split("=")[0] for f in unknown}
        for flag in ("--gates", "--fold_bn", "--fuse_quant"):
            if serving_flags[flag]:
                given.add(flag)
        given |= {f for f, on in (("--tp", args.tp), ("--sp", args.sp))
                  if on}
        for flag, refusal in _COMPILE_REFUSALS.items():
            if flag in given:
                raise ValueError(refusal)
        if args.bf16:
            raise ValueError(_COMPILE_WITH_BF16)
        if robust_train:
            raise ValueError(_COMPILE_ROBUST)
    if args.mode == "export":
        # ``scale_imagenet_tpu/main.py:743-770``, for the flags the port has
        for flag, on in {**serving_flags, "--tp": args.tp, "--sp": args.sp,
                         **training_flags, **eval_flags, **robust_flags,
                         "--shards_dir": args.shards_dir is not None,
                         "--native_data": args.native_data,
                         "--num_processes": world > 1}.items():
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
    if args.mode == "serve" and args.sp:
        # one process on one card: ``scale_imagenet_tpu/main.py:909-929``
        # on a one-device mesh
        make_mesh(args.mesh_data, args.mesh_model, 1)
        raise ValueError(_SP_COMPILED if args.lut or args.gates
                         else _SP_MODEL_AXIS)
    if args.fuse_quant:
        if args.fold_bn:
            raise ValueError(_FUSE_WITH_FOLD)
        if args.lut or args.gates:
            raise ValueError(_FUSE_WITH_COMPILED)
        if args.tp:
            raise ValueError(_FUSE_WITH_TP)
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
    if args.native_data and args.shards_dir and args.mode == "eval":
        raise ValueError(_NATIVE_SHARDS)
    return args


def _refuse_in_eval(args, training_flags: dict, robust_train: bool,
                    world: int) -> None:
    """The JAX CLI's eval refusals (``scale_imagenet_tpu/main.py:959-1045``)
    in its order, for the flags the port has."""
    ordered = {"--amp": training_flags["--amp"],
               "--stability_eps": robust_train,
               **{f: on for f, on in training_flags.items() if f != "--amp"}}
    for flag, on in ordered.items():
        if on:
            raise ValueError(_EVAL_REFUSALS[flag])
    if args.gates:
        if args.lut:
            raise ValueError(_GATES_WITH_LUT)
        if args.tp:
            raise ValueError(_GATES_WITH_TP)
        if args.bf16:
            raise ValueError(_GATES_WITH_BF16)
        if args.fold_bn:
            raise ValueError(_GATES_WITH_FOLD)
        if world > 1:
            raise ValueError(_GATES_WORLD)
    unmodified = (("--lut", args.lut), ("--gates", args.gates),
                  ("--bf16", args.bf16), ("--fold_bn", args.fold_bn),
                  ("--tp", args.tp))
    if args.certify > 0:
        for flag, on in unmodified:
            if on:
                raise ValueError(_CERTIFY_WITH.format(flag))
    if args.attack:
        if args.attack_eps <= 0:
            raise ValueError(_ATTACK_EPS)
        for flag, on in unmodified:
            if on:
                raise ValueError(_ATTACK_WITH.format(flag))
    elif args.attack_eps > 0 or args.attack_lr > 0:
        raise ValueError(_ATTACK_FLAG)
    if args.sp:
        if args.tp:
            raise ValueError(_SP_WITH_TP)
        if args.lut or args.gates:
            raise ValueError(_SP_COMPILED)
        if args.mesh_model == 1:
            raise ValueError(_SP_MODEL_AXIS)


def _refuse_in_train(args, unknown: list, robust_train: bool) -> None:
    """The JAX CLI's train refusals (``scale_imagenet_tpu/main.py:1184-1266,
    1385-1388``) in its order, for the flags the port has; those that need
    the model (``--remat``'s and ``--tp``'s family) follow in ``main``."""
    named = {f.split("=")[0] for f in unknown}
    given = {"--lut": args.lut, "--gates": bool(args.gates),
             "--certify": args.certify > 0,
             "--attack": bool(args.attack) or args.attack_eps > 0,
             "--attack_lr": args.attack_lr > 0, "--bf16": args.bf16,
             "--native_data": args.native_data,
             "--fold_bn": args.fold_bn, "--fuse_quant": args.fuse_quant,
             "--sp": args.sp or "--sp" in named}
    for flag, on in given.items():
        if on:
            raise ValueError(_TRAIN_REFUSALS[flag])
    if args.label_smooth > 0 and (args.tp or robust_train):
        raise ValueError(_ROBUST_LABEL_SMOOTH)
    if robust_train and args.grad_accum > 1:
        raise ValueError(_ROBUST_GRAD_ACCUM)
    if args.tp:
        if args.amp:
            raise ValueError(_TP_AMP)
        if robust_train:
            raise ValueError(_TP_ROBUST)
    if robust_train and args.amp:
        raise ValueError(_ROBUST_AMP)


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


def _keyed(forward, stochastic: bool, seed: int, rank: int = 0,
           world: int = 1):
    """``forward(x, **kw)`` as ``x -> logits``.  A stochastic model
    (``TT_FHE_small``) gets fresh coin flips at every call, the key
    ``NoiseKey(seed).child(call index)``, as the JAX eval step folds a
    per-call counter into ``PRNGKey(seed)`` (``main.py:1129-1138``): a run
    repeats from its seed.  Each of several ranks keys its own flips
    (``rank_key``)."""
    if not stochastic:
        return forward
    root, calls = rank_key(NoiseKey(seed), rank, world), itertools.count()
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
    else compiled (2^n patterns a head) and written there if given, by the
    coordinator only (ranks racing one archive would tear it,
    ``scale_imagenet_tpu/main.py:370-394``).  With several ranks every
    rank looks for the archive before any rank writes it (a barrier), so
    that none reads a half-written file."""
    family = _family(model.cfg)
    if family.lut_compile is None:
        raise ValueError(_SERVING_FAMILY.format(
            "--lut", type(model.cfg).__name__))
    if lut_path and not lut_path.endswith(".npz"):
        lut_path += ".npz"
    found = bool(lut_path) and os.path.exists(lut_path)
    barrier()
    if found:
        print(f"loading LUTs from {lut_path}")
        return load_luts(lut_path, model)
    print("compiling truth tables (2^n patterns per head)...")
    luts = family.lut_compile(model)
    if lut_path and is_coordinator():
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
        cast_floating(model)
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
    model's eval transform, or decoded by the native loader under
    ``--native_data``.  Each data index reads its slice (the ranks of one
    model group the same rows), at its local batch, padded to the same
    number of batches as every other's."""
    bs = _per_shard(cfg.eval_batch_size, cfg, "eval")
    if shards_dir:
        return shard_loader(shards_dir, bs, rank=cfg.shard,
                            world=cfg.shards), (IMAGENET_MEAN, IMAGENET_STD)
    root = os.path.join(cfg.data_dir, "val")
    if cfg.native_data:
        if image_size != 224:
            raise ValueError(_NATIVE_SIZE)
        ds = NativeImageFolder(root)
    else:
        ds = ImageFolder(root, _pick_transforms(image_size)[0])
    return DataLoader(ds, bs, num_workers=cfg.num_workers, rank=cfg.shard,
                      world=cfg.shards), None


def _per_shard(batch: int, cfg, what: str) -> int:
    """A data index's share of a global batch: the JAX CLI's message over
    the processes when every rank is a data index, ``local_batch_size``'s
    over the data axis otherwise."""
    if cfg.shards == cfg.world and batch % cfg.world:
        raise ValueError(f"{what} batch {batch} not divisible by "
                         f"{cfg.world} processes")
    return local_batch_size(batch, cfg.mesh)


def _score(cfg, apply, loader, normalize, device, logger, epoch: int = 0,
           verbose: bool = True, totals: dict | None = None, **step):
    """One eval pass (last batch padded and masked): ``(top1, top5,
    loss)``, and the robust extras as a fourth item when ``step``
    (``make_eval_step``'s keywords) asks for them; over every rank."""
    bs = cfg.eval_batch_size // cfg.shards
    feed = device_prefetch(pad_batches(iter(loader), bs), device)
    try:
        return evaluate(make_eval_step(apply, normalize, **step), feed,
                        logger=logger, epoch=epoch,
                        log_interval=cfg.log_interval, verbose=verbose,
                        totals=totals, group=cfg.mesh.data_group)
    finally:
        feed.close()


def _eval(cfg, apply, device, md, model, noise=None):
    """``--mode eval``: ``(top1, top5, loss)``, and under ``--certify`` or
    ``--attack`` a fourth item, ``{"cert": ..., "adv": ...}``, whose tags
    ``final:`` prints as the JAX CLI does (``main.py:1162-1169``)."""
    image_size = md.config.image_size
    coord = cfg.rank == 0
    loader, normalize = _val_loader(cfg, cfg.shards_dir, image_size)
    if cfg.shards_dir:
        if coord:
            print(f"eval shards: {len(loader.dataset)} images")
        certify_stats = normalize
    else:
        if coord:
            print(f"eval dataset: {len(loader.dataset)} images / "
                  f"{len(loader.dataset.classes)} classes")
        # the ball in pixel units through the transform's normalization
        certify_stats = (IMAGENET_MEAN, IMAGENET_STD) if image_size == 224 \
            else (CIFAR_MEAN, CIFAR_STD)
    attack = None
    if cfg.attack:
        attack = {"kind": cfg.attack, "eps": cfg.attack_eps,
                  "steps": cfg.attack_steps,
                  "step_size": cfg.attack_lr or None}
    # logs are the coordinator's (``scale_imagenet_tpu/main.py:952-954``)
    logger = MetricsLogger(_run_dir(cfg, "logs")) if coord else None
    totals: dict = {}
    try:
        res = _score(cfg, apply, loader, normalize, device, logger,
                     verbose=coord, totals=totals, noise=noise, md=md,
                     model=model, certify_eps=cfg.certify,
                     certify_stats=certify_stats, attack=attack,
                     mesh=cfg.mesh, spatial=cfg.sp)
        top1, top5, loss = res[:3]
        extras = res[3] if len(res) > 3 else {}
        tags = {"cert": f"certified@eps={cfg.certify:g}",
                "adv": f"adversarial@eps={cfg.attack_eps:g}"}
        if logger is not None:
            for k, v in extras.items():
                logger.add_scalar(f"Accuracy/{tags[k]}", v, 0)
    finally:
        if logger is not None:
            logger.close()
    if coord:
        print(f"scored {totals['images']} images"
              + (f" over {cfg.world} ranks" if cfg.world > 1 else ""))
        print(f"final: top1 {top1:.3f}% top5 {top5:.3f}% loss {loss:.4f}"
              + "".join(f" {tags[k]} {v:.3f}%" for k, v in extras.items()))
    if extras:
        return top1, top5, loss, extras
    return top1, top5, loss


def _train_loader(cfg, image_size: int, tbs: int):
    """``(loader, train-step kwargs)`` at the local batch ``tbs``: shards,
    with the full augmentation on the card from pre-crop shards (stored
    larger than the model input) and the flip alone from same-size ones
    (the 32x32 models' shards); or ``<data_dir>/train`` through the
    model's PIL train transform, drawn from a ``random.Random`` of the
    seed (and of the data index, with several).  Each data index reads its
    slice (the ranks of one model group the same rows), cut to the fewest
    full batches of any."""
    rank, world = cfg.shard, cfg.shards
    if cfg.shards_dir:
        loader = shard_loader(cfg.shards_dir, tbs, drop_last=True,
                              shuffle=True, seed=cfg.seed, rank=rank,
                              world=world)
        shard_hw = loader.dataset.meta["shape"][0]
        full = shard_hw > image_size
        if full and cfg.rank == 0:
            print(f"on-device augmentation: RandomResizedCrop({shard_hw}"
                  f"->{image_size}) + flip + ColorJitter")
        return loader, dict(normalize=(IMAGENET_MEAN, IMAGENET_STD),
                            augment="full" if full else True)
    transform = functools.partial(
        _pick_transforms(image_size)[1],
        rng=random.Random(rank_seed(cfg.seed, rank, world)))
    ds = ImageFolder(os.path.join(cfg.data_dir, "train"), transform)
    return DataLoader(ds, tbs, shuffle=True, num_workers=cfg.num_workers,
                      drop_last=True, seed=cfg.seed, rank=rank,
                      world=world), {}


def _step_seed(seed: int, step: int, rank: int = 0, world: int = 1) -> int:
    """The augmentation generator's seed at ``step``: a resumed run draws
    what an uninterrupted one would, and each of several ranks draws its
    own (``rank_seed``)."""
    return rank_seed((seed << 32) + step, rank, world)


def _train(cfg, md, model, device):
    """``--mode train`` (``scale_imagenet_tpu/main.py:1178-1551``; with
    several ranks its data-parallel step, and under ``--tp`` its
    tensor-parallel one).  Returns a summary: the steps, the logged train
    metrics, each epoch's validation and the checkpoint dir."""
    rank, world, mesh = cfg.rank, cfg.world, cfg.mesh
    shard, shards = cfg.shard, cfg.shards
    coord = rank == 0
    if cfg.remat:
        model.cfg = dataclasses.replace(model.cfg, remat=True)
    local_tbs = _per_shard(cfg.train_batch_size, cfg, "train")
    # one card a process: a rank's batch is its one shard's
    if local_tbs % cfg.grad_accum:
        raise ValueError(f"--grad_accum {cfg.grad_accum}: per-shard batch "
                         f"{local_tbs}/1 must be divisible by grad_accum")
    size = md.config.image_size
    loader, train_kwargs = _train_loader(cfg, size, local_tbs)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        # ``scale_imagenet_tpu/main.py:1310-1320``
        hint = ("multi-process shard training needs >= 1 shard FILE per "
                "rank (round-robin assignment + lockstep truncation) — "
                "rewrite with a smaller --shard_size, or shrink "
                "--train_batch_size") if cfg.shards_dir else \
            ("the train/ directory holds fewer images than one batch "
             "(drop_last) — shrink --train_batch_size or add data")
        raise ValueError(
            f"0 train steps per epoch: rank {rank}'s data slice is "
            f"smaller than its local batch {local_tbs} (world={world}; "
            + hint + ")")
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
    # every rank starts from rank 0's weights and statistics
    broadcast_module_(model)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    if cfg.ckpt:
        try:
            load_train_state(cfg.ckpt, ts)
            print(f"resumed full train state at step {ts.step}")
        except (FileNotFoundError, KeyError) as e:
            print("checkpoint has no optimizer state "
                  f"({type(e).__name__}: {e}); starting optimizer fresh")
    metadata = {"model_name": md.name,
                "config": dataclasses.asdict(model.cfg)}
    if cfg.tp:
        # channel-group tensor parallelism: each rank keeps its slice of
        # the weights, momentum and EMA (``shard_train_state_tp``)
        model, opt_state = shard_train_state(model, ts.opt_state, mesh)
        ts = TrainState(model, opt_state, ts.step)
    robust = cfg.stability_eps > 0 or cfg.abstract_eps > 0 \
        or cfg.bias_decay > 0
    if robust:
        if not cfg.shards_dir:
            # the ImageFolder path normalizes on the host: the eps-ball
            # clamps take the real input range (``main.py:1389-1397``)
            train_kwargs = dict(input_bounds=(
                (0.0 - IMAGENET_MEAN) / IMAGENET_STD,
                (1.0 - IMAGENET_MEAN) / IMAGENET_STD))
        train_step = make_robust_train_step(
            md, model, opt, cfg.stability_eps, cfg.stability_coeff,
            abstract_eps=cfg.abstract_eps,
            abstract_coeff=cfg.abstract_coeff if cfg.abstract_eps > 0
            else 0.0,
            bias_coeff=cfg.bias_decay, bias_thresh=cfg.bias_thresh,
            group=mesh.data_group, **train_kwargs)
    else:
        # under --tp the same step over the rank's slice (the TP step of
        # ``scale_imagenet_tpu/parallel/tp.py:257-379``): its forward sums
        # the classifier over the model group
        train_step = make_train_step(model, opt, amp=cfg.amp,
                                     accum=cfg.grad_accum,
                                     label_smooth=cfg.label_smooth,
                                     group=mesh.data_group, **train_kwargs)
    # logs and checkpoints are the coordinator's
    # (``scale_imagenet_tpu/main.py:1410-1415,1545-1555``)
    logger = MetricsLogger(_run_dir(cfg, "logs")) if coord else None
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
    ckpt = CheckpointManager(ckpt_dir, best_root=os.path.dirname(
        ckpt_dir)) if coord else None

    def payload():
        """The whole train state: under --tp gathered from the model
        group's slices, a collective every rank joins
        (``scale_imagenet_tpu/main.py:1470-1486``)."""
        return gather_train_payload(ts, mesh) if cfg.tp \
            else train_payload(ts)

    conv_apply = _family(model.cfg).conv
    # the TP forward is the local model's own (its classifier sums over the
    # model group)
    forward = model if cfg.tp else functools.partial(conv_apply, model)
    # a step's key: the coin flips of a stochastic forward, and the robust
    # step's sign pattern; each data index its own
    noise_root = rank_key(NoiseKey(cfg.seed), shard, shards) \
        if md.stochastic or robust else None
    generator = torch.Generator(device)
    summary = {"start_step": ts.step, "train": [], "val": [],
               "ckpt_dir": ckpt_dir}
    try:
        for epoch in range(ts.step // steps_per_epoch, cfg.max_epochs):
            loader.set_epoch(epoch)
            feed = device_prefetch(iter(loader), device)
            try:
                for i, (images, labels) in enumerate(feed):
                    generator.manual_seed(_step_seed(cfg.seed, ts.step,
                                                     shard, shards))
                    # the step's coin flips, keyed by the step: a resumed
                    # run draws what an uninterrupted one would
                    noise = None if noise_root is None else \
                        noise_root.child(f"step{ts.step}")
                    ts, metrics = train_step(ts, images, labels, generator,
                                             noise)
                    if i % cfg.log_interval == 0:
                        # every rank reads the metrics (the means over
                        # the ranks), the coordinator logs them
                        loss = float(metrics["loss"])
                        top1 = float(metrics["top1"])
                        step = epoch * steps_per_epoch + i
                        row = (ts.step, loss, top1)
                        more = ""
                        if "stability_loss" in metrics:
                            sloss = float(metrics["stability_loss"])
                            row += (sloss,)
                            more = f" stability_loss {sloss:.4f}"
                            if coord:
                                logger.add_scalar("Loss/stability", sloss,
                                                  step)
                        if coord:
                            print(f"epoch {epoch} [{i}/{steps_per_epoch}] "
                                  f"loss {loss:.4f} top1 {top1:.2f}{more}")
                            logger.add_scalar("Loss/train", loss, step)
                            logger.add_scalar("Accuracy/train", top1, step)
                        summary["train"].append(row)
            finally:
                feed.close()
            metric = None
            if validate is not None:
                row = {"epoch": epoch, "step": ts.step}
                top1, top5, vloss = validate(_keyed(
                    forward, md.stochastic, cfg.seed, shard, shards), epoch)
                if coord:
                    print(f"epoch {epoch} val: top1 {top1:.3f}% "
                          f"top5 {top5:.3f}% loss {vloss:.4f}")
                    logger.add_scalar("Accuracy/val", top1, epoch)
                row["top1"], row["top5"], row["loss"] = top1, top5, vloss
                metric = top1
                ema = get_ema(ts.opt_state)
                if ema is not None:
                    e1, e5, eloss = validate(_keyed(
                        lambda x, **k: torch.func.functional_call(
                            model, ema, (x,), k), md.stochastic, cfg.seed,
                        shard, shards), epoch)
                    if coord:
                        print(f"epoch {epoch} val[ema]: top1 {e1:.3f}% "
                              f"top5 {e5:.3f}% loss {eloss:.4f}")
                        logger.add_scalar("Accuracy/val_ema", e1, epoch)
                    row["ema_top1"] = metric = e1   # the deployable weights
                summary["val"].append(row)
            if ckpt is not None or cfg.tp:
                state = payload()
            if ckpt is not None:
                ckpt.save(ts.step, state, metric=metric, metadata=metadata)
        # no rank returns before the coordinator's last checkpoint is
        # written
        barrier()
    except (KeyboardInterrupt, Exception):
        # a snapshot of the full train state, so the run resumes from the
        # crash point; under --tp over several ranks the gather is a
        # collective that a crashed peer would deadlock
        if ckpt is not None:
            if cfg.tp and mesh["model"] > 1:
                print(_TP_CRASH)
            else:
                ckpt.save(ts.step, payload(),
                          metadata={**metadata, "crash": True})
        raise
    finally:
        if logger is not None:
            logger.close()
    summary["step"] = ts.step
    return summary


def _tp_forward(cfg, model):
    """``--tp`` eval's forward (``scale_imagenet_tpu/main.py:1099-1125``):
    the rank's channel slice of ``model`` (``parallel/tp.py``), as conv or,
    under ``--lut``, over its slice of the whole tables (compiled or
    loaded whole on every rank, the archive written by rank 0 alone)."""
    mesh = cfg.mesh
    if cfg.lut and not isinstance(model.cfg, TTnetImageNetConfig):
        raise ValueError(_TP_LUT_FAMILY.format(type(model.cfg).__name__))
    local_config(model.cfg, mesh["model"])
    local = shard_model(model, mesh["model"], mesh.model_index,
                        mesh.model_group)
    if not cfg.lut:
        return local
    luts = shard_luts(load_or_compile_luts(model, cfg.lut_path), local)
    return functools.partial(tp_lut_apply, luts, local)


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
    # the process group (and each rank's card) before any other CUDA call
    cfg.rank, cfg.world, device = initialize(
        cfg.coordinator_address, cfg.num_processes, cfg.process_id,
        resolve_device(cfg.device))
    md = get_model(cfg.model, **{
        "nfilter": cfg.nfilter, "tfilter": cfg.tfilter, "layers": cfg.layers,
        **parse_model_args(cfg.model_arg)})
    if cfg.sp and cfg.mode == "eval":
        # ``scale_imagenet_tpu/main.py:1042-1045``, before a mesh that one
        # process cannot hold
        size = getattr(md.config, "image_size", 224)
        if size % cfg.mesh_model:
            raise ValueError(SP_HEIGHT.format(size, cfg.mesh_model))
    # the mesh over the ranks, the model axis innermost; a rank reads the
    # rows of its data index
    if cfg.mode in ("eval", "train"):
        cfg.mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, cfg.world,
                             cfg.rank)
        if cfg.rank == 0:
            # ``scale_imagenet_tpu/main.py:948-951``
            print(f"mesh: {cfg.mesh} over {cfg.world} devices"
                  + (f" / {cfg.world} processes ({backend()})"
                     if cfg.world > 1 else ""))
        if cfg.mode == "eval":
            local_batch_size(cfg.eval_batch_size, cfg.mesh)
    elif cfg.mode == "serve":
        # one process, one card
        make_mesh(cfg.mesh_data, cfg.mesh_model, 1)
    cfg.shard, cfg.shards = cfg.mesh.data_index, cfg.mesh["data"]
    model = md.init(seed=cfg.seed, device=device)
    if cfg.mode == "train":
        if cfg.remat and not isinstance(md.config, TTnetImageNetConfig):
            raise ValueError(_REMAT_FAMILY.format(type(md.config).__name__))
        if cfg.tp:
            if cfg.remat:
                raise ValueError(_TP_REMAT)
            if not isinstance(md.config, TTnetImageNetConfig):
                raise ValueError(_TP_TRAIN_FAMILY.format(
                    type(md.config).__name__))
            local_config(md.config, cfg.mesh["model"])
        return _train(cfg, md, model, device)
    if cfg.ckpt:
        load_checkpoint(model, cfg.ckpt, md.name)
    # every rank serves rank 0's weights
    broadcast_module_(model)
    if cfg.mode == "compile":
        return _compile(cfg, md, model)
    if cfg.mode == "export":
        path = save_torch_checkpoint(cfg.export_out, model)
        print(f"wrote reference-compatible checkpoint: {path}")
        return path
    name = apply_serving_transforms(cfg, model, md.name)
    family = _family(model.cfg)
    conv_apply, lut_apply = family.conv, family.lut
    if cfg.tp:
        return _eval(cfg, _tp_forward(cfg, model), device, md, model)
    # fresh coin flips a batch for a stochastic model, from --seed: the eval
    # step keys batch i with NoiseKey(seed).child(i), each data index from
    # its own root (every model rank of one data index the same)
    noise = rank_key(NoiseKey(cfg.seed), cfg.shard, cfg.shards) \
        if md.stochastic else None
    if cfg.sp:
        return _eval(cfg, sp_forward(model, row_shard(cfg.mesh)), device,
                     md, model, noise)
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
        def forward(x, **k):
            return conv_apply(model, x, **k)
        if cfg.mode == "eval":
            return _eval(cfg, forward, device, md, model, noise)
        apply = _keyed(forward, md.stochastic, cfg.seed)
    size = md.config.image_size
    if cfg.mode == "eval":
        return _eval(cfg, apply, device, md, model)
    return serve(apply, name, (size, size, 3), device=device,
                 host=cfg.serve_host, port=cfg.port,
                 batch_size=cfg.serve_batch, max_wait_ms=cfg.serve_wait_ms,
                 ready_event=serve_ready, stop_event=serve_stop,
                 transform=_pick_transforms(size)[0])


if __name__ == "__main__":
    main()
