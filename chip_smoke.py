"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--batch 256] [--out_dir build/chip_smoke]

Drives the port's main paths on the flagship TTnet-Small (p = 64,
--layers 1, 224x224): served as its compiled truth tables over HTTP,
evaluated from uint8 shards (``--mode eval``, conv and ``--lut``, with the
fused pointwise kernel on, and under the serving transforms ``--bf16`` and
``--fold_bn``), exported (``--mode export``), compiled to gate circuits and
evaluated as them (``--mode compile``, ``--mode eval --gates dnf|cnf``),
attacked (``--attack fgsm|pgd``) and trained from uint8 pre-crop shards
(``--mode train``); the VGG16-stem
variant at full width as conv, tables and gate circuit (eval, serve,
compile) and in training; the v2 variant at full width (eval, serve,
train; its k=1 blocks through the fused kernel at ci = 32); the TT_FHE
family at full width on 32x32 inputs as conv, tables and circuit (eval,
serve, compile) and in training, the noisy ``TT_FHE_small`` among them;
the v1 family's ``TT_vf_19lv2_imgnet`` at full width (eval, serve,
train) with one forward of each other v1 model; and the rest of the
registry's families at their widths (TT_general, the CIFAR zoo with
``tt_certif``, the DoReFa ResNets: eval, serve, train), and the robust
models certified, attacked and trained with the robustness losses; the
flagship's eval and training data-parallel over two rank processes on the
one card (``--num_processes 2``, gloo), tensor-parallel over them
(``--mesh_model 2 --tp``) and with the image height split over them
(``--mesh_model 2 --sp``, attacked too, beside a model of every other
family, ``--certify`` and keyed coin flips), served over two replicas
in one process (``--mesh_data 2``, ``--mesh_model 2 --sp``, ``--lut``,
``--gates``), and its ImageFolder eval through the native decoder
(``--native_data``) where libjpeg and Pillow exist.  It holds every CUDA
kernel against its plain PyTorch version.
Phases, each printing one line of its numbers:

1. setup:  build every CUDA source (one nvcc each, all started together);
           ptxas's registers, spills and shared memory for every
           instantiation of the fused kernel, and the HMMA instructions
           of each in ``cuobjdump -sass`` (every tensor-core
           instantiation must have them); build the flagship from --seed
           with its BN running statistics perturbed, compile its truth
           tables;
2. kernels: every LUT window launch of one B=256 table-exact LUT forward
           (8 ``lut_window_bits``, 1 ``lut_window_float``), captured with
           its real input bits, through the kernel and the plain version:
           equal outputs with the bits in bf16 and in f32; times of the
           kernel, the plain version, the chain the kernel replaces (the
           index conv, then the library lookup) and the library lookup
           alone (``torch.take``); the bound;
3. model:  conv vs LUT forward at B=256: per-block bit mismatches, top-1
           agreement (>= 99 %), logits through the kernels == the plain
           versions' (default and table-exact), the table-exact variant
           (one float launch a forward) within 1e-4 of the default;
4. serve:  ``python -m scale_imagenet_tpu_torch.main --mode serve --lut``
           in a thread, concurrent raw-f32 requests, each top-5 equal to a
           direct forward's; launch counts of this run;
5. fused_kernels: the 6 fused pointwise launches of one B=256 conv forward
           with ``config.performance.fused_pointwise_blocks`` on, captured
           with their real inputs: kernel vs plain in f32 and bf16 (ReLU
           within 1e-5 in f32 and one bf16 step in bf16; Heaviside flips in
           at most 1e-4 of the outputs, each within 1e-4 of the threshold
           in the plain version), flips against the exact-erf unfused
           chain, times of the kernel, the plain version and the chain;
           the body the launcher took (tensor-core or FMA) and its launch
           plan; the bound of that body (bytes, CUDA-core ops and 3xTF32
           tensor-core flops, each term printed) and ``bound_fma_ms``,
           the bound with the products on the CUDA cores;
6. eval:   4,000 seeded uint8 images labelled by the unfused conv
           forward's argmax (the classifier BN's statistics set from the
           first batch, so that the labels spread over many classes),
           written with ``write_shards`` under ``build/``, then
           ``main --mode eval --shards_dir`` at B=256 four times: conv with
           the switch off, conv with it on, ``--lut --lut_path F`` (writes
           F) and again (loads F); top-1/5, loss, img/s, the device's idle
           share and the launch counts of each run;
7. serving_transforms: ``--list_models``; the flagship folded
           (``--fold_bn``), cast (``--bf16``) and both, as ``main`` applies
           them: B=256 forward times with the fused switch off and on;
           argmax agreement with the f32 forward on smooth images (JAX's
           bf16 gate, >= 0.75 for bf16; >= 99 % for the fold, whose
           Heaviside outputs flip in at most 1e-4) and the share of
           Heaviside outputs each transform flips; where a bf16 forward's
           device time goes (switch off and on); the 6 fused launches of
           a bf16 and of a folded forward against the plain version
           (``fused_case``); ``main --mode eval`` over the eval phase's
           shards with ``--bf16`` and ``--fold_bn`` (switch off and on) and
           both: img/s, idle share, launches; ``main --mode export`` and a
           strict reload of the file, whose logits equal the weights' bit
           for bit;
8. gates:  (a) the flagship's covers compiled once in-process (seconds,
           threads, total and per-head gates, cube counts, the bytes the
           covers take on the card, which the budget counts, beside the
           padded bytes of JAX's rule, and the path the default budget
           picks);
           (b) each of the 11 ``gate_cubes`` launches of one B=256 forward,
           DNF and CNF, captured with its real planes: equal to the plain
           version bit for bit, times of both, the bound; (c) B=256: every
           block's gate bits equal the LUT forward's, top-1 agreement 100 %,
           the largest logit difference, the forward's device time by
           kernel; (d) the host evaluator
           (``gates_device_budget = 0``) on 8 images equals the device path;
           (e) ``evaluate`` over the eval phase's 4,000 shard images through
           the function ``main --mode eval --gates`` uses, DNF and CNF: img/s,
           idle share, top-1 >= 99 %; (f) ``export_model_verilog`` of the
           same covers, its total equal to ``total_gates``; (g) ``main --mode
           compile --verilog`` in a subprocess from the same weights, its
           ``total_gates`` equal to the in-process total on the boolean
           heads and its Verilog total equal to it (each filter minimized
           once: the Verilog reuses the artifacts' covers); (h) the
           ``gate_cubes`` card tests (``tests/test_torch_cuda.py -k gate_``)
           in a subprocess, all passed.  Artifacts go under ``build/``;
9. vgg_stem: ``TT_vf_19lv3_imgnet_xsmall_VGG`` at full width (p = 64,
           fcsize 36,864) from --seed with its BN statistics perturbed:
           4,000 seeded images labelled by its conv forward; its 2
           ``lut_window_bits`` launches (heads 1+2 merged, head 3; n = 4),
           its 6 ``gate_cubes`` launches (DNF and CNF, n = 4) and its one
           fused launch (head 3, G = 16, ci = co = 4) against their plain
           versions, with times and bounds; conv vs LUT top-1 >= 99 %,
           gate bits and logits equal to the LUT's; forward times and
           device profiles; ``main --mode eval`` as conv (switch on),
           ``--lut --lut_path`` (writing, then loading), ``--gates dnf`` and
           ``cnf`` with their launch counts; ``main --mode compile
           --verilog``; ``main --mode serve --lut`` and ``--gates dnf``,
           each answer's top-5 equal to the direct LUT forward's;
10. v2:    ``ttnet_imagenet_v2`` at full width (p = 64, 224², groups
           stepped down: head 3 and every fuse head at ci = 32) from --seed
           with its BN statistics perturbed, and the ptxas report of the
           kernel's ci = 32 instantiations (registers, spills): (a) the 6
           fused launches of one B=256 conv forward against their plain
           versions (``fused_case``) with ms and bound; (b) the conv
           forward with the switch off and on: argmax agreement >= 99 %,
           6 fused launches, ms, device profiles; (c) ``main --mode eval``
           over 1,280 seeded images labelled by the unfused forward, the
           switch off and on, with their launch counts; (d) ``main --mode
           serve`` with the switch on, 8 requests, top-5 equal to the
           direct forward's; (e) three f32 train steps at B=256 (the
           switch on, no fused launch): step ms and peak device memory;
11. vgg_train: ten f32 steps of the VGG-stem variant on one B=256 batch:
           the loss falls; step ms, peak memory and a step's profile;
12. fhe:   each TT_FHE model (``TT_FHE_SMALL``, ``TT_FHE_XSMALL``,
           ``TT_FHE_ref``, ``TT_FHE_SMALL_polyhead``, ``TT_FHE_SMALL_bireal``,
           the noisy ``TT_FHE_small``, ``TT_FHE_XSMALL_vAlexnet``) at full
           width (p = 64, 32², B = 256), BN statistics perturbed: (a) for
           ``TT_FHE_SMALL`` and ``TT_FHE_XSMALL_vAlexnet``, every window,
           cube (DNF and CNF) and fused launch of a forward against its
           plain version, with ms and bound; (b) conv vs LUT top-1 >= 99 %
           and logits within 1e-4, gate bits and logits equal to the
           LUT's (DNF and CNF), forward ms as conv (switch off, on), LUT
           and gates; (c) ``main --mode eval`` over 5,000 seeded 32²
           images labelled by its conv forward, as conv (switch on),
           ``--lut`` and ``--gates dnf|cnf``, with their launch counts;
           (d) ``main --mode serve`` (``--lut``, or conv for the Bi-Real
           stem, which has no tables), top-5 equal to the direct forward's;
           (e) ``main --mode compile --verilog``, its Verilog gate count
           equal to the in-process circuits'.  ``TT_FHE_small`` (its
           forward keyed from --seed, fresh coin flips a batch) has no
           tables or circuit: its eval runs twice with the same --seed and
           gives equal metrics, the fused switch launches nothing in it,
           its served answers are finite, well-formed top-5, and ``--lut``
           and ``--gates`` refuse;
13. fhe_train: each model of phase 12 at full width: (a) ``main --mode
           train`` from 1,280 seeded 32² uint8 shards (the flip on the
           card), B = 256, one epoch of 5 steps: step ms and img/s over
           steps 2-5, the idle share, peak device memory, no launch of
           the port's kernels; (b) ten steps on one batch lower the loss
           (the Bi-Real stem's ``alpha_a`` and ``beta_a`` get non-zero
           gradients); (c) one f32 step on the card and on the CPU from
           the same weights, batch and coin flips (drawn on the CPU), in
           the bounds of the flagship's (phase 19 (a));
14. v1:    ``TT_vf_19lv2_imgnet`` at full width (p = 64, 224²), BN
           statistics perturbed: (a) forward ms at B = 256 and B = 1 and
           the device time by kernel (``profile_v1``); (b) ``main --mode
           eval`` over 1,280 seeded images labelled by its forward, top-1
           >= 99.9 %, img/s and idle share; (c) ``main --mode serve``,
           top-5 equal to the direct forward's; (d) three f32 train steps
           at B = 256 (128 if 256 does not fit; the line says which): ms
           and peak memory; (e) each of the other nine v1 stage tables
           gives finite (16, 1000) logits from one forward at full width;
15. general: ``TT_general`` at full width (p = 64, ``--layers 18``,
           224²), its BNs set to the first batch's statistics and its
           Linear standardized over it: (a) forward ms at B = 256 and 1
           and the device time by kernel; (b) ``main --mode eval`` over
           1,280 seeded images labelled by its forward, top-1 >= 99.9 %;
           (c) five served requests, top-5 equal to the direct forward's;
           (d) three f32 train steps (B = 128 where 256 does not fit; the
           line says which); (e) ``TT_general_big``, ``TT_general_8`` and
           ``TT_general_correctBN`` give finite logits at B = 16;
16. cifar_zoo: each CIFAR-zoo model at its registry width (32², B =
           256; ``CIFAR_ZOO``), BNs calibrated as in 15: forward ms;
           ``main --mode eval`` over 1,280 self-labelled images (top-1 >=
           99.9 %; ``tt_certif``: two evals from one ``--seed`` equal);
           eight served requests (top-5 equal to the direct forward's up
           to tied logits; ``tt_certif``: five distinct classes); ``main
           --mode train`` over 1,280 seeded 32² shards (step ms, img/s,
           idle share, peak memory); ten steps on a batch of 32, the loss
           falling (``OVERFIT_LR``); ``model_general`` and ``tt_certif``
           one f32 step card vs CPU in the bounds of 19 (a);
17. resnet: ``resnet50`` with 4-bit weights and activations (224²): (a)
           forward ms at B = 256 and 1 and the device time by kernel; (b)
           ``main --mode eval`` over 1,280 self-labelled images (top-1 >=
           99.9 %), with ``--fuse_quant`` and ``--fold_bn`` (recorded), and
           the transforms' top-1 agreement with the unfolded forward in
           f32 (recorded) and in f64 (``--fuse_quant``, and ``--fold_bn``
           at wbit 32, where it is exact: >= 99 %); (c) three f32 train
           steps; (d) ``resnet18_cifar``: eval over 1,280 self-labelled
           32² images, ten steps on a batch of 32; (e) the other eight
           ResNets give finite logits at B = 16.  Phases 15-17 launch no
           port kernel: each counts from 0 over all of its work (the
           runs' own resets carried into the total, ``phase_launches``),
           checked, and added to every kernel's line;
18. robust: (a) ``tt_certif``, ``cifar10lownoise`` and ``model_general``
           at their registry widths (32², B = 256), BNs calibrated as in
           15: ``main --mode eval --certify 2/255 --attack pgd
           --attack_eps 2/255`` over 1,280 self-labelled images each
           (img/s, top-1, adv, cert; cert <= adv for all three, adv <=
           top-1 for the two deterministic ones); soundness: for 256
           images x 16 points drawn in the ball (``tt_certif``: fresh coin
           flips at each), the card's logits lie in the card's bounds
           within 1e-5 relative; the bounds of the card and of the CPU
           from the same weights and images within 1e-4 and their
           certified masks agreeing on >= 99 % (TF32 off);
           (b) the flagship (its classifier BN fitted as in 6) under
           ``--attack fgsm`` and ``--attack pgd`` (10 steps) at 2/255 over
           512 self-labelled images with the fused switch on: img/s,
           clean and adversarial top-1, peak memory, and the fused
           launches: 6 a forward of the clean and the adversarial logits,
           none in the differentiated forwards;
           (c) robust training: ``main --mode train`` of
           ``cifar10lownoise`` with the three losses
           (``--stability_eps``, ``--abstract_eps``, ``--bias_decay``) over
           1,280 seeded 32² shards (step ms, idle share, peak memory); ten
           robust steps on one batch of 32 lower the loss; one f32 robust
           step card vs CPU (the signs drawn on the CPU) in the bounds of
           19 (a); the flagship's ``--stability_eps`` step (the packed 3N
           forward) at B = 128, or 64 where 128 does not fit (the line
           says which): ms and peak memory.  The phase's launches are
           added to each kernel's line;
19. train: (a) one f32 step of the flagship at B = 128, no augmentation, on
           the card (the fused switch on: training must not launch it) and
           on the CPU from the same weights and batch: relative loss gap
           <= 1e-3, update cosine >= 0.99, flipped Heaviside outputs <= 1e-3;
           (b) ten steps on one fixed batch lower the loss, and one f32
           step's and one recipe step's device time by kernel; (c) ``main
           --mode train`` from 2,560 seeded 256x256 pre-crop shards with the
           eval phase's shards as validation, one epoch of 10 steps, f32 and
           ``--amp --remat --grad_accum 2 --ema 0.999 --label_smooth 0.1``:
           train img/s over steps 2-10, the device's idle share, peak device
           memory, first and last loss, validation top-1, no launch of the
           port's kernels; (d) a resume from the recipe run's ``last``
           checkpoint continues at step 11 with a finite loss;
20. perf:  B=1 latency and B=256 throughput, conv and LUT (each with the
           switch off and on: with it on, the LUT forward's last float
           fuse head runs through the fused kernel), and each B=256
           forward's device time by kernel (``torch.profiler``); a LUT
           forward runs no convolution but the stem's and the last float
           fuse head's;
21. distributed (after 19, before 20): two ranks of this script
           (``--dist_rank``) on the one card, joined over gloo (NCCL refuses
           two ranks on one card), the flagship at full width: (a) ``main
           --mode eval --num_processes 2`` over the eval phase's 4,000
           shard images at the global B, as conv and ``--lut --lut_path``
           with that phase's archive (the fused switch on, as its
           one-process run): the images scored, summed over the ranks,
           exactly 4,000; top-1/5 within 0.1 points and the loss within
           1e-3 relative of the one-process runs; img/s, each rank's idle
           share and kernel launches; (b) ``main --mode train
           --num_processes 2``, one epoch of 10 steps from the train
           phase's pre-crop shards with the eval shards as validation:
           the two ranks' final weights bit-equal, img/s over steps 2-10,
           idle shares, peak memory; (c) one data-parallel f32 step of the
           flagship against its plain version in this process (the two
           half-batches in turn, their gradients and BN statistics
           averaged): in the bounds of 19 (a), its update's norm within
           ``DIST_UPDATE_NORM_TOL`` and its BN statistics within
           ``DIST_BN_STAT_TOL`` of the plain step's.  A rank that fails or
           runs past ``DIST_TIMEOUT_S`` fails the phase, and every rank is
           stopped;
22. tp (its jobs on 21's launch of the ranks): the two ranks on the
           one card over gloo, ``--mesh_data 1 --mesh_model 2 --tp``:
           each holds half of the flagship's channels
           (``parallel/tp.py``): (a) ``main --mode eval`` over the
           4,000 shard images, the switch off: each rank scores every
           image (one data index), top-1/5 within 0.1 points and the loss
           within 1e-3 relative of the one-process conv run, img/s, idle
           share and peak memory a rank, no launch; (b) ``--lut
           --lut_path`` with the eval
           phase's archive (whole tables, each rank slicing its own), the
           switch on: the same bounds against the one-process LUT run, 8
           ``lut_window_bits`` and 1 fused launch a batch a rank; every
           launch of one TP forward of the first 256 images held against
           its plain version in each rank's process (``window_case``,
           ``fused_case`` at the local G, the ranks taking turns on the
           card); (c) ``main --mode train`` of 10 steps from the pre-crop
           shards: img/s over steps 2-10, idle share and peak memory a
           rank, the ranks' classifier BN and ``lin2`` bit-equal, and the
           gathered checkpoint's one-process ``--mode eval --ckpt`` within
           (a)'s bounds of the TP validation of the same weights; (d) one
           TP f32 step against the one-process plain step from the same
           weights and batch: the bounds of 19 (a), and 21 (c)'s update
           norm and BN statistics;
23. sp (its jobs on 21's launch of the ranks): the two ranks on the one
           card over gloo, ``--mesh_data 1 --mesh_model 2 --sp``: each holds
           half of the rows of every image at every layer
           (``parallel/sp.py``), the halos exchanged by ``all_reduce``:
           (a) ``main --mode eval`` over the 4,000 shard images, the switch
           off, then on: each rank scores every image, top-1/5 within 0.1
           points and the loss within 1e-3 relative of the one-process
           conv run with the same switch, img/s, idle share, peak memory
           and launches a rank (0 off; 6 fused a batch on); (b) one ``--sp``
           forward of the first B images with the switch on: its 6 fused
           launches a rank, each held against its plain version
           (``fused_case`` on the rank's rows, the ranks taking turns on
           the card), the two ranks' logits equal, their argmax agreeing
           with the one-process forward's on >= 99 %, the largest logit
           difference and the share of Heaviside outputs (stem, heads 1,
           2 and 4) that differ from the one-process forward's rows;
           (c) ``main --mode eval --sp --attack fgsm --attack_eps 2/255``
           over those 256 self-labelled images (the switch on): adversarial
           <= clean top-1, and the share of the images whose FGSM
           prediction through the sharded forward equals the one-process
           attack's; (d) the utilities: ``utils.profile_trace`` writes a
           trace of one ``--sp`` forward and ``utils.StepTimer`` times it,
           its region closed by a host read of the logits; (e) one 1x2
           ``--sp`` forward (``parallel/sp_models.py``) of a model of each
           other config type at its registry width (``SP_FAMILIES``: the
           VGG stem, TT_FHE_SMALL, its vAlexnet, v1, TT_general,
           correctBN, the CIFAR zoo, ``tt_certif`` keyed by one
           ``NoiseKey``, ``resnet50``), B = 32, BN statistics perturbed
           (the three with fused heads) or set to the batch's (the
           others), the switch on: the ranks' logits equal, their argmax
           agreeing with the one-process forward's on >= 99 %, the largest
           logit gap, and each fused launch on a rank's rows (the VGG
           stem's head 3, TT_FHE_SMALL's head 3 and fuse head, vAlexnet's
           head 3) held against its plain version; ``resnet50`` held in
           f64, its f32 agreement recorded; the three interval families'
           ``--certify`` bounds at 2/255 against the one-process ones:
           the ranks' equal, the certified masks agreeing on >= 99 %, the
           largest gap recorded; (f) ``main --mode eval
           --sp`` of v1 over 512 images labelled by its forward at B =
           64: top-1/5 within 0.1 points and the loss within 1e-3
           relative of the one-process run; again at B = 256, recorded
           (``SP_V1_BATCH``); (g) ``--certify 2/255 --sp`` of
           ``cifar10lownoise`` over 256 self-labelled 32² images: cert and
           top-1 equal to the one-process run's or within one image (the
           line says which); (h) ``TT_FHE_small --sp`` twice from one
           ``--seed`` over those images: equal metrics;
24. serve_mesh: ``main --mode serve`` over a mesh of two replicas in one
           process, both on the one card (``main(..., devices=[cuda:0] *
           2)``: each replica its own thread, CUDA stream and copy of the
           model, tables or covers; a second card's own setup cannot show
           on one card), the flagship at full width from the eval phase's
           weights, 32 concurrent requests at ``--serve_batch 16``: (a)
           ``--mesh_data 2`` with the fused switch on: top-5 equal to a
           direct forward's, 6 fused launches a replica forward, every
           launch of one served batch on each replica in the fused
           contract (``fused_case``); the burst's img/s against (c)'s one
           replica; (b) ``--lut --mesh_data 2 --lut_path`` with the eval
           phase's archive: top-5 equal to the direct LUT forward's, 8
           ``lut_window_bits`` a replica forward, every launch of one
           served batch on each replica bit-equal to its plain version
           (``window_case``); (c) ``--mesh_model 2 --sp`` as conv and with
           the switch on against the one-device server (top-5 equal for
           every request; the largest probability gap recorded); (d) the
           VGG stem's ``--gates dnf --mesh_data 2`` from phase vgg_stem's
           covers: top-5 equal to the direct LUT forward's, 3
           ``gate_cubes`` a replica forward, each replica's gate bits of
           one served batch equal to the tables';
25. native_data: where g++ finds ``jpeglib.h`` and libjpeg and Pillow
           imports (checked first), 512 seeded JPEGs of mixed sizes,
           ``main --mode eval --data_dir`` with and without
           ``--native_data``: equal metrics (identical pixels), both eval
           rates and both decode rates; else the line ``native_data: not
           run: <what is missing>``.  The whole smoke's seconds are the
           ``smoke`` line.

The card's name and power limit come before the ``kernels`` JSON, which is
the line before the last; the last line is the
``{"ok": true, "device": ...}`` result.  Any failed check exits non-zero.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 tensor cores
# int32 logic on the CUDA cores: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz
# (the H100 SXM's boost clock; the data sheet gives no int32 rate)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the data sheet gives no int32 rate; its non-tensor float32 rate is an
# upper bound on the shift/mask/index ops, so the op time stays a least time
OPS_PER_S = 67e12
# f32 operations of one GELU in csrc/fused_block.cu (an FMA counts 2): the
# scale by 1/sqrt2, min, a*a, one FMA for t, 16 Horner FMAs, a*acc, 1+e,
# 0.5*v and the product.  |.| (an operand modifier) and copysign (an
# integer op) take no f32 instruction and are not counted
GELU_OPS = 41
EVAL_IMAGES = 4000                 # 15.6 batches of B = 256: the last ragged
V2_EVAL_IMAGES = 1280              # 5 batches of B = 256
V2_TRAIN_STEPS = 3
FHE_EVAL_IMAGES = 5000
FHE_TRAIN_IMAGES = 1280            # 5 steps of B = 256 a model
V1_NAME = "TT_vf_19lv2_imgnet"     # the reference's "BEST" v1 model
V1_EVAL_IMAGES = 1280              # 5 batches of B = 256
V1_TRAIN_STEPS = 3
TRAIN_IMAGES = 2560                # 10 steps of B = 256 an epoch
GENERAL_NAME = "TT_general"        # p = 64, --layers 18, 224x224
GENERAL_OTHERS = ("TT_general_big", "TT_general_8", "TT_general_correctBN")
ZOO_EVAL_IMAGES = 1280             # 5 batches of B = 256 a model
ZOO_TRAIN_IMAGES = 1280            # 5 steps of B = 256 a model
ZOO_TRAIN_STEPS = 3
# the CIFAR zoo at 32x32, each at its registry default width; the CLI
# flags that give the two whose widths its defaults (--nfilter 8
# --tfilter 8 --layers 1) miss their registry defaults
CIFAR_ZOO = ("mobilenet_v2_tt", "mobilenet_v2_tt_small",
             "mobilenet_v2_tt_small_n64", "mobilenet_v2_tt_small_n64bis",
             "mobilenet_v2_tt_32_64", "mobilenet_v2_tt_32_32",
             "mobilenet_v1_tt", "model_general", "cifar10lownoise",
             "TT_general_correctBN_cifar", "tt_certif")
ZOO_CLI_WIDTH = {"TT_general_correctBN_cifar": ["--tfilter", "6",
                                                "--layers", "18"],
                 "tt_certif": ["--tfilter", "6"]}
# ten steps on one batch of 32: the SGD rate a model's loss falls at in
# ten steps; 0.1 unless listed (``tt_certif``'s float head over 23,232
# binary inputs diverges at 0.1 and at 0.01 in both packages; the TT_50
# pair's loss stayed near ln 10 at 0.1 and B = 256, with steps at 0.1
# equal to JAX's in f64, ``tests/test_torch_mobilenet_train.py``)
OVERFIT_BATCH = 32
OVERFIT_LR = {"mobilenet_v2_tt_32_64": 0.01, "mobilenet_v2_tt_32_32": 0.01,
              "tt_certif": 1e-3}
RESNET_NAME = "resnet50"
RESNET_OTHERS = ("resnet18", "resnet34", "resnet101", "resnet152",
                 "resnet34_cifar", "resnet50_cifar", "resnet101_cifar",
                 "resnet152_cifar")
# one f32 step of the flagship, card against CPU (PERF.md states these):
# relative loss gap, cosine of the parameter updates, flipped Heavisides
TRAIN_LOSS_GAP = 1e-3
TRAIN_UPDATE_COSINE = 0.99
TRAIN_FLIP_SHARE = 1e-3
# the batch of a card/CPU step (19 (a), and the TT_FHE and CIFAR-zoo
# models'): the flagship's CPU step took 47-61 s at B = 256, the smoke's
# largest host cost
PARITY_BATCH = 128
# clock cycles the card spins ahead of a timed run (~1.2 ms at 1.7 GHz)
HOST_LEAD_CYCLES = 2_000_000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout.strip()


def emit(phase: str, **nums) -> None:
    print(json.dumps({"phase": phase, **nums}), flush=True)


_flush_buf = None


def _flush_l2() -> None:
    """Overwrite the 50 MB L2 so each timed launch starts cold, as a
    launch inside a forward finds the tables."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.fill_(1)


def time_ms(fn, iters: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` cold-L2 runs.  The card
    spins for about a millisecond before each start event, so the host has
    enqueued ``fn``'s launches by the time it starts: the events time the
    device's work, not the host's launch overhead."""
    fn()
    times = []
    for _ in range(iters):
        _flush_l2()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def wall_ms(fn, iters: int) -> float:
    """Host wall time of one call of ``fn`` (a forward), the mean over
    ``iters`` calls after a warm-up, the card synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def perturb_bn(model, seed: int) -> None:
    """Seeded noise on every BN's running statistics, so the tables are
    not the trivial ones of a fresh init."""
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            shape = m.running_mean.shape
            m.running_mean.add_(
                0.1 * torch.randn(shape, generator=g).to(m.running_mean))
            m.running_var.mul_(
                torch.exp(0.1 * torch.randn(shape, generator=g)).to(
                    m.running_var))


def unpack_bits(words: torch.Tensor, dtype) -> torch.Tensor:
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(-1).to(dtype)


def window_case(kind, x, tab, k, stride, padding, heads, K):
    """Window kernel vs plain at one captured launch: exactness (bits in
    bf16 and f32), times of the kernel, the plain version, the chain it
    replaces (the index conv, then the library lookup) and the library
    lookup alone; the bound."""
    from scale_imagenet_tpu_torch.kernels.lut_gather import \
        window_index_plain

    bits = kind == "bits"
    kernel = K.lut_window_bits if bits else K.lut_window_float
    plain_fn = K.lut_window_bits_plain if bits else K.lut_window_float_plain
    extra = (heads,) if bits else ()
    g = tab.shape[0] // heads
    b, c, h, w = x.shape
    where = f"{kind} x={tuple(x.shape)} G={g} K={heads}"
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        a = kernel(xd, tab, k, stride, padding, *extra)
        torch.cuda.synchronize()
        check(torch.equal(a, plain_fn(xd, tab, k, stride, padding, *extra)),
              f"lut_window_{kind} != plain at {where} {dt}")
        del a

    def run():
        return kernel(x, tab, k, stride, padding, *extra)

    def plain():
        return plain_fn(x, tab, k, stride, padding, *extra)

    def index():
        return window_index_plain(x, g, k, stride, padding)

    out = run()
    err = float((out.float() - plain().float()).abs().max())
    idx = index()
    e = idx.shape[0]
    if bits:
        f, wd = tab.shape[1], tab.shape[2]
        entries = 32 * wd
        flat = unpack_bits(tab, x.dtype)
        offs = torch.arange(heads * g * f, device=x.device,
                            dtype=torch.int64).view(heads, g, f) * entries
        pos = (idx.to(torch.int64).view(e, 1, g, 1) + offs).view(e, -1)
        # touched words: each distinct (group, word) of every head, F filters
        touched = torch.unique(torch.arange(g, device=x.device) * wd
                               + (idx >> 5)).numel() * heads * f * 4
    else:
        entries, f = tab.shape[1], tab.shape[2]
        flat = tab.reshape(-1)
        rows = idx.to(torch.int64) + torch.arange(
            g, device=x.device, dtype=torch.int64) * entries
        pos = (rows.unsqueeze(-1) * f + torch.arange(
            f, device=x.device)).view(e, -1)
        touched = torch.unique(rows).numel() * f * 4
    kh, kw = (k, k) if isinstance(k, int) else k
    n = kh * kw * (c // g)
    library_ms = time_ms(lambda: torch.take(flat, pos))
    index_ms = time_ms(index)
    del pos, flat, idx
    nbytes = x.numel() * x.element_size() + out.numel() * \
        out.element_size() + touched
    ops = e * g * 2 * n + out.numel() * 2
    return {"G": g, "F": f, "heads": heads, "n": n, "E": e, "x": [b, c, h, w],
            "x_channels_last": bool(x.is_contiguous(
                memory_format=torch.channels_last) and not x.is_contiguous()),
            "dtype": str(out.dtype).replace("torch.", ""),
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "index_ms": index_ms, "library_ms": library_ms,
            "chain_ms": index_ms + library_ms, "bound_ms": max(
                nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / OPS_PER_S else "operations",
            "bytes": nbytes, "touched_table_bytes": touched, "ops": ops,
            "max_abs_err": err}


def device_spans(prof) -> list:
    """``(start_ns, end_ns, name)`` of every device event of a profile.  A
    device event can be reported more than once: keep each distinct one."""
    from torch.autograd import DeviceType

    return sorted({(e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA})


def busy_ns(spans: list) -> int:
    """Device busy time: the union of the intervals."""
    total, reach = 0, None
    for start, end, _ in spans:
        lo = start if reach is None else max(start, reach)
        total += max(0, end - lo)
        reach = end if reach is None else max(reach, end)
    return total


def profile_forward(name: str, fn, batch: int, out_dir: Path,
                    iters: int = 3) -> int:
    """Device time of ``iters`` calls of ``fn`` (a forward, or a train
    step) by kernel (``torch.profiler``): busy share of the window, device
    kernels a call and the kernels that take the most time.
    Writes the full table to ``<out_dir>/profile_<name>.txt``; returns the
    convolutions a forward (``aten::convolution`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3 / iters
    averages = prof.key_averages()
    (out_dir / f"profile_{name}.txt").write_text(averages.table(
        sort_by="self_device_time_total", row_limit=40))
    convs = sum(e.count for e in averages
                if e.key == "aten::convolution") // iters
    spans = device_spans(prof)
    check(bool(spans), f"profile of the {name} forward shows no device time")
    by_kernel: dict = {}
    for start, end, kname in spans:
        by_kernel[kname] = by_kernel.get(kname, 0) + (end - start) / 1e6 / iters
    busy = busy_ns(spans) / 1e6 / iters
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit(f"profile_{name}", batch=batch, window_ms_per_forward=window_ms,
         device_busy_ms_per_forward=busy, device_idle_share=1 - busy
         / window_ms, device_kernels_per_forward=len(spans) / iters,
         convolutions_per_forward=convs,
         top_kernels_ms=[[k[:60], v] for k, v in top])
    return convs


@contextlib.contextmanager
def fused_blocks(on: bool):
    """``config.performance.fused_pointwise_blocks`` set for the duration."""
    from scale_imagenet_tpu_torch import config

    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = on
    try:
        yield
    finally:
        config.performance.fused_pointwise_blocks = saved


def fused_ops(e: int, g: int, ci: int, m: int, co: int) -> int:
    """f32 operations of the fused kernel's own arithmetic (an FMA counts
    2) for E pixels and G groups: per pixel-group and hidden unit j, ci
    FMAs, the BN1 FMA, the GELU and co FMAs; per output, the BN2 FMA and
    the activation."""
    return e * g * (m * (2 * ci + 2 + GELU_OPS + 2 * co) + 3 * co)


def fused_bounds(e, g, ci, m, co, nbytes, body, bf16) -> dict:
    """The launch's least times: bytes over the memory rate; the FMA
    body's f32 operations over 67 T (``bound_fma_ms``, every launch);
    the tensor-core body's CUDA-core operations over 67 T and its 3xTF32
    flops over 495 T.  ``bound_ms`` is the bound of the body the launcher
    took."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fma_ops = fused_ops(e, g, ci, m, co)
    # the tensor-core body's CUDA-core ops: per hidden unit the BN1 FMA
    # and the GELU, per output the BN2 FMA and the activation
    cc_ops = e * g * (m * (2 + GELU_OPS) + 3 * co)
    # its tensor flops: each group product as three TF32 products (GEMM 1
    # two on a bf16 x, exact in TF32)
    tflops = e * g * 2 * m * ((2 if bf16 else 3) * ci + 3 * co)
    row = {"bytes": nbytes, "ops": fma_ops, "cuda_core_ops": cc_ops,
           "tensor_flops": tflops, "bytes_ms": bytes_ms,
           "fma_ops_ms": fma_ops / OPS_PER_S * 1e3,
           "cuda_core_ms": cc_ops / OPS_PER_S * 1e3,
           "tensor_core_ms": tflops / TF32_FLOPS_PER_S * 1e3}
    row["bound_fma_ms"] = max(bytes_ms, row["fma_ops_ms"])
    terms = [bytes_ms, row["cuda_core_ms"], row["tensor_core_ms"]] \
        if body == "tensor_core" else [bytes_ms, row["fma_ops_ms"]]
    row["bound_ms"] = max(terms)
    row["bound_by"] = "bytes" if bytes_ms >= max(terms) else "operations"
    return row


def fused_case(block, x, FB):
    """Kernel vs plain (f32 and bf16) and vs the exact-erf unfused chain at
    one captured launch of the fused pointwise block; the body the
    launcher took, times and bounds."""
    from scale_imagenet_tpu_torch.models.block_tt import block_tt

    params = FB.block_tt_pointwise_params(block)
    act = "relu" if block.cfg.last else "heaviside"
    g, ci, m = params[0].shape
    co = params[3].shape[2]
    b, c, h, w = x.shape
    where = f"G={g} ci={ci} co={co} E={b * h * w} {act}"

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])

    row = {"G": g, "ci": ci, "m": m, "co": co, "E": b * h * w, "act": act}
    # the body by shape: the wrapper's query and the launcher's own plan
    # on this card agree
    body = FB.fused_body(ci, m, co)
    plan = FB.launch_plan(ci, m, co, x.dtype)
    check(plan["body"] == body,
          f"fused body at {where}: {body} vs the launcher's {plan}")
    row.update(body=body, threads=plan["threads"],
               smem_bytes=plan["smem_bytes"],
               ctas_per_sm=plan["ctas_per_sm"])
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        got = rows(FB.fused_pointwise_nchw(xd, params, act))
        want = FB.fused_pointwise_block_plain(rows(xd), *params, act=act)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        check(got.dtype == dt, f"fused kernel stored {got.dtype} at {where}")
        if act == "relu":
            ref = want.float()
            diff = (got.float() - ref).abs()
            err = float(diff.max())
            # f32: FMA contraction and summation order (1e-5); bf16: one
            # bf16 step of the value, 2^(floor(log2 |v|) - 7), where the
            # two f32 sums round to neighbouring bf16 values
            step = torch.zeros_like(ref) if dt == torch.float32 else \
                torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(
                    2.0 ** -126))) - 7)
            check(bool((diff <= step + 1e-5).all()),
                  f"fused ReLU != plain at {where} {name}: {err}")
        else:
            flips = got != want
            err = float(flips.any())
            share = float(flips.float().mean())
            near = FB.fused_pointwise_preact_plain(rows(xd), *params)[flips]
            row[f"flip_share_{name}"] = share
            row[f"flips_max_abs_preact_{name}"] = float(
                near.abs().max()) if near.numel() else 0.0
            check(share <= 1e-4, f"fused Heaviside flips {share} at {where}")
            check(bool((near.abs() < 1e-4).all()),
                  f"a fused Heaviside flip away from the threshold at "
                  f"{where} {name}")
        row[f"max_abs_err_{name}"] = err
        del got, want

    xr = rows(x)

    def run():
        return FB.fused_pointwise_nchw(x, params, act)

    def plain():
        return FB.fused_pointwise_block_plain(xr, *params, act=act)

    def chain():
        with fused_blocks(False):
            return block_tt(block, x)

    out, exact = run(), chain()
    row["vs_exact_chain"] = float(((out - exact).abs().max()) if act == "relu"
                                  else (out != exact).float().mean())
    del out, exact
    # the output is stored in x's dtype; the params are f32
    nbytes = (x.numel() * x.element_size() + b * h * w * g * co
              * x.element_size() + sum(t.numel() * 4 for t in params))
    row.update(ms=time_ms(run), plain_ms=time_ms(plain),
               chain_ms=time_ms(chain),
               **fused_bounds(b * h * w, g, ci, m, co, nbytes, body,
                              x.dtype == torch.bfloat16))
    return row


def fused_kernels_phase(model, x, out_dir: Path) -> list:
    """Capture the fused launches of one conv forward with the switch on
    and hold each against its plain version."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.models import multihead
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply

    captured = []
    real = multihead.block_tt

    def rec(block, h, *a, **k):
        if block.cfg.k in (1, (1, 1)):
            captured.append((block, h))
        return real(block, h, *a, **k)

    with mock.patch.object(multihead, "block_tt", rec), fused_blocks(True):
        ttnet_imagenet_apply(model, x)
    torch.cuda.synchronize()
    check(len(captured) == 6, f"{len(captured)} fused launches a flagship "
                              "conv forward, expected 6")
    rows = []
    for block, h in captured:
        row = fused_case(block, h, FB)
        rows.append(row)
        emit("fused_kernels", kernel="fused_pointwise_block", **row)
    (out_dir / "fused_cases.json").write_text(json.dumps(rows, indent=1))
    return rows


def kernel_launches() -> dict:
    """The port's kernel launch counts since their last reset."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
    from scale_imagenet_tpu_torch.kernels import lut_gather as K

    return {"fused_pointwise_block": FB.fused_pointwise_block.launches,
            "lut_window_bits": K.lut_window_bits.launches,
            "lut_window_float": K.lut_window_float.launches,
            "gate_cubes": GC.gate_cubes.launches}


# the launches that ``reset_kernel_launches`` cleared since
# ``start_phase_launches``: a phase's runs each set the counts to 0 just
# before they start, and the phase's own total still covers all of them
_CLEARED: dict = {}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0, adding what it held to the
    running phase total (``phase_launches``)."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
    from scale_imagenet_tpu_torch.kernels import lut_gather as K

    for name, n in kernel_launches().items():
        _CLEARED[name] = _CLEARED.get(name, 0) + n
    K.reset_launches()
    FB.reset_launches()
    GC.reset_launches()


def start_phase_launches() -> None:
    """Every count and the phase total set to 0, just before a phase."""
    reset_kernel_launches()
    _CLEARED.clear()


def phase_launches() -> dict:
    """Every launch since ``start_phase_launches``, whatever the phase's
    runs reset in between."""
    return {name: _CLEARED.get(name, 0) + n
            for name, n in kernel_launches().items()}


def main_eval(argv: list, fused: bool, images: int = EVAL_IMAGES) -> dict:
    """``main --mode eval`` (``argv``, over ``images`` images) with the
    fused switch set: top-1/5, loss (``cert`` and ``adv`` under
    ``--certify`` and ``--attack``), img/s over the eval loop, the device's
    idle share over it, and the launches of every kernel of the port in
    this run (the counts set to 0 just before it and read just after)."""
    from torch.profiler import ProfilerActivity, profile

    from scale_imagenet_tpu_torch import main as cli

    stats = {}
    real_evaluate = cli.evaluate

    def timed(*a, **k):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            res = real_evaluate(*a, **k)
            torch.cuda.synchronize()
            stats["wall_s"] = time.perf_counter() - t
        stats["busy_s"] = busy_ns(device_spans(prof)) / 1e9
        return res

    reset_kernel_launches()
    t = time.perf_counter()
    with mock.patch.object(cli, "evaluate", timed), fused_blocks(fused):
        top1, top5, loss, *extras = cli.main(argv)
    torch.cuda.synchronize()
    return {"top1": top1, "top5": top5, "loss": loss,
            **(extras[0] if extras else {}),
            "img_s": images / stats["wall_s"], "eval_s": stats["wall_s"],
            "device_idle_share": 1 - stats["busy_s"] / stats["wall_s"],
            "run_s": time.perf_counter() - t,
            "launches": kernel_launches()}


def eval_phase(args, model, out_dir: Path) -> dict:
    """``main --mode eval`` over self-labelled shards: conv (switch off,
    on), LUT writing its archive, LUT loading it."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply, ttnet_imagenet_features
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, EVAL_IMAGES
    # shards, weights and the archive (~1 GB) stay out of --out_dir, which
    # holds only the small reports
    work = Path("build") / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    imgs = np.random.default_rng(args.seed + 3).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    model = copy.deepcopy(model)
    with fused_blocks(False):
        fit_classifier_bn(model.classifier, ttnet_imagenet_features(
            model, prepare(torch.from_numpy(imgs[:B]).cuda())))
        labels = self_labelled_shards(
            lambda xb: ttnet_imagenet_apply(model, xb), imgs, B,
            work / "shards")
    ckpt = work / "weights.pth"
    torch.save(model.state_dict(), ckpt)
    lut_path = work / "luts.npz"
    del imgs, model
    emit("eval_setup", images=n, batch=B, classes_hit=int(
        np.unique(labels).size), setup_s=time.perf_counter() - t0)

    base = ["--mode", "eval", "--shards_dir", str(work / "shards"),
            "--eval_batch_size", str(B), "--seed", str(args.seed),
            "--ckpt", str(ckpt), "--root_dir", str(work / "logs")]
    batches = -(-n // B)
    results = {}
    for name, extra, fused in (
            ("conv", [], False), ("conv_fused", [], True),
            ("lut_write", ["--lut", "--lut_path", str(lut_path)], True),
            ("lut_load", ["--lut", "--lut_path", str(lut_path)], True)):
        results[name] = main_eval(base + extra, fused)
        emit("eval", run=name, fused=fused, **results[name])
    want = {"conv": (0, 0), "conv_fused": (6 * batches, 0),
            "lut_write": (batches, 8 * batches),
            "lut_load": (batches, 8 * batches)}
    for name, (fused_n, bits_n) in want.items():
        got = results[name]["launches"]
        check(got["fused_pointwise_block"] == fused_n
              and got["lut_window_bits"] == bits_n,
              f"eval {name} launched {got}, expected {fused_n} fused and "
              f"{bits_n} lut_window_bits")
    check(results["conv"]["top1"] >= 99.9,
          f"eval conv top-1 {results['conv']['top1']} < 99.9")
    for name in ("conv_fused", "lut_write"):
        check(results[name]["top1"] >= 99.0,
              f"eval {name} top-1 {results[name]['top1']} < 99")
    check(all(results["lut_load"][k] == results["lut_write"][k]
              for k in ("top1", "top5", "loss")),
          "eval from the loaded LUT archive differs from the run that "
          "wrote it")
    # the shards, the weights and the archive stay: the gates phase scores
    # the shards, the train phase validates on them, the distributed phase
    # scores them again through the archive
    return results


def cube_ops(cubes: torch.Tensor, offsets: torch.Tensor, n: int,
             words: int) -> int:
    """int32 logic operations of one ``gate_cubes`` launch on this run's
    covers: per word, one for each fixed literal of a cube (``mism |
    (plane ^ value)``, one three-input LOP3) and one for each cube
    (``out | ~mism``, one LOP3)."""
    fixed = (~cubes[:, 1]) & ((1 << n) - 1)
    lits = sum(int(((fixed >> p) & 1).sum()) for p in range(n))
    return (lits + cubes.shape[0]) * words


def gate_case(planes, cubes, offsets, filters, invert, GC) -> dict:
    """``gate_cubes`` vs its plain version at one captured launch: equal
    words, the times of both, the bound."""
    g, n, w = planes.shape
    got = GC.gate_cubes(planes, cubes, offsets, filters, invert)
    want = GC.gate_cubes_plain(planes, cubes, offsets, filters, invert)
    torch.cuda.synchronize()
    where = f"G={g} F={filters} n={n} W={w} invert={invert}"
    check(torch.equal(got, want), f"gate_cubes != plain at {where}")
    err = float((got.long() - want.long()).abs().max())
    del got, want
    nbytes = (planes.numel() + cubes.numel() + g * filters * w) * 4 \
        + offsets.numel() * 8
    ops = cube_ops(cubes, offsets, n, w)
    counts = offsets[1:] - offsets[:-1]
    return {"G": g, "F": filters, "n": n, "W": w, "invert": invert,
            "cubes": int(cubes.shape[0]), "max_cubes": int(counts.max()),
            "ms": time_ms(lambda: GC.gate_cubes(planes, cubes, offsets,
                                                filters, invert)),
            "plain_ms": time_ms(lambda: GC.gate_cubes_plain(
                planes, cubes, offsets, filters, invert), iters=3),
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / INT32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / INT32_OPS_PER_S else "operations",
            "max_abs_err": err}


def gates_phase(args, md, model, luts, x, out_dir: Path) -> dict:
    """(a)-(g) of the gates phase (module docstring)."""
    import os

    from scale_imagenet_tpu_torch import config
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.compile import gate_device as GD
    from scale_imagenet_tpu_torch.compile.gate_net import \
        compile_ttnet_gates, gate_ttnet_apply, total_gates
    from scale_imagenet_tpu_torch.compile.lut_eval import _bits, \
        lut_multihead_apply, lut_ttnet_apply
    from scale_imagenet_tpu_torch.compile.verilog import \
        export_model_verilog
    from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem

    B = args.batch
    work = Path("build") / "chip_smoke_gates"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    eval_dir = Path("build") / "chip_smoke_eval"

    # (a) one full minimization, in this process
    threads = len(os.sched_getaffinity(0))
    t = time.perf_counter()
    gnets = compile_ttnet_gates(model)
    compile_s = time.perf_counter() - t
    total = total_gates(gnets)
    heads = {}
    for i, mg in enumerate(gnets):
        for name, bg in [(f"block{i}_conv{h}", mg.heads[h])
                         for h in sorted(mg.heads)] + (
                [(f"block{i}_convf", mg.convf)] if mg.convf else []):
            heads[name] = {
                "filters": bg.cfg.out_planes, "groups": bg.cfg.groupsici,
                "n": bg.cfg.n_bits, "gates": bg.gates,
                "constant_filters": sum(c is not None for c in bg.constants),
                **{f"{form}_{k}": v for form, covers in
                   (("dnf", bg.covers), ("cnf", bg.cnf_covers))
                   for k, v in (("max_cubes", max(len(c) for c in covers)),
                                ("mean_cubes", float(np.mean(
                                    [len(c) for c in covers]))),
                                ("padded_bytes", GD.circuit_device_bytes(
                                    bg, form)),
                                ("device_bytes", GD.device_bytes(
                                    bg, form)))}}
    padded, held = ({form: sum(h[f"{form}_{k}"] for h in heads.values())
                     for form in ("dnf", "cnf")}
                    for k in ("padded_bytes", "device_bytes"))
    budget = config.performance.gates_device_budget
    fits = max(held.values()) <= budget
    emit("gates_compile", compile_s=compile_s, threads=threads,
         total_gates=total, filters=sum(h["filters"] for h in heads.values()),
         device_bytes=held, padded_bytes=padded, default_budget=budget,
         default_budget_path="device" if fits else "host", heads=heads)
    check(total > 0 and total == sum(h["gates"] for h in heads.values()),
          f"total_gates {total} is not the sum of the heads' gates")
    if not fits:
        config.performance.gates_device_budget = max(held.values())
        print(f"gates: this init's circuit does not fit the default budget "
              f"of {budget} bytes; gates_device_budget set to "
              f"{config.performance.gates_device_budget} bytes for this "
              "phase", flush=True)
    gdevs = {form: GD.build_device_gates(
        gnets, form, max_cube_bytes=config.performance.gates_device_budget,
        device=x.device) for form in ("dnf", "cnf")}

    # (b) every launch of one B = 256 forward, DNF and CNF
    captured = []
    real = GD.gate_cubes

    def rec(planes, cubes, offsets, filters, invert=False):
        captured.append((planes, cubes, offsets, filters, invert))
        return real(planes, cubes, offsets, filters, invert)

    with mock.patch.object(GD, "gate_cubes", rec):
        for form in ("dnf", "cnf"):
            GD.gate_ttnet_apply_device(gdevs[form], model, x)
    # one launch a boolean head: 11 a flagship forward
    per_forward = sum(len(mg.heads) + (mg.convf is not None) for mg in gnets)
    check(len(captured) == 2 * per_forward,
          f"{len(captured)} gate_cubes launches in a DNF and a CNF forward, "
          f"expected {per_forward} each")
    cases = []
    for launch in captured:
        row = gate_case(*launch, GC)
        cases.append(row)
        emit("gates_kernels", kernel="gate_cubes", **row)
    (out_dir / "gate_cases.json").write_text(json.dumps(cases, indent=1))
    del captured

    # (c) B = 256: each block's gate bits against the LUT forward's, both
    # fed by the same bits, then the full forwards
    h = _bits(stem(model, _nchw(x, model)), None)
    mism = []
    for i, (lut, block) in enumerate(zip(luts, model.blocks)):
        want = lut_multihead_apply(lut, h, convf_float=block.Block_convf)
        for form in ("dnf", "cnf"):
            got = GD.gate_multihead_apply_device(
                gdevs[form][i], h,
                convf_float=block.Block_convf)
            mism.append(int((got != want).sum()))
        h = want
    check(not any(mism), f"gate blocks differ from the LUT blocks: {mism}")
    ref = lut_ttnet_apply(luts, model, x)
    got = GD.gate_ttnet_apply_device(gdevs["dnf"], model, x)
    top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
    logit_diff = float((ref - got).abs().max())
    emit("gates_model", batch=B, block_bit_mismatches=mism,
         top1_agreement_vs_lut=top1, logit_max_abs_diff_vs_lut=logit_diff)
    check(top1 == 1.0, f"gate top-1 agreement with the LUT {top1} < 100 %")
    # where a B = 256 gate forward's device time goes
    profile_forward("gates_dnf", lambda: GD.gate_ttnet_apply_device(
        gdevs["dnf"], model, x), B, out_dir)

    # (d) the host evaluator, as main's budget rule reaches it, on 8 images
    saved = config.performance.gates_device_budget
    config.performance.gates_device_budget = 0
    try:
        host_apply, on_device = cli._as_gate_model(model, "dnf", gnets)
    finally:
        config.performance.gates_device_budget = saved
    check(not on_device, "a budget of 0 did not pick the host evaluator")
    x8 = x[:8].contiguous()
    t = time.perf_counter()
    host = host_apply(x8)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    dev8 = GD.gate_ttnet_apply_device(gdevs["dnf"], model, x8)
    check(torch.equal(host, dev8), "host and device gate logits differ")
    check(torch.equal(host, gate_ttnet_apply(gnets, model, x8)),
          "the host forward is not gate_ttnet_apply")
    emit("gates_host", images=8, host_s=host_s, equals_device=True)

    # (e) eval over the eval phase's shards, through main's functions
    emodel = md.init(seed=args.seed, device=x.device)
    cli.load_checkpoint(emodel, str(eval_dir / "weights.pth"))
    evals = {}
    GC.reset_launches()
    for form in ("dnf", "cnf"):
        cfg = cli.parse_args([
            "--mode", "eval", "--gates", form, "--shards_dir",
            str(eval_dir / "shards"), "--eval_batch_size", str(B),
            "--root_dir", str(work / "logs")])
        apply, on_device = cli._as_gate_model(emodel, form, gnets)
        check(on_device, f"--gates {form} did not run on the card")
        stats = {}
        real_evaluate = cli.evaluate

        def timed(*a, **k):
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                res = real_evaluate(*a, **k)
                torch.cuda.synchronize()
                stats["wall_s"] = time.perf_counter() - t
            stats["busy_s"] = busy_ns(device_spans(prof)) / 1e9
            return res

        with mock.patch.object(cli, "evaluate", timed):
            top1, top5, loss = cli._eval(cfg, apply, x.device, md, model)
        evals[form] = {"top1": top1, "top5": top5, "loss": loss,
                       "img_s": EVAL_IMAGES / stats["wall_s"],
                       "eval_s": stats["wall_s"],
                       "device_idle_share": 1 - stats["busy_s"]
                       / stats["wall_s"]}
        emit("gates_eval", form=form, images=EVAL_IMAGES, batch=B,
             **evals[form])
        check(top1 >= 99.0, f"gate eval {form} top-1 {top1} < 99")
    launches = GC.gate_cubes.launches
    batches = -(-EVAL_IMAGES // B)
    check(launches == 2 * per_forward * batches,
          f"gate eval launched gate_cubes {launches} times, expected "
          f"{2 * per_forward * batches}")

    # (f) Verilog of the same covers
    t = time.perf_counter()
    manifest = export_model_verilog(gnets, str(work / "verilog"),
                                    model_name=md.name)
    verilog_s = time.perf_counter() - t
    check(manifest["total_gates"] == total,
          f"verilog total {manifest['total_gates']} != {total}")

    # (g) the CLI's compile from the same weights, in a subprocess
    mc = md.config
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "scale_imagenet_tpu_torch.main", "--mode",
         "compile", "--model", md.name, "--nfilter", str(mc.nfilter),
         "--tfilter", str(mc.tfilter), "--layers", str(mc.layers), "--ckpt",
         str(eval_dir / "weights.pth"), "--compile_out",
         str(work / "compile"), "--verilog"]
        + ([] if x.is_cuda else ["--device", "cpu"]),
        capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t
    (out_dir / "gates_compile_cli.log").write_text(proc.stdout[-20000:]
                                                   + proc.stderr[-20000:])
    check(proc.returncode == 0, f"main --mode compile failed: "
                                f"{proc.stderr[-2000:]}")
    summary = json.loads((work / "compile" / "summary.json").read_text())
    cli_verilog = json.loads((work / "compile" / "verilog"
                              / "manifest.json").read_text())
    check(cli_verilog["total_gates"] == total,
          f"main --mode compile --verilog wrote {cli_verilog['total_gates']}"
          f" gates of Verilog, the in-process circuits {total}")
    # the CLI also minimizes a float (ReLU) head's columns that take at
    # most 16 values (the JAX artifact rule); the circuits leave that head
    # float, so its gates are the only ones the two totals do not share
    float_heads = {k: v["gates"] for k, v in summary["blocks"].items()
                   if k not in heads}
    emit("gates_cli", verilog_s=verilog_s, verilog_modules=len(
        manifest["modules"]), verilog_total_gates=manifest["total_gates"],
        compile_cli_s=cli_s, compile_cli_total_gates=summary["total_gates"],
        compile_cli_verilog_total_gates=cli_verilog["total_gates"],
        compile_cli_float_head_gates=float_heads,
        compile_cli_weights=summary["weights"])
    bad = {k: (summary["blocks"][k]["gates"], h["gates"])
           for k, h in heads.items() if summary["blocks"][k]["gates"]
           != h["gates"]}
    check(not bad and summary["total_gates"] == total + sum(
        float_heads.values()), f"main --mode compile counted "
        f"{summary['total_gates']} gates ({float_heads} in float heads), "
        f"the in-process compile {total}; differing heads {bad}")
    shutil.rmtree(work)
    # the eval weights stay: the distributed phase reads them

    # (h) the kernel's card tests, in a subprocess (no conftest: it
    # configures JAX)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
         "no:cacheprovider", "tests/test_torch_cuda.py", "-k", "gate_"],
        capture_output=True, text=True, timeout=600)
    (out_dir / "gates_card_tests.log").write_text(proc.stdout[-20000:]
                                                  + proc.stderr[-20000:])
    tail = (proc.stdout.strip().splitlines() or [""])[-1]
    emit("gates_card_tests", seconds=time.perf_counter() - t,
         returncode=proc.returncode, summary=tail)
    check(proc.returncode == 0 and " passed" in tail and "failed" not in tail
          and "skipped" not in tail, f"gate card tests: {tail}")
    dnf = [c for c in cases if not c["invert"]]
    return {"launches": launches, "cases": cases, "dnf_cases": dnf,
            "evals": evals, "total_gates": total}


@contextlib.contextmanager
def heaviside_outputs(sink: list):
    """Every Heaviside output of the forwards run inside, appended to
    ``sink`` as a bool tensor on its device (the stem's, each Block_TT's,
    each pooled head 4's; the dead-zone ones of ``TT_FHE_small`` too)."""
    from scale_imagenet_tpu_torch.ops import binarize

    def recorder(real):
        def rec(x, *a, **k):
            out = real(x, *a, **k)
            sink.append(out.detach() > 0)
            return out
        return rec

    # every model reaches them through ``binarize01_act``
    with mock.patch.object(binarize, "heaviside01",
                           recorder(binarize.heaviside01)), \
            mock.patch.object(binarize, "heaviside01_noisy",
                              recorder(binarize.heaviside01_noisy)):
        yield


def one_train_step(model, x, y, sink: list, noise=None) -> float:
    """One plain f32 step (SGD, lr 0.1) of ``model`` in place, recording
    its Heaviside outputs into ``sink``; returns the loss.  ``noise``
    keys a stochastic model's coin flips."""
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    opt, _ = make_optimizer(0.1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    with heaviside_outputs(sink):
        _, metrics = step(ts, x, y, noise=noise)
    return float(metrics["loss"])


def card_cpu_step(model, x, y, noise=None) -> dict:
    """One f32 step of ``model`` (on the card) with the fused switch on
    (training must not take the eval kernel), and of its copy on the CPU
    (the plain path), from the same weights, batch and coin flips: the
    relative loss gap, the cosine between the two parameter updates and
    the share of Heaviside outputs that flipped."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB

    cpu_model = copy.deepcopy(model).cpu()
    start = [p.detach().cpu().clone() for p in model.parameters()]
    card_bits, cpu_bits = [], []
    reset_kernel_launches()
    with fused_blocks(True):
        card_loss = one_train_step(model, x.cuda(), y.cuda(), card_bits,
                                   noise)
    torch.cuda.synchronize()
    fused_launches = FB.fused_pointwise_block.launches
    card_bits = [b.cpu() for b in card_bits]
    t = time.perf_counter()
    cpu_loss = one_train_step(cpu_model, x, y, cpu_bits, noise)
    cpu_s = time.perf_counter() - t
    du = torch.cat([(p.detach().cpu() - s).double().ravel()
                    for p, s in zip(model.parameters(), start)])
    dv = torch.cat([(p.detach() - s).double().ravel()
                    for p, s in zip(cpu_model.parameters(), start)])
    check(len(card_bits) == len(cpu_bits) and all(
        a.shape == b.shape for a, b in zip(card_bits, cpu_bits)),
        "the card and CPU steps ran different Heavisides")
    flips = sum(int((a != b).sum()) for a, b in zip(card_bits, cpu_bits))
    outputs = sum(a.numel() for a in card_bits)
    return {"batch": len(x), "card_loss": card_loss, "cpu_loss": cpu_loss,
            "rel_loss_gap": abs(card_loss - cpu_loss) / abs(cpu_loss),
            "update_cosine": float(du @ dv / (du.norm() * dv.norm())),
            "heaviside_outputs": outputs, "heaviside_flipped": flips,
            "flip_share": flips / outputs, "heavisides": len(card_bits),
            "fused_launches_in_training": fused_launches, "cpu_step_s": cpu_s}


def step_parity(model, B: int, seed: int) -> dict:
    """19(a): ``card_cpu_step`` of the seeded flagship without
    augmentation, on a seeded batch."""
    gen = torch.Generator().manual_seed(seed + 5)
    x = torch.randn((B, 224, 224, 3), generator=gen)
    y = torch.randint(0, 1000, (B,), generator=gen)
    return card_cpu_step(model, x, y)


def check_parity(parity: dict, what: str) -> None:
    """The bounds of a card/CPU step (PERF.md §2)."""
    check(parity["rel_loss_gap"] <= TRAIN_LOSS_GAP,
          f"{what}: card/CPU loss gap {parity['rel_loss_gap']} > "
          f"{TRAIN_LOSS_GAP}")
    check(parity["update_cosine"] >= TRAIN_UPDATE_COSINE,
          f"{what}: card/CPU update cosine {parity['update_cosine']} < "
          f"{TRAIN_UPDATE_COSINE}")
    check(parity["flip_share"] <= TRAIN_FLIP_SHARE,
          f"{what}: card/CPU Heaviside flip share {parity['flip_share']} > "
          f"{TRAIN_FLIP_SHARE}")
    check(parity["fused_launches_in_training"] == 0,
          f"{what}: a training forward launched the eval-only fused kernel")


class StepTimer:
    """Wraps a train step: keeps every step's loss (a device scalar, read
    after the run), and times steps 2..``steps`` from a synchronised start
    to a synchronised end, with the card's kernels profiled over the same
    window (device idle share).  The port's ``utils.StepTimer`` (JAX's
    plain timer, phase 23 (d)) has no profiler window, so the train
    phases keep this one."""

    def __init__(self, steps: int):
        self.steps, self.calls, self.losses = steps, 0, []
        self.prof = None
        self.t0 = self.t1 = None
        self.busy_s = None

    def wrap(self, step):
        from torch.profiler import ProfilerActivity, profile

        def timed(ts, images, labels, generator=None, noise=None):
            i = self.calls
            self.calls += 1
            if i == 1:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            ts, metrics = step(ts, images, labels, generator, noise)
            self.losses.append(metrics["loss"])
            if i == self.steps - 1:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
                self.prof.__exit__(None, None, None)
                self.busy_s = busy_ns(device_spans(self.prof)) / 1e9
                self.prof = None
            return ts, metrics
        return timed


def train_phase(args, model, out_dir: Path) -> dict:
    """19(a)-(d): the step against the CPU, an overfit check on one batch,
    ``main --mode train`` from seeded 256x256 pre-crop shards (f32, then
    the README's recipe), and a resume from the recipe's ``last``
    checkpoint."""
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, write_shards
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step, params_ema

    B = args.batch
    # (a) one step, card against CPU
    parity = step_parity(copy.deepcopy(model), PARITY_BATCH, args.seed)
    emit("train_step_parity", **parity)
    check_parity(parity, "flagship")

    # (b) ten steps on one fixed batch lower the loss
    net = copy.deepcopy(model)
    opt, _ = make_optimizer(0.1)
    ts = TrainState(net, opt.init(dict(net.named_parameters())))
    step = make_train_step(net, opt)
    gen = torch.Generator().manual_seed(args.seed + 6)
    x = torch.randn((B, 224, 224, 3), generator=gen).cuda()
    y = torch.randint(0, 1000, (B,), generator=gen).cuda()
    losses = []
    for _ in range(10):
        ts, metrics = step(ts, x, y)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    emit("train_overfit", batch=B, steps=10, losses=losses)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"ten steps on one batch did not lower the loss: {losses}")
    # where a step's device time goes: the f32 step, and the recipe's (bf16,
    # remat, two microbatches, the full augmentation from uint8 pre-crops)
    profile_forward("train_step_f32", lambda: step(ts, x, y), B, out_dir,
                    iters=2)
    net.cfg = dataclasses.replace(net.cfg, remat=True)
    opt = dataclasses.replace(opt, ema=params_ema(0.999))
    ts = TrainState(net, opt.init(dict(net.named_parameters())))
    step = make_train_step(net, opt, amp=True, accum=2, label_smooth=0.1,
                           normalize=(IMAGENET_MEAN, IMAGENET_STD),
                           augment="full")
    x = torch.randint(0, 256, (B, 256, 256, 3), dtype=torch.uint8,
                      generator=gen).cuda()
    aug_gen = torch.Generator(x.device).manual_seed(args.seed)
    profile_forward("train_step_recipe", lambda: step(ts, x, y, aug_gen), B,
                    out_dir, iters=2)
    del net, ts, step, x, y, opt

    # (c) main --mode train from pre-crop shards, twice
    work = Path("build") / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(args.seed + 7)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (TRAIN_IMAGES, 256, 256, 3), dtype=np.uint8),
        rng.integers(0, 1000, TRAIN_IMAGES).astype(np.int32)),
        str(work / "shards"), shard_size=B)
    steps = TRAIN_IMAGES // B
    base = ["--mode", "train", "--shards_dir", str(work / "shards"),
            "--eval_shards_dir", str(Path("build") / "chip_smoke_eval" /
                                     "shards"),
            "--train_batch_size", str(B), "--eval_batch_size", str(B),
            "--seed", str(args.seed), "--root_dir", str(work / "run")]
    recipe = ["--amp", "--remat", "--grad_accum", "2", "--ema", "0.999",
              "--label_smooth", "0.1"]
    runs = {}
    real_make = cli.make_train_step
    for name, extra in (("f32", []), ("recipe", recipe)):
        timer = StepTimer(steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        K.reset_launches()
        FB.reset_launches()
        t = time.perf_counter()
        with mock.patch.object(
                cli, "make_train_step",
                lambda *a, **k: timer.wrap(real_make(*a, **k))):
            summary = cli.main(base + extra + ["--max_epochs", "1"])
        torch.cuda.synchronize()
        run_losses = [float(v) for v in timer.losses]
        wall = timer.t1 - timer.t0
        val = summary["val"][0]
        runs[name] = {
            "steps": timer.calls, "timed_steps": steps - 1,
            "train_img_s": (steps - 1) * B / wall,
            "device_idle_share": 1 - timer.busy_s / wall,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "resident_before_gb": resident / 1e9,
            "first_loss": run_losses[0], "last_loss": run_losses[-1],
            "val_top1": val["top1"], "val_ema_top1": val.get("ema_top1"),
            "run_s": time.perf_counter() - t,
            "launches": {"fused_pointwise_block":
                         FB.fused_pointwise_block.launches,
                         "lut_window_bits": K.lut_window_bits.launches},
            "ckpt_dir": summary["ckpt_dir"]}
        emit("train", run=name, flags=" ".join(extra), batch=B,
             images=TRAIN_IMAGES, **runs[name])
        check(timer.calls == steps and summary["step"] == steps,
              f"train {name}: {timer.calls} steps, expected {steps}")
        check(all(np.isfinite(run_losses)) and 0 <= val["top1"] <= 100,
              f"train {name}: losses {run_losses}, val {val}")
        # training and its validation (the fused switch off) run no kernel
        # of the port
        check(not any(runs[name]["launches"].values()),
              f"train {name} launched {runs[name]['launches']}")

    # (d) resume the recipe run from its last checkpoint
    last = str(Path(runs["recipe"]["ckpt_dir"]) / "last")
    resumed = cli.main(base + recipe + ["--max_epochs", "2", "--ckpt", last,
                                        "--log_interval", "1"])
    first_step, first_loss, _ = resumed["train"][0]
    emit("train_resume", start_step=resumed["start_step"],
         first_step=first_step, first_loss=first_loss,
         step=resumed["step"])
    check(resumed["start_step"] == steps and first_step == steps + 1
          and np.isfinite(first_loss) and resumed["step"] == 2 * steps,
          f"resume from {last}: {resumed}")
    # the pre-crop shards stay for the distributed phase
    return {"parity": parity, "overfit": losses, "runs": runs}


def flip_share(bits_a: list, bits_b: list) -> float:
    """Share of the Heaviside outputs of two forwards that differ (each
    chain fed by itself, so a flip counts again where it propagates)."""
    check(len(bits_a) == len(bits_b) and all(
        a.shape == b.shape for a, b in zip(bits_a, bits_b)),
        "the two forwards ran different Heavisides")
    flips = sum(int((a != b).sum()) for a, b in zip(bits_a, bits_b))
    return flips / sum(a.numel() for a in bits_a)


def capture_fused(model, x, apply) -> list:
    """``(block, input)`` of every fused launch of one forward of ``model``
    with the switch on."""
    from scale_imagenet_tpu_torch.models import multihead

    captured = []
    real = multihead.block_tt

    def rec(block, h, *a, **k):
        if block.cfg.k in (1, (1, 1)):
            captured.append((block, h))
        return real(block, h, *a, **k)

    with mock.patch.object(multihead, "block_tt", rec), fused_blocks(True):
        apply(model, x)
    torch.cuda.synchronize()
    return captured


def serving_transforms_phase(args, md, model, x, out_dir: Path) -> dict:
    """The flagship under ``--bf16`` and ``--fold_bn`` (module docstring,
    phase 7), the transforms as ``main`` applies them: in process on the
    setup's model, through ``main`` on the eval phase's weights."""
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply

    B = args.batch
    names = cli.main(["--list_models"])
    check("ttnet_imagenet_vgg_stem" in names and md.name in names,
          f"--list_models printed {names}")
    eval_dir = Path("build") / "chip_smoke_eval"
    weights = str(eval_dir / "weights.pth")
    models = {"f32": model}
    for name, flags in (("bf16", ["--bf16"]), ("fold", ["--fold_bn"]),
                        ("fold_bf16", ["--fold_bn", "--bf16"])):
        models[name] = copy.deepcopy(model)
        cli.apply_serving_transforms(cli.parse_args(
            ["--mode", "serve", *flags]), models[name])
    check(models["bf16"].stem_conv.weight.dtype == torch.bfloat16
          and models["fold"].stem_conv.bias is not None
          and not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "the serving transforms did not cast / fold, or turned TF32 on")

    # (a) forward times, the switch off and on
    fwd = {}
    for name, m in models.items():
        for fused in (False, True):
            with fused_blocks(fused):
                fwd[f"{name}{'_fused' if fused else ''}_b256_ms"] = wall_ms(
                    lambda: ttnet_imagenet_apply(m, x), 10)
    for k in list(fwd):
        fwd[k.replace("_b256_ms", "_img_s")] = B / fwd[k] * 1e3

    # (b) agreement with the f32 forward, each chain fed by itself, on
    # smooth images as JAX's bf16 gate takes them (``tests/test_bf16_eval.py``:
    # noise images sit on Heaviside thresholds far more often)
    base = torch.rand((B, 3, 14, 14), generator=torch.Generator()
                      .manual_seed(args.seed + 9))
    smooth = torch.nn.functional.interpolate(
        base, size=(224, 224), mode="bilinear").permute(0, 2, 3, 1) \
        .contiguous().to(x.device)
    logits, bits = {}, {}
    for name, m in models.items():
        bits[name] = []
        with fused_blocks(False), heaviside_outputs(bits[name]):
            logits[name] = ttnet_imagenet_apply(m, smooth)
    bf16_dtype = str(logits["bf16"].dtype)
    logits = {name: lg.float() for name, lg in logits.items()}
    with fused_blocks(True):
        for name in ("f32", "bf16", "fold"):
            logits[f"{name}_fused"] = ttnet_imagenet_apply(
                models[name], smooth).float()
    top1 = {name: float((lg.argmax(1) == logits["f32"].argmax(1)).float()
                        .mean()) for name, lg in logits.items()}
    top1["fold_fused_vs_f32_fused"] = float(
        (logits["fold_fused"].argmax(1) == logits["f32_fused"].argmax(1))
        .float().mean())
    shares = {name: flip_share(bits["f32"], bits[name])
              for name in ("bf16", "fold", "fold_bf16")}
    diffs = {name: float((logits[name] - logits["f32"]).abs().max())
             for name in ("bf16", "fold", "fold_bf16")}
    diffs["fold_fused_vs_f32_fused"] = float(
        (logits["fold_fused"] - logits["f32_fused"]).abs().max())
    emit("serving_transforms", batch=B, **fwd,
         agreement_images="smooth (14x14 noise, bilinear to 224x224)",
         top1_agreement_vs_f32=top1,
         heaviside_flip_share_vs_f32=shares, logit_max_abs_diff_vs_f32=diffs,
         logits_dtype_bf16=bf16_dtype)
    check(min(top1["bf16"], top1["fold_bf16"], top1["bf16_fused"]) >= 0.75,
          f"bf16 argmax agreement with f32 {top1} < 0.75")
    check(shares["fold"] <= 1e-4, f"--fold_bn flipped {shares['fold']} of "
                                  "the Heaviside outputs (> 1e-4)")
    check(top1["fold"] >= 0.99 and top1["fold_fused_vs_f32_fused"] >= 0.99,
          f"--fold_bn top-1 agreement {top1} < 0.99")
    check(bf16_dtype == "torch.bfloat16", f"--bf16 logits are {bf16_dtype}")
    # where a bf16 forward's device time goes (the f32 one: phase perf)
    profile_forward("conv_bf16", lambda: ttnet_imagenet_apply(
        models["bf16"], x), B, out_dir)
    with fused_blocks(True):
        profile_forward("conv_bf16_fused", lambda: ttnet_imagenet_apply(
            models["bf16"], x), B, out_dir)

    # (c) the fused launches of a bf16 and of a folded forward
    rows = []
    for name in ("bf16", "fold"):
        captured = capture_fused(models[name], x, ttnet_imagenet_apply)
        check(len(captured) == 6, f"{len(captured)} fused launches in a "
                                  f"{name} forward, expected 6")
        for block, h in captured:
            row = {"transform": name, **fused_case(block, h, FB)}
            rows.append(row)
            emit("fused_kernels", kernel="fused_pointwise_block", **row)
    del models, logits, bits

    # (d) main --mode eval over the eval phase's shards
    base = ["--mode", "eval", "--shards_dir", str(eval_dir / "shards"),
            "--eval_batch_size", str(B), "--seed", str(args.seed),
            "--ckpt", weights, "--root_dir", str(eval_dir / "logs")]
    batches = -(-EVAL_IMAGES // B)
    evals = {}
    for name, flags, fused in (
            ("bf16", ["--bf16"], False), ("bf16_fused", ["--bf16"], True),
            ("fold", ["--fold_bn"], False),
            ("fold_fused", ["--fold_bn"], True),
            ("fold_bf16_fused", ["--fold_bn", "--bf16"], True)):
        evals[name] = main_eval(base + flags, fused)
        emit("eval", run=name, fused=fused, **evals[name])
        want = 6 * batches if fused else 0
        got = evals[name]["launches"]["fused_pointwise_block"]
        check(got == want, f"eval {name} launched the fused kernel {got} "
                           f"times, expected {want}")
        # the labels come from the f32 forward on noise images, through a
        # classifier BN set from them (an ill-conditioned head: bf16 moves
        # its argmax often): a fold is the same function; bf16 is held to
        # JAX's gate on smooth images above, and here to 10x chance (0.5 %)
        floor = 99.0 if "bf16" not in name else 5.0
        check(evals[name]["top1"] >= floor and np.isfinite(
            evals[name]["loss"]),
            f"eval {name} top-1 {evals[name]['top1']} < {floor}")

    # (e) --mode export, then a strict reload: the same logits, bit for bit
    exported = str(eval_dir / "exported.pth")
    check(cli.main(["--mode", "export", "--ckpt", weights, "--export_out",
                    exported]) == exported, "--mode export failed")
    reloaded, loaded = (md.init(seed=args.seed + i, device=x.device)
                        for i in (1, 2))
    cli.load_checkpoint(reloaded, exported)
    cli.load_checkpoint(loaded, weights)
    same = torch.equal(ttnet_imagenet_apply(reloaded, x),
                       ttnet_imagenet_apply(loaded, x))
    emit("export", path_bytes=Path(exported).stat().st_size,
         reload_logits_equal=same)
    check(same, "the exported weights reload to other logits")
    Path(exported).unlink()
    return {"rows": rows, "evals": evals}


def vgg_stem_phase(args, out_dir: Path) -> dict:
    """The VGG16-stem variant at full width (module docstring, phase 9)."""
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.compile import gate_device as GD
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.gate_net import \
        compile_ttnet_gates, total_gates
    from scale_imagenet_tpu_torch.compile.lut_eval import _bits, \
        compile_ttnet_lut, lut_multihead_apply, lut_ttnet_vgg_stem_apply
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.layers.pool import flatten
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, \
        ttnet_vgg_stem_apply, vgg_stem
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, EVAL_IMAGES
    work = Path("build") / "chip_smoke_vgg"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda")
    vmd = get_model("ttnet_imagenet_vgg_stem")
    model = vmd.init(seed=args.seed, device=dev)
    perturb_bn(model, args.seed + 10)
    # images and labels: the classifier BN's statistics set from the first
    # batch, as in the eval phase, then labels from the conv forward
    t0 = time.perf_counter()
    imgs = np.random.default_rng(args.seed + 11).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    x = prepare(torch.from_numpy(imgs[:B]).cuda())
    fit_classifier_bn(model.classifier, flatten(model.blocks[0](
        vgg_stem(model, _nchw(x, model)))))
    labels = self_labelled_shards(lambda xb: ttnet_vgg_stem_apply(model, xb),
                                  imgs, B, work / "shards")
    weights = work / "weights.pth"
    torch.save(model.state_dict(), weights)
    # the serve_mesh phase serves these weights as these covers
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del imgs
    t = time.perf_counter()
    luts = compile_ttnet_lut(model)
    gnets = compile_ttnet_gates(model)
    gdevs = {form: GD.build_device_gates(gnets, form, device=dev)
             for form in ("dnf", "cnf")}
    emit("vgg_setup", images=n, batch=B, classes_hit=int(
        np.unique(labels).size), setup_s=t - t0,
        compile_s=time.perf_counter() - t, total_gates=total_gates(gnets),
        fcsize=vmd.config.fcsize, params=sum(
            p.numel() for p in model.parameters()))

    # (a) the window launches of one LUT forward
    captured = []
    real_bits = lut_eval.lut_window_bits

    def rec_bits(xb, words, k, stride, padding, heads=1):
        captured.append(("bits", xb, words, k, stride, padding, heads))
        return real_bits(xb, words, k, stride, padding, heads)

    with mock.patch.object(lut_eval, "lut_window_bits", rec_bits):
        lut_ttnet_vgg_stem_apply(luts, model, x)
    check(len(captured) == 2, f"{len(captured)} lut_window_bits launches a "
                              "VGG-stem LUT forward, expected 2")
    windows = []
    for kind, *launch in captured:
        row = window_case(kind, *launch, K)
        windows.append(row)
        emit("vgg_kernels", kernel="lut_window_bits", **row)
    del captured

    # (b) the cube launches of one DNF and one CNF forward
    captured = []
    real_cubes = GD.gate_cubes

    def rec_cubes(planes, cubes, offsets, filters, invert=False):
        captured.append((planes, cubes, offsets, filters, invert))
        return real_cubes(planes, cubes, offsets, filters, invert)

    with mock.patch.object(GD, "gate_cubes", rec_cubes):
        for form in ("dnf", "cnf"):
            GD.gate_ttnet_vgg_stem_apply_device(gdevs[form], model, x)
    check(len(captured) == 6, f"{len(captured)} gate_cubes launches in a "
                              "VGG-stem DNF and CNF forward, expected 3 each")
    gates = []
    for launch in captured:
        row = gate_case(*launch, GC)
        gates.append(row)
        emit("vgg_kernels", kernel="gate_cubes", **row)
    del captured

    # (c) the fused launch of a conv forward (head 3, G = 16, ci = co = 4)
    captured = capture_fused(model, x, ttnet_vgg_stem_apply)
    check(len(captured) == 1, f"{len(captured)} fused launches a VGG-stem "
                              "conv forward, expected 1")
    fused = [fused_case(*captured[0], FB)]
    emit("vgg_kernels", kernel="fused_pointwise_block", **fused[0])
    del captured

    # (d) conv, LUT and gates against each other at B = 256
    ref = ttnet_vgg_stem_apply(model, x)
    K.reset_launches()
    got = lut_ttnet_vgg_stem_apply(luts, model, x)
    torch.cuda.synchronize()
    check(K.lut_window_bits.launches == 2, "VGG-stem LUT forward launches")
    with mock.patch.object(lut_eval, "lut_window_bits",
                           K.lut_window_bits_plain):
        check(torch.equal(got, lut_ttnet_vgg_stem_apply(luts, model, x)),
              "VGG-stem LUT logits through the kernel differ from the "
              "plain version's")
    h = vgg_stem(model, _nchw(x, model))
    conv_bits = model.blocks[0](h)
    lut_bits = lut_multihead_apply(luts[0], _bits(h, None))
    gate_mism = {form: int((GD.gate_multihead_apply_device(
        gdevs[form][0], _bits(h, None)) != lut_bits).sum())
        for form in ("dnf", "cnf")}
    gate_logits = {form: GD.gate_ttnet_vgg_stem_apply_device(
        gdevs[form], model, x) for form in ("dnf", "cnf")}
    top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
    emit("vgg_model", batch=B, top1_agreement_conv_vs_lut=top1,
         block_bit_mismatch_frac_conv_vs_lut=float(
             (conv_bits != lut_bits.float()).float().mean()),
         gate_bit_mismatches_vs_lut=gate_mism,
         gate_logits_equal_lut={f: bool(torch.equal(v, got))
                                for f, v in gate_logits.items()},
         logit_max_abs_diff_conv_vs_lut=float((ref - got).abs().max()))
    check(ref.shape == (B, 1000) and bool(torch.isfinite(ref).all()),
          "VGG-stem logits non-finite or misshapen")
    check(top1 >= 0.99, f"VGG-stem top-1 agreement conv vs LUT {top1}")
    check(not any(gate_mism.values()) and all(
        torch.equal(v, got) for v in gate_logits.values()),
        f"VGG-stem gate bits differ from the LUT's: {gate_mism}")
    del h, conv_bits, lut_bits, gate_logits, ref, got

    # (e) forward times and where a LUT and a gate forward's time goes
    fwd = {"conv_b256_ms": wall_ms(lambda: ttnet_vgg_stem_apply(model, x),
                                   10),
           "lut_b256_ms": wall_ms(lambda: lut_ttnet_vgg_stem_apply(
               luts, model, x), 10)}
    with fused_blocks(True):
        fwd["conv_fused_b256_ms"] = wall_ms(
            lambda: ttnet_vgg_stem_apply(model, x), 10)
    for form in ("dnf", "cnf"):
        fwd[f"gates_{form}_b256_ms"] = wall_ms(
            lambda: GD.gate_ttnet_vgg_stem_apply_device(gdevs[form], model,
                                                        x), 10)
    for k in list(fwd):
        fwd[k.replace("_b256_ms", "_img_s")] = B / fwd[k] * 1e3
    emit("vgg_perf", batch=B, **fwd)
    profile_forward("vgg_conv", lambda: ttnet_vgg_stem_apply(model, x), B,
                    out_dir)
    profile_forward("vgg_lut", lambda: lut_ttnet_vgg_stem_apply(
        luts, model, x), B, out_dir)
    profile_forward("vgg_gates_dnf", lambda: GD.gate_ttnet_vgg_stem_apply_device(
        gdevs["dnf"], model, x), B, out_dir)
    del model, luts, gdevs, x

    # (f) main --mode eval: conv (the switch on), LUT writing and loading
    # its archive, the gates in DNF and CNF
    lut_path = str(work / "luts.npz")
    base = ["--mode", "eval", "--model", vmd.name, "--shards_dir",
            str(work / "shards"), "--eval_batch_size", str(B), "--seed",
            str(args.seed), "--ckpt", str(weights), "--root_dir",
            str(work / "logs")]
    batches = -(-n // B)
    evals = {}
    for name, extra, fused_on, want in (
            ("conv_fused", [], True, {"fused_pointwise_block": batches}),
            ("lut_write", ["--lut", "--lut_path", lut_path], False,
             {"lut_window_bits": 2 * batches}),
            ("lut_load", ["--lut", "--lut_path", lut_path], False,
             {"lut_window_bits": 2 * batches}),
            ("gates_dnf", ["--gates", "dnf"], False,
             {"gate_cubes": 3 * batches}),
            ("gates_cnf", ["--gates", "cnf"], False,
             {"gate_cubes": 3 * batches})):
        evals[name] = main_eval(base + extra, fused_on)
        emit("vgg_eval", run=name, fused=fused_on, **evals[name])
        launched = {k: v for k, v in evals[name]["launches"].items() if v}
        check(launched == want, f"VGG-stem eval {name} launched {launched}, "
                                f"expected {want}")
    check(evals["conv_fused"]["top1"] >= 99.0,
          f"VGG-stem conv eval top-1 {evals['conv_fused']['top1']} < 99")
    check(evals["lut_write"]["top1"] >= 99.0,
          f"VGG-stem LUT eval top-1 {evals['lut_write']['top1']} < 99")
    for name in ("lut_load", "gates_dnf", "gates_cnf"):
        check(all(evals[name][k] == evals["lut_write"][k]
                  for k in ("top1", "top5", "loss")),
              f"VGG-stem eval {name} differs from lut_write")

    # (g) main --mode compile --verilog from the same weights
    t = time.perf_counter()
    summary = cli.main(["--mode", "compile", "--model", vmd.name, "--ckpt",
                        str(weights), "--compile_out", str(work / "compile"),
                        "--verilog"])
    emit("vgg_compile", compile_s=time.perf_counter() - t,
         blocks=summary["blocks"], total_gates=summary["total_gates"],
         verilog_total_gates=summary["verilog"]["total_gates"])
    # n = 4 <= 12: the artifacts count the gates of minimized expressions,
    # the circuits (and their Verilog) those of espresso covers, as in JAX
    check(sorted(summary["blocks"]) == ["block0_conv1", "block0_conv2",
                                        "block0_conv3"]
          and summary["total_gates"] > 0
          and summary["verilog"]["total_gates"] == total_gates(gnets),
          f"VGG-stem --mode compile: {summary['blocks']}, Verilog "
          f"{summary['verilog']['total_gates']} gates, circuits "
          f"{total_gates(gnets)}")

    # (h) main --mode serve, as tables and as the DNF circuit
    serve_launches = {}
    rng = torch.Generator().manual_seed(args.seed + 12)
    reqs = torch.rand((8, 224, 224, 3), generator=rng)
    smodel = vmd.init(seed=args.seed, device=dev)
    cli.load_checkpoint(smodel, str(weights))
    direct = lut_ttnet_vgg_stem_apply(compile_ttnet_lut(smodel), smodel,
                                      reqs.to(dev))
    direct = torch.topk(torch.softmax(direct, -1), 5).indices.tolist()
    for form, flags in (("lut", ["--lut"]), ("gates_dnf", ["--gates",
                                                           "dnf"])):
        answers, health, counts = serve_requests(
            ["--model", vmd.name, "--ckpt", str(weights), *flags], reqs,
            batch=8)
        serve_launches[form] = counts
        agree = sum(a["top5"] == d for a, d in zip(answers, direct))
        emit("vgg_serve", form=form, requests=len(answers), top5_equal=agree,
             launches=counts, healthz=health)
        check(agree == len(answers), f"VGG-stem serve {form}: top-5 of "
                                     f"{len(answers) - agree} answers differ")
        # a launch set a batch, the server's warm-up batch included
        kernel, per = (("lut_window_bits", 2) if form == "lut"
                       else ("gate_cubes", 3))
        check(counts[kernel] == per * (health["batches"] + 1),
              f"VGG-stem serve {form} launched {counts}")
    shutil.rmtree(work)
    return {"windows": windows, "gates": gates, "fused": fused,
            "evals": evals, "serve_launches": serve_launches,
            "gnets": gnets, "state": state}


def ptxas_report(log: str, marker: str) -> list:
    """``[{function, registers, spill_stores, spill_loads, smem_bytes}]``
    of the entry functions whose name holds ``marker``, from an ``nvcc
    -Xptxas -v`` log (``smem_bytes`` the static shared memory; the
    kernels' own is dynamic, in each launch's plan)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)} if marker in m.group(1) else None
            if cur is not None:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def sass_hmma(lib: Path) -> dict:
    """``{function: HMMA instructions}`` of a built library, from
    ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    exe = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(exe) if exe.exists() else "cuobjdump",
                           "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    return counts


def fused_build_report(lib: Path, out_dir: Path) -> list:
    """Every instantiation of the fused kernel: its body, ptxas's
    registers, spills and static shared memory, and its HMMA count.  Every
    tensor-core instantiation must hold HMMA, and every FMA one none."""
    log = out_dir / "ptxas_fused_block.log"
    rows = ptxas_report(log.read_text() if log.exists() else "",
                        "fused_pointwise")
    hmma = sass_hmma(lib)
    for r in rows:
        r["body"] = "tensor_core" if "fused_pointwise_tc_kernel" in \
            r["function"] else "fma"
        r["hmma"] = hmma.get(r["function"], 0)
    tc = [r for r in rows if r["body"] == "tensor_core"]
    # five pairs, f32 and bf16 x
    check(len(tc) == 10, f"{len(tc)} tensor-core instantiations, "
                         "expected 10")
    check(all(r["hmma"] > 0 for r in tc),
          f"a tensor-core instantiation without HMMA: {tc}")
    check(all(r["hmma"] == 0 for r in rows if r["body"] == "fma"),
          "an FMA-body instantiation with HMMA")
    return rows


def fit_classifier_bn(head, features: torch.Tensor) -> None:
    """Set a ``Classifier_scale``'s BN statistics from one batch of
    ``features``: with the init's statistics the classifier BN maps every
    image of a seeded random network to one class; fitted, the argmax
    depends on the image."""
    from scale_imagenet_tpu_torch.layers.linear import linear

    z = linear(features, head.lin1.weight)
    head.BN2.running_mean.copy_(z.mean(0))
    head.BN2.running_var.copy_(z.var(0))


def self_labelled_shards(apply, imgs: np.ndarray, B: int,
                         path: Path) -> np.ndarray:
    """Label seeded uint8 images by ``apply``'s argmax (ImageNet-normalized
    on the card, as the shard eval does) and write them as shards at
    ``path``; returns the labels."""
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, pad_batches, write_shards
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    n = len(imgs)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    labels = []
    for batch, _ in pad_batches(((imgs[i:i + B], np.zeros(
            min(B, n - i), np.int32)) for i in range(0, n, B)), B):
        labels.append(apply(prepare(torch.from_numpy(batch).cuda()))
                      .argmax(1).cpu())
    labels = torch.cat(labels)[:n].numpy().astype(np.int32)
    write_shards(ArrayDataset(imgs, labels), str(path))
    return labels


def v2_phase(args, out_dir: Path) -> dict:
    """The v2 variant at full width (module docstring, phase 10)."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply, ttnet_imagenet_features
    from scale_imagenet_tpu_torch.train import TrainState, \
        make_input_pipeline, make_optimizer, make_train_step

    B, n = args.batch, V2_EVAL_IMAGES
    work = Path("build") / "chip_smoke_v2"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda")
    md = get_model("ttnet_imagenet_v2")
    model = md.init(seed=args.seed, device=dev)
    perturb_bn(model, args.seed + 20)
    gen = torch.Generator().manual_seed(args.seed + 21)
    x = torch.rand((B, 224, 224, 3), generator=gen).to(dev)
    log = (out_dir / "ptxas_fused_block.log")
    ptxas = ptxas_report(log.read_text() if log.exists() else "",
                         "ILi32E")
    emit("v2_setup", blocks=[[b.head_cfgs()[3].groupsici,
                              b.convf_cfg().groupsici, b.out_channels]
                             for b in md.config.block_configs()],
         fcsize=md.config.fcsize, ptxas_ci32=ptxas)

    # (a) the 6 fused launches of one conv forward, each against its plain
    # version, with ms and bound
    captured = capture_fused(model, x, ttnet_imagenet_apply)
    check(len(captured) == 6, f"{len(captured)} fused launches a v2 conv "
                              "forward, expected 6")
    rows = []
    for block, h in captured:
        row = fused_case(block, h, FB)
        check(row["ci"] == 32, f"v2 fused launch at ci={row['ci']}")
        rows.append(row)
        emit("v2_kernels", kernel="fused_pointwise_block", **row)
    del captured
    (out_dir / "v2_fused_cases.json").write_text(json.dumps(rows, indent=1))

    # (b) the conv forward with the switch off and on
    ref = ttnet_imagenet_apply(model, x)
    FB.reset_launches()
    with fused_blocks(True):
        got = ttnet_imagenet_apply(model, x)
    torch.cuda.synchronize()
    fused_launches = FB.fused_pointwise_block.launches
    top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
    fwd = {"conv_b256_ms": wall_ms(lambda: ttnet_imagenet_apply(model, x),
                                   5)}
    with fused_blocks(True):
        fwd["conv_fused_b256_ms"] = wall_ms(
            lambda: ttnet_imagenet_apply(model, x), 5)
    for k in list(fwd):
        fwd[k.replace("_b256_ms", "_img_s")] = B / fwd[k] * 1e3
    emit("v2_model", batch=B, fused_launches=fused_launches,
         top1_agreement_off_vs_on=top1,
         logit_max_abs_diff_off_vs_on=float((ref - got).abs().max()), **fwd)
    check(ref.shape == (B, 1000) and bool(torch.isfinite(ref).all())
          and bool(torch.isfinite(got).all()), "v2 logits non-finite or "
                                               "misshapen")
    check(fused_launches == 6, f"v2 conv forward launched {fused_launches} "
                               "fused kernels, expected 6")
    check(top1 >= 0.99, f"v2 top-1 agreement off vs on {top1}")
    profile_forward("v2_conv", lambda: ttnet_imagenet_apply(model, x), B,
                    out_dir)
    with fused_blocks(True):
        profile_forward("v2_conv_fused", lambda: ttnet_imagenet_apply(
            model, x), B, out_dir)
    del ref, got

    # (c) main --mode eval over shards labelled by the unfused forward (the
    # classifier BN's statistics set from the first batch, as in the eval
    # phase), switch off and on
    imgs = np.random.default_rng(args.seed + 22).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)
    emodel = copy.deepcopy(model)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    fit_classifier_bn(emodel.classifier, ttnet_imagenet_features(
        emodel, prepare(torch.from_numpy(imgs[:B]).cuda())))
    labels = self_labelled_shards(
        lambda xb: ttnet_imagenet_apply(emodel, xb), imgs, B,
        work / "shards")
    weights = work / "weights.pth"
    torch.save(emodel.state_dict(), weights)
    del imgs
    base = ["--mode", "eval", "--model", md.name, "--shards_dir",
            str(work / "shards"), "--eval_batch_size", str(B), "--ckpt",
            str(weights), "--root_dir", str(work / "logs")]
    batches = -(-n // B)
    evals = {}
    for name, fused in (("conv", False), ("conv_fused", True)):
        evals[name] = main_eval(base, fused, images=n)
        emit("v2_eval", run=name, fused=fused, images=n,
             classes_hit=int(np.unique(labels).size), **evals[name])
        want = {"fused_pointwise_block": 6 * batches} if fused else {}
        launched = {k: v for k, v in evals[name]["launches"].items() if v}
        check(launched == want, f"v2 eval {name} launched {launched}, "
                                f"expected {want}")
    check(evals["conv"]["top1"] >= 99.9,
          f"v2 eval conv top-1 {evals['conv']['top1']} < 99.9")
    check(evals["conv_fused"]["top1"] >= 99.0,
          f"v2 eval conv_fused top-1 {evals['conv_fused']['top1']} < 99")

    # (d) main --mode serve with the switch on: each answer's top-5 equal
    # to the direct forward's at the server's padded batch
    reqs = torch.rand((8, 224, 224, 3), generator=gen)
    with fused_blocks(True):
        answers, health, serve_launches = serve_requests(
            ["--model", md.name, "--ckpt", str(weights)], reqs, batch=8)
        direct = ttnet_imagenet_apply(emodel, reqs.to(dev))
    direct = torch.topk(torch.softmax(direct, -1), 5).indices.tolist()
    agree = sum(a["top5"] == d for a, d in zip(answers, direct))
    emit("v2_serve", requests=len(answers), top5_equal=agree,
         launches=serve_launches, healthz=health)
    check(agree == len(answers), f"v2 serve: top-5 of "
                                 f"{len(answers) - agree} answers differ")
    check(serve_launches["fused_pointwise_block"] == 6 * (
        health["batches"] + 1), f"v2 serve launched {serve_launches}")
    del emodel

    # (e) a few f32 train steps at B (the switch on: training must not take
    # the eval kernel), their time and peak device memory
    opt, _ = make_optimizer(0.1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    xt = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    yt = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FB.reset_launches()
    losses = []
    with torch.enable_grad(), fused_blocks(True):
        ts, m = step(ts, xt, yt)
        losses.append(m["loss"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(V2_TRAIN_STEPS - 1):
            ts, m = step(ts, xt, yt)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / (V2_TRAIN_STEPS - 1)
    losses = [float(v) for v in losses]
    train = {"batch": B, "steps": V2_TRAIN_STEPS, "losses": losses,
             "step_ms": step_ms, "train_img_s": B / step_ms * 1e3,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "fused_launches_in_training":
                 FB.fused_pointwise_block.launches}
    emit("v2_train", **train)
    check(all(np.isfinite(losses)), f"v2 train losses {losses}")
    check(train["fused_launches_in_training"] == 0,
          "a v2 training forward launched the eval-only fused kernel")
    shutil.rmtree(work)
    return {"fused": rows, "evals": evals, "serve_launches": serve_launches,
            "train": train}


def vgg_train_phase(args, out_dir: Path) -> dict:
    """Ten f32 steps of the VGG-stem variant on one batch (module
    docstring, phase 11)."""
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    B = args.batch
    model = get_model("ttnet_imagenet_vgg_stem").init(seed=args.seed,
                                                      device="cuda")
    opt, _ = make_optimizer(0.1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(args.seed + 30)
    x = torch.randn((B, 224, 224, 3), generator=gen).cuda()
    y = torch.randint(0, 1000, (B,), generator=gen).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t = time.perf_counter()
    for _ in range(10):
        ts, metrics = step(ts, x, y)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 10
    losses = [float(v) for v in losses]
    out = {"batch": B, "steps": 10, "losses": losses, "step_ms": step_ms,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    emit("vgg_train", **out)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"ten VGG-stem steps on one batch did not lower the loss: "
          f"{losses}")
    profile_forward("vgg_train_step", lambda: step(ts, x, y), B, out_dir,
                    iters=2)
    return out


FHE_NAMES = ("TT_FHE_SMALL", "TT_FHE_XSMALL", "TT_FHE_ref",
             "TT_FHE_SMALL_polyhead", "TT_FHE_SMALL_bireal", "TT_FHE_small",
             "TT_FHE_XSMALL_vAlexnet")
# the models whose launches are each held against the plain version: they
# cover every FHE launch shape (XSMALL and polyhead have SMALL's heads)
FHE_CASES = ("TT_FHE_SMALL", "TT_FHE_XSMALL_vAlexnet")


def fhe_phase(args, out_dir: Path) -> dict:
    """The TT_FHE family at full width (module docstring, phase 12)."""
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.compile import gate_device as GD
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.gate_net import total_gates
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import gate_cubes as GC
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.models import get_model

    B, n = args.batch, FHE_EVAL_IMAGES
    work = Path("build") / "chip_smoke_fhe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed + 40)
    x = torch.rand((B, 32, 32, 3), generator=gen).to(dev)
    imgs = np.random.default_rng(args.seed + 41).integers(
        0, 256, (n, 32, 32, 3), dtype=np.uint8)
    reqs = torch.rand((8, 32, 32, 3), generator=gen)
    cases = {"windows": [], "gates": [], "fused": []}
    results = {}
    for mi, name in enumerate(FHE_NAMES):
        md = get_model(name)
        model = md.init(seed=args.seed, device=dev)
        perturb_bn(model, args.seed + 42 + mi)
        fam = cli._family(md.config)
        # neither the Bi-Real stem nor a dead zone has tables or a circuit
        tables = not md.stochastic and (
            md.config.spec.get("act") != "bireal"
            if hasattr(md.config, "spec") else True)

        def conv():
            """The conv forward as ``main`` runs it: a stochastic model
            draws fresh flips a call, keyed from --seed."""
            return cli._keyed(lambda xb, **k: fam.conv(model, xb, **k),
                              md.stochastic, args.seed)

        res = {"fcsize": md.config.fcsize, "params": sum(
            p.numel() for p in model.parameters())}
        mwork = work / name
        # labelled by the forward ``main --mode eval --seed`` runs, batch
        # by batch the same flips
        labels = self_labelled_shards(conv(), imgs, B, mwork / "shards")
        weights = mwork / "weights.pth"
        torch.save(model.state_dict(), weights)
        res["classes_hit"] = int(np.unique(labels).size)
        fwd_conv = conv()
        ref = fwd_conv(x)
        check(ref.shape == (B, 10) and bool(torch.isfinite(ref).all()),
              f"{name} logits non-finite or misshapen")
        t = time.perf_counter()
        if tables:
            luts = fam.lut_compile(model)
            gnets = fam.gate_compile(model)
            gdevs = {form: GD.build_device_gates(gnets, form, device=dev)
                     for form in ("dnf", "cnf")}
            res.update(compile_s=time.perf_counter() - t,
                       total_gates=total_gates(gnets))
        if name in FHE_CASES:
            # (a) every window, cube and fused launch of a B = 256 forward
            captured = []
            real_bits = lut_eval.lut_window_bits

            def rec_bits(xb, words, k, stride, padding, heads=1):
                captured.append((xb, words, k, stride, padding, heads))
                return real_bits(xb, words, k, stride, padding, heads)

            with mock.patch.object(lut_eval, "lut_window_bits", rec_bits):
                fam.lut(luts, model, x)
            for launch in captured:
                row = {"model": name, **window_case("bits", *launch, K)}
                cases["windows"].append(row)
                emit("fhe_kernels", kernel="lut_window_bits", **row)
            captured = []
            real_cubes = GD.gate_cubes

            def rec_cubes(planes, cubes, offsets, filters, invert=False):
                captured.append((planes, cubes, offsets, filters, invert))
                return real_cubes(planes, cubes, offsets, filters, invert)

            with mock.patch.object(GD, "gate_cubes", rec_cubes):
                for form in ("dnf", "cnf"):
                    fam.gate_device(gdevs[form], model, x)
            for launch in captured:
                row = {"model": name, **gate_case(*launch, GC)}
                cases["gates"].append(row)
                emit("fhe_kernels", kernel="gate_cubes", **row)
            for block, h in capture_fused(model, x, fam.conv):
                row = {"model": name, **fused_case(block, h, FB)}
                cases["fused"].append(row)
                emit("fhe_kernels", kernel="fused_pointwise_block", **row)
            del captured
        # (b) conv against tables and circuits at B = 256
        fwd = {"conv_b256_ms": wall_ms(lambda: fwd_conv(x), 10)}
        with fused_blocks(True):
            fwd["conv_fused_b256_ms"] = wall_ms(lambda: fwd_conv(x), 10)
        if tables:
            got = fam.lut(luts, model, x)
            top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
            gate_equal = {form: bool(torch.equal(
                fam.gate_device(gdevs[form], model, x), got))
                for form in ("dnf", "cnf")}
            bits_mism = {}
            for form in ("dnf", "cnf"):
                h = torch.rand((B, model.blocks[0].cfg.in_planes, 9, 9),
                               generator=gen).lt(0.5).to(dev, torch.bfloat16) \
                    if model.blocks else None
                bits_mism[form] = sum(int((GD.gate_multihead_apply_device(
                    gd, h) != lut_eval.lut_multihead_apply(lut, h)).sum())
                    for gd, lut in zip(gdevs[form], luts))
            diff = float((ref - got).abs().max())
            res.update(top1_agreement_conv_vs_lut=top1,
                       logit_max_abs_diff_conv_vs_lut=diff,
                       gate_logits_equal_lut=gate_equal,
                       gate_bit_mismatches_vs_lut=bits_mism)
            check(top1 >= 0.99, f"{name} top-1 agreement conv vs LUT {top1}")
            # the tables are exact: the logits differ by float rounding only
            check(torch.allclose(got, ref, rtol=1e-4, atol=1e-4),
                  f"{name} LUT logits differ from the conv's by {diff}")
            check(all(gate_equal.values()) and not any(bits_mism.values()),
                  f"{name} gate bits differ from the LUT's: {bits_mism}, "
                  f"{gate_equal}")
            fwd["lut_b256_ms"] = wall_ms(lambda: fam.lut(luts, model, x), 10)
            for form in ("dnf", "cnf"):
                fwd[f"gates_{form}_b256_ms"] = wall_ms(
                    lambda: fam.gate_device(gdevs[form], model, x), 10)
        for k in list(fwd):
            fwd[k.replace("_b256_ms", "_img_s")] = B / fwd[k] * 1e3
        res.update(fwd)
        # (c) main --mode eval: conv (the switch on), LUT, gates
        base = ["--mode", "eval", "--model", name, "--shards_dir",
                str(mwork / "shards"), "--eval_batch_size", str(B),
                "--ckpt", str(weights), "--root_dir", str(mwork / "logs"),
                "--seed", str(args.seed)]
        batches = -(-n // B)
        blocks = len(model.blocks)
        # the switch takes no block with a dead zone
        k1 = 0 if md.stochastic else sum(2 if b.cfg.fuse else 1
                                         for b in model.blocks)
        runs = [("conv_fused", [], True,
                 {"fused_pointwise_block": k1 * batches} if k1 else {})]
        if md.stochastic:
            # the same --seed again: the same flips, the same metrics
            runs.append(("conv_fused_again", [], True, {}))
        if tables:
            # heads 1 and 2 share a launch where their kernels are equal
            windows = sum(len(lut.merged) + (lut.convf is not None)
                          for lut in luts)
            cubes = sum(len(g.heads) + (g.convf is not None) for g in gnets)
            runs += [("lut", ["--lut"], False,
                      {"lut_window_bits": windows * batches}
                      if blocks else {}),
                     ("gates_dnf", ["--gates", "dnf"], False,
                      {"gate_cubes": cubes * batches} if blocks else {}),
                     ("gates_cnf", ["--gates", "cnf"], False,
                      {"gate_cubes": cubes * batches} if blocks else {})]
        evals = {}
        for run, extra, fused, want in runs:
            evals[run] = main_eval(base + extra, fused, images=n)
            emit("fhe_eval", model=name, run=run, fused=fused, images=n,
                 **evals[run])
            launched = {k: v for k, v in evals[run]["launches"].items()
                        if v}
            check(launched == want, f"{name} eval {run} launched "
                                    f"{launched}, expected {want}")
        check(evals["conv_fused"]["top1"] >= 99.0,
              f"{name} conv eval top-1 {evals['conv_fused']['top1']} < 99")
        if md.stochastic:
            check(all(evals["conv_fused_again"][k] == evals["conv_fused"][k]
                      for k in ("top1", "top5", "loss")),
                  f"{name}: two evals with --seed {args.seed} differ")
            # no table or circuit represents a dead zone: refused
            res["refusals"] = {}
            for flag in (["--lut"], ["--gates", "dnf"]):
                try:
                    cli.main(base + flag)
                except ValueError as e:
                    res["refusals"][flag[0]] = str(e)
                check("stochastic at inference" in res["refusals"].get(
                    flag[0], ""), f"{name} {flag[0]} was not refused")
        if tables:
            check(evals["lut"]["top1"] >= 99.0,
                  f"{name} LUT eval top-1 {evals['lut']['top1']} < 99")
            for run in ("gates_dnf", "gates_cnf"):
                check(all(evals[run][k] == evals["lut"][k]
                          for k in ("top1", "top5", "loss")),
                      f"{name} eval {run} differs from the LUT's")
        res["evals"] = evals
        # (d) main --mode serve (tables where there are, else conv): each
        # answer's top-5 equal to the direct forward's
        flags = ["--lut"] if tables else []
        answers, health, counts = serve_requests(
            ["--model", name, "--ckpt", str(weights), *flags], reqs,
            batch=8)
        smodel = md.init(seed=args.seed, device=dev)
        cli.load_checkpoint(smodel, str(weights))
        direct = fam.lut(fam.lut_compile(smodel), smodel, reqs.to(dev)) \
            if tables else cli._keyed(
                lambda xb, **k: fam.conv(smodel, xb, **k), md.stochastic,
                args.seed)(reqs.to(dev))
        direct = torch.topk(torch.softmax(direct, -1), 5).indices.tolist()
        agree = sum(a["top5"] == d for a, d in zip(answers, direct))
        res["serve"] = {"requests": len(answers), "top5_equal": agree,
                        "launches": counts}
        if md.stochastic:
            # each batch draws its own flips, and the batcher decides which
            # requests share one: finite, well-formed answers
            check(len(answers) == len(reqs) and all(
                len(set(a["top5"])) == 5 and all(0 <= c < 10
                                                 for c in a["top5"])
                and np.isfinite(a["probs"]).all() for a in answers),
                f"{name} serve: malformed answers {answers}")
        else:
            check(agree == len(answers), f"{name} serve: top-5 of "
                  f"{len(answers) - agree} answers differ")
        # (e) main --mode compile --verilog: its circuits' gate count equals
        # the in-process circuits'
        if tables:
            summary = cli.main(["--mode", "compile", "--model", name,
                                "--ckpt", str(weights), "--compile_out",
                                str(mwork / "compile"), "--verilog"])
            res["compile"] = {"blocks": sorted(summary["blocks"]),
                              "total_gates": summary["total_gates"],
                              "verilog_total_gates":
                                  summary["verilog"]["total_gates"]}
            check(summary["verilog"]["total_gates"] == total_gates(gnets),
                  f"{name} --mode compile: Verilog "
                  f"{summary['verilog']['total_gates']} gates, circuits "
                  f"{total_gates(gnets)}")
        emit("fhe_model", model=name, batch=B, **{
            k: v for k, v in res.items() if k != "evals"})
        results[name] = res
        shutil.rmtree(mwork)
        del model
    (out_dir / "fhe_cases.json").write_text(json.dumps(cases, indent=1))
    shutil.rmtree(work)
    return {"models": results, **cases}


def cpu_drawn_key(seed: int):
    """A ``NoiseKey`` whose coin flips are drawn on the CPU and moved to the
    input's device, so that a step on the card and one on the CPU see the
    same flips (the card's generator draws other bits than the CPU's)."""
    from scale_imagenet_tpu_torch.ops import NoiseKey

    class CpuDrawnKey(NoiseKey):
        def draw(self, x: torch.Tensor) -> torch.Tensor:
            return super().draw(torch.empty(x.shape, dtype=x.dtype)).to(
                x.device)

    return CpuDrawnKey(seed)


def main_train(argv: list, steps: int, batch: int, what: str,
               factory: str = "make_train_step") -> dict:
    """``main --mode train`` (``argv``, one epoch of ``steps`` steps at
    ``batch``): ms a step and img/s over steps 2.., the idle share over
    them, peak device memory, the first and last loss and the port's
    kernel launches of the run (the counts set to 0 just before it).
    ``factory``: the step factory of ``main`` that the run takes
    (``make_robust_train_step`` under the robustness losses)."""
    from scale_imagenet_tpu_torch import main as cli

    timer = StepTimer(steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_kernel_launches()
    real_make = getattr(cli, factory)
    t = time.perf_counter()
    with mock.patch.object(
            cli, factory,
            lambda *a, **k: timer.wrap(real_make(*a, **k))), \
            torch.enable_grad():
        summary = cli.main(argv)
    torch.cuda.synchronize()
    losses = [float(v) for v in timer.losses]
    wall = timer.t1 - timer.t0
    run = {"steps": timer.calls, "timed_steps": steps - 1,
           "step_ms": wall * 1e3 / (steps - 1),
           "train_img_s": (steps - 1) * batch / wall,
           "device_idle_share": 1 - timer.busy_s / wall,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "resident_before_gb": resident / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1],
           "run_s": time.perf_counter() - t,
           "launches": kernel_launches()}
    check(timer.calls == steps and summary["step"] == steps,
          f"{what} train: {timer.calls} steps, expected {steps}")
    check(all(np.isfinite(losses)), f"{what} train losses {losses}")
    check(not any(run["launches"].values()),
          f"{what} train launched {run['launches']}")
    return run


def fhe_train_phase(args, out_dir: Path) -> dict:
    """Training of the TT_FHE family at full width (module docstring,
    phase 13)."""
    from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.ops import NoiseKey
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    B, n = args.batch, FHE_TRAIN_IMAGES
    work = Path("build") / "chip_smoke_fhe_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = np.random.default_rng(args.seed + 50)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, n).astype(np.int32)), str(work / "shards"),
        shard_size=B)
    steps = n // B
    gen = torch.Generator().manual_seed(args.seed + 51)
    x = torch.randn((B, 32, 32, 3), generator=gen)
    y = torch.randint(0, 10, (B,), generator=gen)
    results = {}
    for name in FHE_NAMES:
        md = get_model(name)
        # (a) main --mode train, one epoch from the 32x32 shards (the flip
        # on the card)
        run = main_train(["--mode", "train", "--model", name,
                          "--shards_dir", str(work / "shards"),
                          "--train_batch_size", str(B), "--seed",
                          str(args.seed), "--root_dir", str(work / name),
                          "--max_epochs", "1"], steps, B, name)
        # (b) ten steps on one batch lower the loss; the Bi-Real stem's
        # alpha and beta get gradients
        model = md.init(seed=args.seed, device="cuda")
        opt, _ = make_optimizer(0.1)
        ts = TrainState(model, opt.init(dict(model.named_parameters())))
        step = make_train_step(model, opt)
        root = NoiseKey(args.seed) if md.stochastic else None
        xb, yb = x.cuda(), y.cuda()
        overfit, stem_grads = [], None
        for i in range(10):
            ts, m = step(ts, xb, yb,
                         noise=None if root is None else root.child(i))
            overfit.append(m["loss"])
            if i == 0 and name == "TT_FHE_SMALL_bireal":
                act = model.stem_act
                stem_grads = {"alpha_a": float(act.alpha_a.grad),
                              "beta_a": float(act.beta_a.grad)}
        overfit = [float(v) for v in overfit]
        check(all(np.isfinite(overfit)) and overfit[-1] < overfit[0],
              f"{name}: ten steps on one batch did not lower the loss: "
              f"{overfit}")
        if name == "TT_FHE_SMALL_bireal":
            check(all(g != 0.0 for g in stem_grads.values()),
                  f"{name}: stem gradients {stem_grads}")
        del model, ts, step, opt
        # (c) one f32 step on the card and on the CPU, the same weights,
        # batch and flips
        parity = card_cpu_step(
            md.init(seed=args.seed, device="cuda"), x[:PARITY_BATCH],
            y[:PARITY_BATCH],
            cpu_drawn_key(args.seed + 52) if md.stochastic else None)
        check_parity(parity, f"{name} step")
        results[name] = {"train": run, "overfit": overfit,
                         "stem_grads": stem_grads, "parity": parity}
        emit("fhe_train", model=name, batch=B, images=n, **run,
             overfit_losses=overfit, stem_grads=stem_grads,
             step_parity=parity)
        shutil.rmtree(work / name)
    shutil.rmtree(work)
    return results


def calibrate_bns(apply, x: torch.Tensor) -> None:
    """Every BN's running statistics (stock and ``StatsBN`` alike) set to
    the batch statistics of one training-mode forward ``apply(x, stats)``:
    with the init's statistics the 2-bit quantizers of a random network
    saturate and every image gets one label.  Both kinds return ``0.9 *
    running + 0.1 * batch``, which is inverted here."""
    stats: dict = {}
    apply(x, stats)
    for bn, (mean, var) in stats.items():
        bn.running_mean.copy_((mean - 0.9 * bn.running_mean) / 0.1)
        bn.running_var.copy_(((var - 0.9 * bn.running_var) / 0.1)
                             .clamp(min=0.0))


def standardize_fc(fc, z: torch.Tensor) -> None:
    """Scale and shift a Linear's rows so that its logits ``z`` over a batch
    have mean 0 and standard deviation 1 per class, so that labels spread
    over the classes."""
    std = z.std(0)
    spread = std > 1e-3           # a class whose logit varies at all
    scale = torch.where(spread, 1.0 / std, torch.ones_like(std))
    fc.weight.mul_(scale[:, None])
    fc.bias.sub_(torch.where(spread, z.mean(0), torch.zeros_like(std)))
    fc.bias.mul_(scale)


def fit_train_steps(model, xt, yt, steps: int, what: str,
                    make_step=None) -> dict:
    """``steps`` f32 train steps of a copy of ``model`` at the batch of
    ``xt`` (half of it where that does not fit in the card's memory): the
    batch that ran, ms a step over steps 2.., peak device memory.
    ``make_step(net, opt)``: the step (``make_train_step``'s by
    default)."""
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    B = len(xt)
    for tb in (B, B // 2):
        opt, _ = make_optimizer(0.1)
        net = copy.deepcopy(model)
        ts = TrainState(net, opt.init(dict(net.named_parameters())))
        step = (make_step or make_train_step)(net, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, oom = [], False
        try:
            with torch.enable_grad():
                ts, m = step(ts, xt[:tb], yt[:tb])
                losses.append(m["loss"])
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(steps - 1):
                    ts, m = step(ts, xt[:tb], yt[:tb])
                    losses.append(m["loss"])
                torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            oom = True
        if oom:
            # outside the handler, so that its traceback frees the tensors
            del net, ts, step, opt, losses
            torch.cuda.empty_cache()
            continue
        step_ms = (time.perf_counter() - t) * 1e3 / (steps - 1)
        train = {"batch": tb, "fits_b256": tb == B, "steps": steps,
                 "losses": [float(v) for v in losses], "step_ms": step_ms,
                 "train_img_s": tb / step_ms * 1e3,
                 "max_memory_allocated_gb":
                     torch.cuda.max_memory_allocated() / 1e9}
        del net, ts, step, opt
        torch.cuda.empty_cache()
        check(all(np.isfinite(train["losses"])),
              f"{what} train {train['losses']}")
        return train
    fail(f"{what} training fits neither B={B} nor {B // 2}")


def v1_phase(args, out_dir: Path) -> dict:
    """The v1 ImageNet family at full width (module docstring, phase 14)."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import \
        V1_STAGES, ttnet_v1_apply
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, V1_EVAL_IMAGES
    work = Path("build") / "chip_smoke_v1"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = torch.device("cuda")
    md = get_model(V1_NAME)
    model = md.init(seed=args.seed, device=dev)
    perturb_bn(model, args.seed + 60)
    gen = torch.Generator().manual_seed(args.seed + 61)
    x = torch.rand((B, 224, 224, 3), generator=gen).to(dev)

    # (a) the forward at B and at 1, and where its device time goes
    ref = ttnet_v1_apply(model, x)
    check(ref.shape == (B, 1000) and bool(torch.isfinite(ref).all()),
          "v1 logits non-finite or misshapen")
    x1 = x[:1].contiguous()
    fwd = {"b256_ms": wall_ms(lambda: ttnet_v1_apply(model, x), 5),
           "b1_ms": wall_ms(lambda: ttnet_v1_apply(model, x1), 20)}
    fwd["b256_img_s"] = B / fwd["b256_ms"] * 1e3
    emit("v1_model", model=V1_NAME, batch=B, fcsize=md.config.fcsize,
         params=sum(p.numel() for p in model.parameters()),
         blocks=[[b.in_planes, b.out_planes, b.stride]
                 for b in md.config.block_configs()], **fwd)
    convs = profile_forward("v1", lambda: ttnet_v1_apply(model, x), B,
                            out_dir)
    del ref

    # (b) main --mode eval over shards labelled by its own forward.  With
    # the init's BN statistics every 2-bit quantizer of a random network
    # saturates and every image gets one label: the statistics are set
    # from the first batch's (the momentum update of one training-mode
    # forward inverted), and the Linear's rows scaled and shifted to
    # standardize its logits over that batch, so that the labels spread
    imgs = np.random.default_rng(args.seed + 62).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    first = prepare(torch.from_numpy(imgs[:B]).cuda())
    calibrate_bns(lambda xb, st: ttnet_v1_apply(model, xb, st), first)
    standardize_fc(model.fc, ttnet_v1_apply(model, first))
    labels = self_labelled_shards(lambda xb: ttnet_v1_apply(model, xb), imgs,
                                  B, work / "shards")
    del imgs
    weights = work / "weights.pth"
    torch.save(model.state_dict(), weights)
    ev = main_eval(["--mode", "eval", "--model", V1_NAME, "--shards_dir",
                    str(work / "shards"), "--eval_batch_size", str(B),
                    "--ckpt", str(weights), "--root_dir",
                    str(work / "logs")], False, images=n)
    emit("v1_eval", images=n, classes_hit=int(np.unique(labels).size),
         convolutions_per_forward=convs, **ev)
    check(ev["top1"] >= 99.9, f"v1 eval top-1 {ev['top1']} < 99.9")
    check(not any(ev["launches"].values()),
          f"v1 eval launched {ev['launches']}")

    # (c) main --mode serve: each answer's top-5 equal to the direct
    # forward's at the server's padded batch
    reqs = torch.rand((8, 224, 224, 3), generator=gen)
    answers, health, launches = serve_requests(
        ["--model", V1_NAME, "--ckpt", str(weights)], reqs, batch=8)
    direct = torch.topk(torch.softmax(ttnet_v1_apply(model, reqs.to(dev)),
                                      -1), 5).indices.tolist()
    agree = sum(a["top5"] == d for a, d in zip(answers, direct))
    emit("v1_serve", requests=len(answers), top5_equal=agree,
         launches=launches, healthz=health)
    check(agree == len(answers),
          f"v1 serve: top-5 of {len(answers) - agree} answers differ")

    # (d) three f32 train steps at B (B / 2 if B does not fit): ms and
    # peak device memory
    yt = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    xt = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    train = fit_train_steps(model, xt, yt, V1_TRAIN_STEPS, "v1")
    emit("v1_train", **train)
    del xt, yt
    torch.cuda.empty_cache()

    # (e) the other nine stage tables at full width: one B = 16 forward
    x16 = x[:16]
    others = {}
    for name in V1_STAGES:
        if name == V1_NAME:
            continue
        m = get_model(name).init(seed=args.seed, device=dev)
        out = ttnet_v1_apply(m, x16)
        torch.cuda.synchronize()
        others[name] = {"shape": list(out.shape),
                        "finite": bool(torch.isfinite(out).all()),
                        "fcsize": m.cfg.fcsize}
        check(others[name]["shape"] == [len(x16), 1000]
              and others[name]["finite"], f"v1 {name}: logits "
                                          f"{others[name]}")
        del m, out
    emit("v1_others", batch=16, models=others)
    shutil.rmtree(work)
    return {"model": fwd, "eval": ev, "serve_launches": launches,
            "train": train, "others": others}


def overfit_steps(model, x, y, noise_root=None, lr: float = 0.1,
                  steps: int = 10) -> list:
    """``steps`` f32 steps (SGD at ``lr``) on one batch: the losses, whose
    last three must average below the first (a stochastic model's flips
    keyed by the step)."""
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    opt, _ = make_optimizer(lr)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    losses = []
    with torch.enable_grad():
        for i in range(steps):
            ts, m = step(ts, x, y, noise=None if noise_root is None
                         else noise_root.child(i))
            losses.append(m["loss"])
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0],
          f"ten steps on one batch did not lower the loss: {losses}")
    return losses


def zoo_model(name: str, seed: int, x: torch.Tensor, **kw):
    """``name`` at its registry default width (``kw`` added) from ``seed``
    on the card, its BNs set to ``x``'s statistics and a float Linear head
    standardized over it (``calibrate_bns``, ``standardize_fc``): ``(md,
    model, apply)``, ``apply(x)`` its forward (a stochastic one keyed by a
    fresh child of ``NoiseKey(seed)`` a call, as ``main`` keys it)."""

    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.ops import NoiseKey

    md = get_model(name, **kw)
    model = md.init(seed=seed, device="cuda")
    keys = NoiseKey(seed + 1).child if md.stochastic else None
    calls = itertools.count()

    def apply(xb, stats=None):
        if keys is None:
            return model(xb, stats)
        return model(xb, stats, noise=keys(next(calls)))

    calibrate_bns(apply, x)
    fc = getattr(model, "fc2", getattr(model, "fc", None))
    if isinstance(fc, torch.nn.Linear) and fc.bias is not None and \
            name.startswith(("TT_", "mobilenet", "tt_")):
        standardize_fc(fc, apply(x))
    return md, model, apply


def self_labelled_eval(name: str, argv: list, apply, imgs: np.ndarray,
                       work: Path, model, stochastic: bool, seed: int):
    """Shards of ``imgs`` labelled by ``apply``, the model's weights saved,
    then ``main --mode eval`` (``argv``) over them: its numbers, and the
    labels' class count.  A stochastic model runs twice from one
    ``--seed``, whose metrics must be equal; the others must reach top-1
    >= 99.9 % (the same function)."""
    B = 256
    labels = self_labelled_shards(apply, imgs, B, work / "shards")
    weights = work / "weights.pth"
    torch.save(model.state_dict(), weights)
    base = ["--mode", "eval", "--model", name, *argv, "--shards_dir",
            str(work / "shards"), "--eval_batch_size", str(B), "--ckpt",
            str(weights), "--seed", str(seed), "--root_dir",
            str(work / "logs")]
    ev = main_eval(base, False, images=len(imgs))
    ev["classes_hit"] = int(np.unique(labels).size)
    check(not any(ev["launches"].values()),
          f"{name} eval launched {ev['launches']}")
    if stochastic:
        again = main_eval(base, False, images=len(imgs))
        same = all(ev[k] == again[k] for k in ("top1", "top5", "loss"))
        ev["repeat"] = {k: again[k] for k in ("top1", "top5", "loss",
                                               "img_s")}
        check(same, f"{name}: two evals from one --seed differ: {ev} "
                    f"{again}")
    else:
        check(ev["top1"] >= 99.9, f"{name} eval top-1 {ev['top1']} < 99.9")
    return ev, weights


def served_top5(name: str, argv: list, weights: Path, model, apply,
                reqs: torch.Tensor, stochastic: bool) -> dict:
    """``main --mode serve``: each answer's top-5 equal to a direct forward's
    at the server's batch, up to the order of tied logits (the binarized
    heads of ``model_general`` and ``cifar10lownoise`` round theirs to
    integers), or, for a stochastic model, five distinct classes (its
    flips differ a batch)."""
    answers, health, launches = serve_requests(
        ["--model", name, *argv, "--ckpt", str(weights)], reqs,
        batch=len(reqs))
    got = [a["top5"] for a in answers]
    if stochastic:
        classes = model.cfg.num_classes
        ok = all(len(t) == 5 and len(set(t)) == 5
                 and all(0 <= k < classes for k in t) for t in got)
        agree = None
    else:
        logits = apply(reqs.cuda()).float().cpu()
        top = torch.topk(logits, 5)
        agree = sum(a == d for a, d in zip(got, top.indices.tolist()))
        # the logits of the served classes are the direct top-5's
        ok = all(torch.equal(logits[i, t], top.values[i])
                 for i, t in enumerate(got))
    check(ok, f"{name} serve: answers {got}")
    check(not any(launches.values()), f"{name} serve launched {launches}")
    return {"requests": len(got), "top5_equal": agree, "healthz": health,
            "launches": launches}


def general_phase(args, out_dir: Path) -> dict:
    """The TT_general float family at full width (module docstring,
    phase 15)."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, ZOO_EVAL_IMAGES
    work = Path("build") / "chip_smoke_general"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start_phase_launches()
    dev = torch.device("cuda")
    imgs = np.random.default_rng(args.seed + 70).integers(
        0, 256, (n, 224, 224, 3), dtype=np.uint8)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    first = prepare(torch.from_numpy(imgs[:B]).cuda())
    md, model, apply = zoo_model(GENERAL_NAME, args.seed, first, layers=18)

    # (a) the forward at B and at 1, and where its device time goes
    gen = torch.Generator().manual_seed(args.seed + 71)
    x = torch.rand((B, 224, 224, 3), generator=gen).to(dev)
    out = apply(x)
    check(out.shape == (B, 1000) and bool(torch.isfinite(out).all()),
          "TT_general logits non-finite or misshapen")
    x1 = x[:1].contiguous()
    fwd = {"b256_ms": wall_ms(lambda: apply(x), 5),
           "b1_ms": wall_ms(lambda: apply(x1), 20)}
    fwd["b256_img_s"] = B / fwd["b256_ms"] * 1e3
    emit("general_model", model=GENERAL_NAME, batch=B,
         fcsize=md.config.fcsize,
         params=sum(p.numel() for p in model.parameters()),
         blocks=[[b.in_planes, b.out_planes, b.stride]
                 for b in md.config.block_configs()], **fwd)
    convs = profile_forward("general", lambda: apply(x), B, out_dir)
    del out

    # (b) main --mode eval over shards labelled by its own forward
    argv = ["--layers", "18"]
    ev, weights = self_labelled_eval(GENERAL_NAME, argv, apply, imgs, work,
                                     model, False, args.seed)
    del imgs
    emit("general_eval", images=n, convolutions_per_forward=convs, **ev)

    # (c) main --mode serve, five requests
    reqs = torch.rand((5, 224, 224, 3), generator=gen)
    serve = served_top5(GENERAL_NAME, argv, weights, model, apply, reqs,
                        False)
    emit("general_serve", **serve)

    # (d) three f32 train steps at B (B / 2 if B does not fit)
    yt = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    xt = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    train = fit_train_steps(model, xt, yt, ZOO_TRAIN_STEPS, GENERAL_NAME)
    emit("general_train", **train)
    del xt, yt, model
    torch.cuda.empty_cache()

    # (e) the other variants at their default widths: one B = 16 forward
    others, x16 = {}, x[:16]
    for name in GENERAL_OTHERS:
        m = get_model(name).init(seed=args.seed, device=dev)
        out = m(x16)
        torch.cuda.synchronize()
        others[name] = {"shape": list(out.shape),
                        "finite": bool(torch.isfinite(out).all()),
                        "p": m.cfg.p, "fcsize": m.cfg.fcsize,
                        "params": sum(q.numel() for q in m.parameters())}
        check(others[name]["shape"] == [len(x16), m.cfg.num_classes]
              and others[name]["finite"], f"{name}: logits {others[name]}")
        del m, out
    launches = phase_launches()
    emit("general_others", batch=len(x16), models=others,
         phase_launches=launches)
    check(not any(launches.values()), f"general phase launched {launches}")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"model": fwd, "eval": ev, "serve": serve, "train": train,
            "others": others, "launches": launches}


def cifar_zoo_phase(args, out_dir: Path) -> dict:
    """The CIFAR zoo at 32x32 (module docstring, phase 16)."""
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, write_shards
    from scale_imagenet_tpu_torch.ops import NoiseKey
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, ZOO_EVAL_IMAGES
    work = Path("build") / "chip_smoke_cifar_zoo"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start_phase_launches()
    rng = np.random.default_rng(args.seed + 80)
    imgs = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (ZOO_TRAIN_IMAGES, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, ZOO_TRAIN_IMAGES).astype(np.int32)),
        str(work / "train"), shard_size=B)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    first = prepare(torch.from_numpy(imgs[:B]).cuda())
    gen = torch.Generator().manual_seed(args.seed + 81)
    x = torch.rand((B, 32, 32, 3), generator=gen).cuda()
    xt = torch.randn((B, 32, 32, 3), generator=gen)
    yt = torch.randint(0, 10, (B,), generator=gen)
    reqs = torch.rand((8, 32, 32, 3), generator=gen)
    steps = ZOO_TRAIN_IMAGES // B
    results = {}
    for name in CIFAR_ZOO:
        mwork = work / name
        mwork.mkdir()
        argv = ZOO_CLI_WIDTH.get(name, [])
        md, model, apply = zoo_model(name, args.seed, first)
        # (a) the forward at B
        out = apply(x)
        check(out.shape == (B, 10) and bool(torch.isfinite(out).all()),
              f"{name} logits non-finite or misshapen")
        fwd_ms = wall_ms(lambda: apply(x), 10)
        # (b) main --mode eval over self-labelled shards; (c) serve
        ev, weights = self_labelled_eval(name, argv, apply, imgs, mwork,
                                         model, md.stochastic, args.seed)
        serve = served_top5(name, argv, weights, model, apply, reqs,
                            md.stochastic)
        # (d) main --mode train over the 32x32 shards
        run = main_train(["--mode", "train", "--model", name, *argv,
                          "--shards_dir", str(work / "train"),
                          "--train_batch_size", str(B), "--seed",
                          str(args.seed), "--root_dir", str(mwork / "run"),
                          "--max_epochs", "1"], steps, B, name)
        # (e) ten steps on one batch
        root = NoiseKey(args.seed + 2) if md.stochastic else None
        overfit = overfit_steps(md.init(seed=args.seed, device="cuda"),
                                xt[:OVERFIT_BATCH].cuda(),
                                yt[:OVERFIT_BATCH].cuda(), root,
                                OVERFIT_LR.get(name, 0.1))
        # (f) one f32 step, card against CPU, the same weights, batch and
        # flips
        parity = None
        if name in ("model_general", "tt_certif"):
            with torch.enable_grad():
                parity = card_cpu_step(
                    md.init(seed=args.seed, device="cuda"),
                    xt[:PARITY_BATCH], yt[:PARITY_BATCH],
                    cpu_drawn_key(args.seed + 3) if md.stochastic else None)
            check_parity(parity, f"{name} step")
        results[name] = {"forward_ms": fwd_ms, "eval": ev, "serve": serve,
                         "train": run, "overfit": overfit,
                         "parity": parity}
        emit("cifar_zoo", model=name, batch=B, images=n,
             params=sum(p.numel() for p in model.parameters()),
             forward_b256_ms=fwd_ms, forward_img_s=B / fwd_ms * 1e3,
             eval=ev, serve=serve, train=run, overfit_losses=overfit,
             step_parity=parity)
        del model, out
        shutil.rmtree(mwork)
        torch.cuda.empty_cache()
    launches = phase_launches()
    emit("cifar_zoo_launches", phase_launches=launches)
    check(not any(launches.values()), f"cifar_zoo phase launched {launches}")
    shutil.rmtree(work)
    return {"models": results, "launches": launches}


def resnet_phase(args, out_dir: Path) -> dict:
    """The DoReFa ResNets (module docstring, phase 17)."""
    from scale_imagenet_tpu_torch.convert.bn_fold import fold_model_bns
    from scale_imagenet_tpu_torch.convert.fuse_quant import fuse_resnet
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B, n = args.batch, ZOO_EVAL_IMAGES
    work = Path("build") / "chip_smoke_resnet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start_phase_launches()
    dev = torch.device("cuda")
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    rng = np.random.default_rng(args.seed + 90)
    imgs = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    first = prepare(torch.from_numpy(imgs[:B]).cuda())
    bits = ["--model_arg", "wbit=4", "--model_arg", "abit=4"]
    md, model, apply = zoo_model(RESNET_NAME, args.seed, first, wbit=4,
                                 abit=4)

    # (a) the forward at B and at 1, and where its device time goes
    gen = torch.Generator().manual_seed(args.seed + 91)
    x = torch.rand((B, 224, 224, 3), generator=gen).to(dev)
    ref = apply(x)
    check(ref.shape == (B, 1000) and bool(torch.isfinite(ref).all()),
          "resnet50 logits non-finite or misshapen")
    x1 = x[:1].contiguous()
    fwd = {"b256_ms": wall_ms(lambda: apply(x), 5),
           "b1_ms": wall_ms(lambda: apply(x1), 20)}
    fwd["b256_img_s"] = B / fwd["b256_ms"] * 1e3
    emit("resnet_model", model=RESNET_NAME, wbit=4, abit=4, batch=B,
         params=sum(p.numel() for p in model.parameters()), **fwd)
    convs = profile_forward("resnet50", lambda: apply(x), B, out_dir)

    # (b) main --mode eval over self-labelled shards, plain (bounded),
    # --fuse_quant and --fold_bn (recorded; the fold re-quantizes the
    # folded weights at wbit < 32, as in the JAX package)
    ev, weights = self_labelled_eval(RESNET_NAME, bits, apply, imgs, work,
                                     model, False, args.seed)
    del imgs
    base = ["--mode", "eval", "--model", RESNET_NAME, *bits, "--shards_dir",
            str(work / "shards"), "--eval_batch_size", str(B), "--ckpt",
            str(weights), "--root_dir", str(work / "logs")]
    ev_fuse = main_eval(base + ["--fuse_quant"], False, images=n)
    ev_fold = main_eval(base + ["--fold_bn"], False, images=n)
    # the transforms in-process against the unfolded forward at B.  In
    # f32 the fold's rounding moves some conv outputs across a 4-bit
    # activation step and the 53 quantized convs carry the change on, so
    # the f32 agreement is recorded; the function itself is held in f64,
    # where rounding crosses no step: fused quant at wbit 4, and the fold
    # where it is exact (wbit 32)
    agree = {}

    def agreement(net, want, xb):
        return float((net(xb).argmax(1) == want.argmax(1)).float().mean())

    fused = copy.deepcopy(model)
    fuse_resnet(fused)
    agree["fuse_quant_w4_f32"] = agreement(fused, ref, x)
    # the first batch of the eval's normalized shard images too
    agree["fuse_quant_w4_f32_shards"] = agreement(fused, apply(first), first)
    folded = copy.deepcopy(model)
    fold_model_bns(folded)
    agree["fold_bn_w4_f32"] = agreement(folded, ref, x)
    del fused, folded
    m64, x64, first64 = copy.deepcopy(model).double(), x.double(), \
        first.double()
    ref64 = m64(x64)
    fused = copy.deepcopy(m64)
    fuse_resnet(fused)
    agree["fuse_quant_w4_f64"] = agreement(fused, ref64, x64)
    agree["fuse_quant_w4_f64_shards"] = agreement(fused, m64(first64),
                                                  first64)
    del fused, first64
    m64.cfg = dataclasses.replace(m64.cfg, wbit=32)
    ref64 = m64(x64)
    fold_model_bns(m64)
    agree["fold_bn_w32_f64"] = agreement(m64, ref64, x64)
    del m64, x64, ref64
    torch.cuda.empty_cache()
    emit("resnet_eval", images=n, convolutions_per_forward=convs, **ev,
         fuse_quant=ev_fuse, fold_bn=ev_fold, top1_agreement=agree)
    check(min(agree["fuse_quant_w4_f64"], agree["fuse_quant_w4_f64_shards"],
              agree["fold_bn_w32_f64"]) >= 0.99,
          f"resnet transforms' top-1 agreement {agree}")
    for e in (ev_fuse, ev_fold):
        check(not any(e["launches"].values()),
              f"resnet eval launched {e['launches']}")

    # (c) three f32 train steps at B (B / 2 if B does not fit)
    yt = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    xt = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    train = fit_train_steps(model, xt, yt, ZOO_TRAIN_STEPS, RESNET_NAME)
    emit("resnet_train", **train)
    del xt, yt, model, ref
    torch.cuda.empty_cache()

    # (d) resnet18_cifar: eval over 32x32 self-labelled shards, ten steps
    imgs32 = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    first32 = prepare(torch.from_numpy(imgs32[:B]).cuda())
    cname = "resnet18_cifar"
    cwork = work / cname
    cwork.mkdir()
    cmd, cmodel, capply = zoo_model(cname, args.seed, first32)
    cev, _ = self_labelled_eval(cname, [], capply, imgs32, cwork, cmodel,
                                False, args.seed)
    overfit = overfit_steps(cmd.init(seed=args.seed, device="cuda"),
                            first32[:OVERFIT_BATCH], torch.randint(
                                0, 1000, (OVERFIT_BATCH,),
                                generator=gen).cuda())
    emit("resnet_cifar", model=cname, images=n, eval=cev,
         forward_b256_ms=wall_ms(lambda: capply(first32), 10),
         overfit_losses=overfit)
    del cmodel, imgs32

    # (e) the other eight names: built, one B = 16 forward each
    others, x16 = {}, x[:16]
    for name in RESNET_OTHERS:
        m = get_model(name).init(seed=args.seed, device=dev)
        side = 32 if name.endswith("_cifar") else 224
        out = m(x16[:, :side, :side])
        torch.cuda.synchronize()
        others[name] = {"shape": list(out.shape),
                        "finite": bool(torch.isfinite(out).all()),
                        "params": sum(q.numel() for q in m.parameters())}
        check(others[name]["shape"] == [len(x16), 1000]
              and others[name]["finite"], f"{name}: logits {others[name]}")
        del m, out
    launches = phase_launches()
    emit("resnet_others", batch=len(x16), models=others,
         phase_launches=launches)
    check(not any(launches.values()), f"resnet phase launched {launches}")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"model": fwd, "eval": ev, "fuse_quant": ev_fuse,
            "fold_bn": ev_fold, "agreement": agree, "train": train,
            "cifar": cev, "others": others, "launches": launches}


ROBUST_MODELS = ("tt_certif", "cifar10lownoise", "model_general")
ROBUST_EPS = 2 / 255               # the certify and attack radius, pixels
ROBUST_EVAL_IMAGES = 1280          # 5 batches of B = 256 a model
ROBUST_FLAGSHIP_IMAGES = 512       # 2 batches of B = 256 an attack
ROBUST_POINTS = 16                 # soundness: points a image in the ball
ROBUST_TRAIN_LOSSES = ["--stability_eps", "0.01", "--abstract_eps", "0.01",
                       "--bias_decay", "0.001"]


def interval_checks(md, model, x: torch.Tensor, key_root) -> dict:
    """``md.interval_logits`` of ``model`` over the pixel ball around the
    normalized images ``x`` on the card: every concrete logit at
    ``ROBUST_POINTS`` points a image drawn in the ball (a stochastic
    model's coin flips fresh at each) within the bounds (1e-5 relative);
    the bounds of a CPU copy from the same weights and images within 1e-4
    and the two certified masks (the card's predictions) agreeing on >= 99
    % of the images."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.robust.interval import certified_mask
    from scale_imagenet_tpu_torch.train.steps import _pixel_ball

    ball = _pixel_ball(ROBUST_EPS, (IMAGENET_MEAN, IMAGENET_STD))
    eps, lo, hi = (b.cuda() for b in ball)
    kw = (lambda i: {"noise": key_root.child(i)}) if md.stochastic \
        else (lambda i: {})
    iv = md.interval_logits(model, x, eps, lo, hi)
    preds = model(x, **kw("clean")).argmax(-1)
    # the certificate's cost beside one forward's, at the same batch
    times = {"forward_ms": wall_ms(lambda: model(x, **kw("clean")), 5),
             "interval_logits_ms": wall_ms(
                 lambda: md.interval_logits(model, x, eps, lo, hi), 5)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for i in range(ROBUST_POINTS):
        u = torch.rand(x.shape, generator=gen, device="cuda") * 2 - 1
        if i == 0:
            u = torch.sign(u)                     # corners of the ball
        y = model(torch.minimum(torch.maximum(x + u * eps, lo), hi), **kw(i))
        below = (iv.vmin - y) / iv.vmin.abs().clamp(min=1.0)
        above = (y - iv.vmax) / iv.vmax.abs().clamp(min=1.0)
        worst = max(worst, float(below.max()), float(above.max()))
    cpu = copy.deepcopy(model).cpu()
    iv_cpu = md.interval_logits(cpu, x.cpu(), *ball)
    bound_err = max(
        float(((a.cpu() - b).abs() / b.abs().clamp(min=1.0)).max())
        for a, b in ((iv.vmin, iv_cpu.vmin), (iv.vmax, iv_cpu.vmax)))
    mask = certified_mask(iv, preds).cpu()
    mask_cpu = certified_mask(iv_cpu, preds.cpu())
    out = {"images": len(x), "points": ROBUST_POINTS,
           "worst_rel_violation": worst, "certified_card": int(mask.sum()),
           "certified_cpu": int(mask_cpu.sum()),
           "mask_agreement": float((mask == mask_cpu).float().mean()),
           "card_cpu_bound_rel_err": bound_err,
           "mean_bound_width": float((iv.vmax - iv.vmin).mean()), **times}
    check(worst <= 1e-5, f"{md.name}: concrete logits leave the interval "
                         f"bounds by {worst} relative")
    check(out["mask_agreement"] >= 0.99 and bound_err <= 1e-4,
          f"{md.name}: card vs CPU interval bounds {out}")
    return out


def robust_card_cpu_step(md, model, x, y, key, **losses) -> dict:
    """One f32 robust step (``make_robust_train_step`` with ``losses``) of
    ``model`` on the card and of its copy on the CPU from the same
    weights, batch and sign pattern (``key`` draws on the CPU): the
    bounds of ``card_cpu_step``."""
    from scale_imagenet_tpu_torch.train import TrainState, \
        make_optimizer, make_robust_train_step

    def one(net, xb, yb, sink):
        opt, _ = make_optimizer(0.1)
        ts = TrainState(net, opt.init(dict(net.named_parameters())))
        step = make_robust_train_step(md, net, opt, **losses)
        with heaviside_outputs(sink), torch.enable_grad():
            _, m = step(ts, xb, yb, noise=key)
        return float(m["loss"]), float(m["stability_loss"])

    from scale_imagenet_tpu_torch.kernels import fused_block as FB

    cpu_model = copy.deepcopy(model).cpu()
    start = [p.detach().cpu().clone() for p in model.parameters()]
    card_bits, cpu_bits = [], []
    reset_kernel_launches()
    with fused_blocks(True):
        card_loss, card_sloss = one(model, x.cuda(), y.cuda(), card_bits)
    torch.cuda.synchronize()
    fused_launches = FB.fused_pointwise_block.launches
    card_bits = [b.cpu() for b in card_bits]
    cpu_loss, cpu_sloss = one(cpu_model, x, y, cpu_bits)
    du = torch.cat([(p.detach().cpu() - s).double().ravel()
                    for p, s in zip(model.parameters(), start)])
    dv = torch.cat([(p.detach() - s).double().ravel()
                    for p, s in zip(cpu_model.parameters(), start)])
    check(len(card_bits) == len(cpu_bits),
          "the card and CPU robust steps ran different Heavisides")
    flips = sum(int((a != b).sum()) for a, b in zip(card_bits, cpu_bits))
    outputs = sum(a.numel() for a in card_bits)
    return {"batch": len(x), "card_loss": card_loss, "cpu_loss": cpu_loss,
            "card_stability_loss": card_sloss,
            "cpu_stability_loss": cpu_sloss,
            "rel_loss_gap": abs(card_loss - cpu_loss) / abs(cpu_loss),
            "update_cosine": float(du @ dv / (du.norm() * dv.norm())),
            "heaviside_outputs": outputs, "heaviside_flipped": flips,
            "flip_share": flips / outputs,
            "fused_launches_in_training": fused_launches}


def robust_phase(args, model, out_dir: Path) -> dict:
    """Certified and adversarial eval and robust training (module
    docstring, phase 18)."""
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, write_shards
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply, ttnet_imagenet_features
    from scale_imagenet_tpu_torch.ops import NoiseKey
    from scale_imagenet_tpu_torch.train import TrainState, \
        make_input_pipeline, make_optimizer, make_robust_train_step

    B = args.batch
    work = Path("build") / "chip_smoke_robust"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start_phase_launches()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 90)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    eps = str(ROBUST_EPS)
    robust_eval = ["--certify", eps, "--attack", "pgd", "--attack_eps", eps]

    # (a) the three robust models: certified + PGD eval, soundness, card
    # against CPU
    imgs = rng.integers(0, 256, (ROBUST_EVAL_IMAGES, 32, 32, 3),
                        dtype=np.uint8)
    first = prepare(torch.from_numpy(imgs[:B]).cuda())
    models = {}
    for name in ROBUST_MODELS:
        mwork = work / name
        mwork.mkdir()
        argv = ZOO_CLI_WIDTH.get(name, [])
        md, net, apply = zoo_model(name, args.seed, first)
        labels = self_labelled_shards(apply, imgs, B, mwork / "shards")
        weights = mwork / "weights.pth"
        torch.save(net.state_dict(), weights)
        ev = main_eval(["--mode", "eval", "--model", name, *argv,
                        "--shards_dir", str(mwork / "shards"),
                        "--eval_batch_size", str(B), "--ckpt", str(weights),
                        "--seed", str(args.seed), "--root_dir",
                        str(mwork / "logs"), *robust_eval], False,
                       images=len(imgs))
        ev["classes_hit"] = int(np.unique(labels).size)
        check(ev["cert"] <= ev["adv"],
              f"{name}: certified {ev['cert']} > adversarial {ev['adv']}")
        if not md.stochastic:
            check(ev["adv"] <= ev["top1"],
                  f"{name}: adversarial {ev['adv']} > clean {ev['top1']}")
        bounds = interval_checks(md, net, first, NoiseKey(args.seed + 91))
        models[name] = {"eval": ev, "bounds": bounds}
        emit("robust_eval", model=name, batch=B, images=len(imgs),
             eps=ROBUST_EPS, **ev, interval=bounds)
        del net
        shutil.rmtree(mwork)
        torch.cuda.empty_cache()
    del imgs, first

    # (b) the flagship under FGSM and PGD-10, the fused switch on
    fmd = get_model("ttnet_imagenet_small", nfilter=8, tfilter=8, layers=1)
    flag = copy.deepcopy(model)
    n = ROBUST_FLAGSHIP_IMAGES
    fimgs = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    with fused_blocks(False):
        fit_classifier_bn(flag.classifier, ttnet_imagenet_features(
            flag, prepare(torch.from_numpy(fimgs[:B]).cuda())))
        labels = self_labelled_shards(
            lambda xb: ttnet_imagenet_apply(flag, xb), fimgs, B,
            work / "flagship")
    weights = work / "flagship.pth"
    torch.save(flag.state_dict(), weights)
    del fimgs, flag
    torch.cuda.empty_cache()
    batches = -(-n // B)
    attacks = {}
    for kind in ("fgsm", "pgd"):
        torch.cuda.reset_peak_memory_stats()
        ev = main_eval(["--mode", "eval", "--shards_dir",
                        str(work / "flagship"), "--eval_batch_size", str(B),
                        "--ckpt", str(weights), "--root_dir",
                        str(work / "logs"), "--attack", kind,
                        "--attack_eps", eps], True, images=n)
        ev["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ev["classes_hit"] = int(np.unique(labels).size)
        attacks[kind] = ev
        emit("robust_flagship", attack=kind, batch=B, images=n,
             eps=ROBUST_EPS, steps=1 if kind == "fgsm" else 10, **ev)
        # the clean and the adversarial logits take the kernel, 6 launches
        # a forward; the attack's differentiated forwards none
        check(ev["launches"]["fused_pointwise_block"] == 2 * 6 * batches,
              f"flagship --attack {kind} launched {ev['launches']}, "
              f"expected {2 * 6 * batches} fused")
        check(ev["adv"] <= ev["top1"], f"flagship {kind}: adversarial "
                                       f"{ev['adv']} > clean {ev['top1']}")

    # (c) robust training
    gen = torch.Generator().manual_seed(args.seed + 92)
    write_shards(ArrayDataset(
        rng.integers(0, 256, (ZOO_TRAIN_IMAGES, 32, 32, 3), dtype=np.uint8),
        rng.integers(0, 10, ZOO_TRAIN_IMAGES).astype(np.int32)),
        str(work / "train"), shard_size=B)
    name = "cifar10lownoise"
    steps = ZOO_TRAIN_IMAGES // B
    run = main_train(["--mode", "train", "--model", name, "--shards_dir",
                      str(work / "train"), "--train_batch_size", str(B),
                      "--seed", str(args.seed), "--root_dir",
                      str(work / "run"), "--max_epochs", "1",
                      *ROBUST_TRAIN_LOSSES], steps, B, name,
                     factory="make_robust_train_step")
    md = get_model(name)
    losses = dict(eps=0.01, coeff=1e-4, abstract_eps=0.01,
                  abstract_coeff=1e-4, bias_coeff=1e-3, bias_thresh=6.0)
    # images in [0, 1], the robust step's default input range
    xt = torch.rand((OVERFIT_BATCH, 32, 32, 3), generator=gen).cuda()
    yt = torch.randint(0, 10, (OVERFIT_BATCH,), generator=gen).cuda()
    net = md.init(seed=args.seed, device="cuda")
    opt, _ = make_optimizer(0.1)
    ts = TrainState(net, opt.init(dict(net.named_parameters())))
    step = make_robust_train_step(md, net, opt, **losses)
    overfit = []
    with torch.enable_grad():
        for i in range(10):
            ts, m = step(ts, xt, yt, noise=NoiseKey(args.seed + 93).child(i))
            overfit.append(m["loss"])
    overfit = [float(v) for v in overfit]
    check(all(np.isfinite(overfit)) and np.mean(overfit[-3:]) < overfit[0],
          f"{name}: ten robust steps on one batch did not lower the loss: "
          f"{overfit}")
    parity = robust_card_cpu_step(
        md, md.init(seed=args.seed, device="cuda"), xt.cpu(), yt.cpu(),
        cpu_drawn_key(args.seed + 94), **losses)
    check_parity(parity, f"{name} robust step")
    emit("robust_train", model=name, batch=B, images=ZOO_TRAIN_IMAGES,
         flags=ROBUST_TRAIN_LOSSES, train=run, overfit_losses=overfit,
         step_parity=parity)
    del net, ts, step, opt

    # the flagship's multi-sample step: 3N images a forward
    fx = torch.rand((B // 2, 224, 224, 3), generator=gen).cuda()
    fy = torch.randint(0, 1000, (B // 2,), generator=gen).cuda()
    calls = itertools.count()

    def stability_step(net, opt):
        step = make_robust_train_step(fmd, net, opt, 0.01, 1e-4)
        return lambda ts, xb, yb: step(
            ts, xb, yb, noise=NoiseKey(args.seed + 95).child(next(calls)))

    flag_train = fit_train_steps(model, fx, fy, ZOO_TRAIN_STEPS,
                                 "flagship --stability_eps",
                                 make_step=stability_step)
    flag_train["packed_images"] = 3 * flag_train["batch"]
    flag_train["fits_b128"] = flag_train.pop("fits_b256")
    emit("robust_flagship_train", **flag_train)
    del fx, fy
    launches = phase_launches()
    phase_s = time.perf_counter() - t_phase
    emit("robust_launches", phase_launches=launches, phase_s=phase_s)
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"models": models, "attacks": attacks, "train": run,
            "overfit": overfit, "parity": parity,
            "flagship_train": flag_train, "launches": launches,
            "phase_s": phase_s}


# ------------------------------------------------------------ distributed

DIST_WORLD = 2                     # two ranks on the one card, over gloo
DIST_TIMEOUT_S = 900               # a rank past this is killed (a deadlock)
DIST_TOP_POINTS = 0.1              # top-1/5 within 0.1 points of one process
DIST_LOSS_REL = 1e-3               # loss within 1e-3 relative of it
# (c) the DP step's update and BN statistics against the plain step's: a
# sum of the ranks' gradients (twice the mean) or rank 0's statistics in
# place of their mean each lands far outside these
DIST_UPDATE_NORM_TOL = 1e-6        # |du| / |dv| within 1e-6 of 1
DIST_BN_STAT_TOL = 1e-6            # running mean/var within 1e-6 absolute


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def params_digest(model, keep=None) -> str:
    """sha256 of every parameter's and buffer's bytes (those whose name
    ``keep`` accepts), in state-dict order: equal digests are bit-equal
    weights and statistics."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if keep is not None and not keep(k):
            continue
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).contiguous()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rank_eval(argv: list) -> dict:
    """One rank's ``main --mode eval`` (``argv`` joins the ranks): the
    global metrics it returns, the images this rank scored (counted on the
    card), the eval loop's wall time and this rank's device idle share
    over it (its own kernels), the loop's time after its first batch
    (which, in a fresh process, also loads the kernels and sets up cuDNN:
    the card is synchronised once after it), its kernel launches (the
    counts set to 0 just before the run and read just after) and its peak
    device memory over the run."""
    from torch.profiler import ProfilerActivity, profile

    from scale_imagenet_tpu_torch import main as cli

    stats, scored = {}, []
    real_evaluate, real_step = cli.evaluate, cli.make_eval_step

    def timed(*a, **k):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            res = real_evaluate(*a, **k)
            torch.cuda.synchronize()
            stats["end_t"] = time.perf_counter()
            stats["wall_s"] = stats["end_t"] - t
        stats["busy_s"] = busy_ns(device_spans(prof)) / 1e9
        stats["images"] = k["totals"]["images"]
        return res

    def counting(*a, **k):
        step = real_step(*a, **k)

        def counted(images, labels):
            scored.append((labels >= 0).sum())
            out = step(images, labels)
            if len(scored) == 1:
                torch.cuda.synchronize()
                stats["first_t"] = time.perf_counter()
                stats["first_images"] = int(scored[0])
            return out
        return counted

    reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(cli, "evaluate", timed), \
            mock.patch.object(cli, "make_eval_step", counting):
        top1, top5, loss, *extras = cli.main(argv)
    torch.cuda.synchronize()
    return {"top1": top1, "top5": top5, "loss": loss,
            **(extras[0] if extras else {}),
            "rank_images": int(torch.stack(scored).sum()),
            "images": stats["images"], "eval_s": stats["wall_s"],
            "first_batch_images": stats["first_images"],
            "after_first_s": stats["end_t"] - stats["first_t"],
            "device_idle_share": 1 - stats["busy_s"] / stats["wall_s"],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": kernel_launches()}


def rank_train(argv: list, steps: int, batch: int) -> dict:
    """One rank's ``main --mode train`` of one epoch: img/s of the global
    batch over steps 2..``steps``, this rank's idle share and peak memory,
    the losses, the digest of its final weights, its launches."""
    from scale_imagenet_tpu_torch import main as cli

    timer = StepTimer(steps)
    models = []
    real_make, real_state = cli.make_train_step, cli.TrainState

    def capture(model, *a, **k):
        models.append(model)
        return real_state(model, *a, **k)

    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    with mock.patch.object(cli, "make_train_step",
                           lambda *a, **k: timer.wrap(real_make(*a, **k))), \
            mock.patch.object(cli, "TrainState", capture), \
            torch.enable_grad():
        summary = cli.main(argv)
    torch.cuda.synchronize()
    wall = timer.t1 - timer.t0
    return {"steps": timer.calls, "step": summary["step"],
            "train_img_s": (steps - 1) * batch / wall,
            "step_ms": wall * 1e3 / (steps - 1),
            "device_idle_share": 1 - timer.busy_s / wall,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "losses": [float(v) for v in timer.losses],
            "val": summary["val"], "digest": params_digest(models[-1]),
            "head_digest": params_digest(models[-1], replicated_leaf),
            "ckpt_dir": summary["ckpt_dir"], "launches": kernel_launches()}


def replicated_leaf(name: str) -> bool:
    """The classifier's BN and ``lin2``: whole on every model rank under
    ``--tp``."""
    return ".BN2." in name or ".lin2." in name


def dp_step_batch(seed: int, B: int):
    gen = torch.Generator().manual_seed(seed + 9)
    return (torch.randn((B, 224, 224, 3), generator=gen),
            torch.randint(0, 1000, (B,), generator=gen))


def flagship(seed: int):
    from scale_imagenet_tpu_torch.models import get_model

    model = get_model("ttnet_imagenet_small", nfilter=8, tfilter=8,
                      layers=1).init(seed=seed, device="cuda")
    perturb_bn(model, seed)
    return model


def pack_bits(bits: list) -> np.ndarray:
    return np.packbits(torch.cat([b.reshape(-1) for b in bits])
                       .cpu().numpy())


def rank_dp_step(seed: int, B: int, rank: int, world: int,
                 work: Path) -> dict:
    """(c) one data-parallel f32 step of the flagship (the port's
    ``make_train_step``, which averages over the ranks) on this rank's
    half of a seeded batch: its loss, and its Heaviside outputs (packed)
    and, on rank 0, its weights written under ``work``."""
    from scale_imagenet_tpu_torch.parallel import broadcast_module_
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model = flagship(seed)
    broadcast_module_(model)
    opt, _ = make_optimizer(0.1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    x, y = dp_step_batch(seed, B)
    b = B // world
    bits = []
    reset_kernel_launches()
    with torch.enable_grad(), heaviside_outputs(bits):
        _, metrics = step(ts, x[rank * b:(rank + 1) * b].cuda(),
                          y[rank * b:(rank + 1) * b].cuda())
    np.save(work / f"dp_bits_rank{rank}.npy", pack_bits(bits))
    if rank == 0:
        torch.save(model.state_dict(), work / "dp_rank0.pth")
    return {"loss": float(metrics["loss"]), "heavisides": len(bits),
            "launches": kernel_launches()}


def dist_worker(args) -> int:
    """A rank of the distributed phase (``--dist_rank``): joins the group
    through ``main``'s flags, runs the jobs of ``--dist_jobs`` in order and
    writes their results to ``--dist_out`` as JSON."""
    from scale_imagenet_tpu_torch import config
    from scale_imagenet_tpu_torch.parallel import initialize

    spec = json.loads(Path(args.dist_jobs).read_text())
    rank, world = args.dist_rank, spec["world"]
    join = ["--num_processes", str(world), "--process_id", str(rank),
            "--coordinator_address", spec["address"]]
    initialize(spec["address"], world, rank)
    results = []
    for job in spec["jobs"]:
        config.performance.fused_pointwise_blocks = job.get("fused", False)
        t = time.perf_counter()
        if job["kind"] == "eval":
            res = rank_eval(job["argv"] + join)
        elif job["kind"] == "train":
            res = rank_train(job["argv"] + join, job["steps"], job["batch"])
        elif job["kind"] == "tp_kernels":
            res = rank_tp_kernels(Path(job["eval_dir"]), job["batch"],
                                  job["seed"], rank, world)
        elif job["kind"] == "tp_step":
            res = rank_tp_step(job["seed"], job["batch"], rank, world,
                               Path(job["work"]))
        elif job["kind"] == "sp_forward":
            res = rank_sp_forward(Path(job["eval_dir"]), Path(job["work"]),
                                  job["batch"], job["seed"], rank, world)
        elif job["kind"] == "sp_families":
            res = rank_sp_families(Path(job["work"]), job["seed"], rank,
                                   world)
        else:
            res = rank_dp_step(job["seed"], job["batch"], rank, world,
                               Path(job["work"]))
        res["run_s"] = time.perf_counter() - t
        results.append(res)
    Path(args.dist_out).write_text(json.dumps(results))
    return 0


def launch_dist(jobs: list, out_dir: Path) -> list:
    """Run ``jobs`` on ``DIST_WORLD`` rank processes of this script (each
    on the card, joined over gloo); every rank's results.  A rank that
    fails, or outlives ``DIST_TIMEOUT_S``, fails the phase, and every rank
    is stopped."""
    spec = out_dir / "dist_jobs.json"
    spec.write_text(json.dumps({"world": DIST_WORLD, "jobs": jobs,
                                "address": f"localhost:{free_port()}"}))
    procs, logs = [], []
    try:
        for r in range(DIST_WORLD):
            log = open(out_dir / f"dist_rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--dist_rank", str(r), "--dist_jobs", str(spec),
                 "--dist_out", str(out_dir / f"dist_rank{r}.json")],
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + DIST_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"distributed rank {r} exited "
              f"{p.returncode}; its log: "
              f"{(out_dir / f'dist_rank{r}.log').read_text()[-3000:]}")
    return [json.loads((out_dir / f"dist_rank{r}.json").read_text())
            for r in range(DIST_WORLD)]


def emulated_dp_step(seed: int, B: int, world: int):
    """The plain version of (c) in one process: the ``world`` slices of the
    batch in turn, each a training forward and backward from the same
    weights, their gradients, new BN statistics and losses averaged, then
    one SGD update.  Returns ``(model, loss, bits of each slice, the
    largest gap between slice 0's new BN statistics and their mean)``: the
    last is what a step that took rank 0's statistics would be off by."""
    from scale_imagenet_tpu_torch.train import make_optimizer
    from scale_imagenet_tpu_torch.train.losses import cross_entropy

    model = flagship(seed)
    opt, _ = make_optimizer(0.1)
    params = dict(model.named_parameters())
    state = opt.init(params)
    x, y = dp_step_batch(seed, B)
    b = B // world
    grads, stats, losses, bits, first = None, {}, [], [], {}
    for r in range(world):
        for p in params.values():
            p.grad = None
        got, sink = {}, []
        with torch.enable_grad(), heaviside_outputs(sink):
            logits = model(x[r * b:(r + 1) * b].cuda(), got)
            loss = cross_entropy(logits, y[r * b:(r + 1) * b].cuda())
            loss.backward()
        losses.append(float(loss))
        bits.append(pack_bits(sink))
        g = {n: p.grad.detach().clone() for n, p in params.items()}
        grads = g if grads is None else {n: grads[n] + g[n] for n in g}
        for bn, (mean, var) in got.items():
            first.setdefault(bn, (mean.detach(), var.detach()))
            m0, v0 = stats.get(bn, (0.0, 0.0))
            stats[bn] = (m0 + mean.detach(), v0 + var.detach())
    with torch.no_grad():
        for bn, (mean, var) in stats.items():
            bn.running_mean.copy_(mean / world)
            bn.running_var.copy_(var / world)
    rank0_gap = max(float((f - t / world).abs().max())
                    for bn, pair in stats.items()
                    for f, t in zip(first[bn], pair))
    opt.update(params, {n: g / world for n, g in grads.items()}, state, 0)
    return model, sum(losses) / world, bits, rank0_gap


def distributed_phase(args) -> dict:
    """21's jobs (run by ``launch_phases``): two ranks on the one card
    over gloo, the flagship at full
    width: (a) ``main --mode eval --num_processes 2`` over the eval
    phase's 4,000 shard images, conv and ``--lut --lut_path`` with that
    phase's archive (global B = --batch): every image scored once over
    the ranks, top-1/5 within 0.1 points and the loss within 1e-3
    relative of the one-process runs, img/s, each rank's idle share and
    launches; (b) ``main --mode train --num_processes 2``, one epoch of 10
    steps from the train phase's pre-crop shards (global B): the ranks'
    final weights bit-equal, img/s over steps 2-10, idle shares, peak
    memory; (c) one data-parallel step against its plain version in one
    process, in ``train_step_parity``'s bounds, its update's norm and BN
    statistics within ``DIST_UPDATE_NORM_TOL`` and ``DIST_BN_STAT_TOL``."""
    B = args.batch
    torch.cuda.empty_cache()
    work = Path("build") / "chip_smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    eval_dir = Path("build") / "chip_smoke_eval"
    train_dir = Path("build") / "chip_smoke_train"
    common = ["--eval_batch_size", str(B), "--seed", str(args.seed),
              "--root_dir", str(work / "logs")]
    evals = ["--mode", "eval", "--shards_dir", str(eval_dir / "shards"),
             "--ckpt", str(eval_dir / "weights.pth"), *common]
    jobs = [{"kind": "eval", "name": "conv", "argv": evals},
            {"kind": "eval", "name": "lut", "fused": True,
             "argv": evals + ["--lut", "--lut_path",
                              str(eval_dir / "luts.npz")]},
            {"kind": "train", "name": "train", "steps": TRAIN_IMAGES // B,
             "batch": B, "argv": [
                 "--mode", "train", "--shards_dir", str(train_dir /
                                                        "shards"),
                 "--eval_shards_dir", str(eval_dir / "shards"),
                 "--train_batch_size", str(B), "--max_epochs", "1",
                 *common]},
            {"kind": "dp_step", "name": "dp_step", "seed": args.seed,
             "batch": B, "work": str(work)}]
    return {"jobs": jobs, "work": work}


def check_distributed(dist: dict, evals: dict, args) -> dict:
    """The checks and lines of phase 21 (``distributed_phase``), against
    the eval phase's one-process runs; returns each kernel's launches by
    rank and run."""
    B = args.batch
    res = dist["results"]
    launches = {}
    for name, one in (("conv", evals["conv"]), ("lut", evals["lut_load"])):
        r0, r1 = res[name]
        images = r0["rank_images"] + r1["rank_images"]
        emit("distributed_eval", run=name, world=DIST_WORLD, batch=B,
             images=images, images_reduced=r0["images"],
             img_s=EVAL_IMAGES / max(r0["eval_s"], r1["eval_s"]),
             img_s_after_first_batch=(
                 EVAL_IMAGES - r0["first_batch_images"]
                 - r1["first_batch_images"]) / max(r0["after_first_s"],
                                                   r1["after_first_s"]),
             top1=r0["top1"], top5=r0["top5"], loss=r0["loss"],
             one_process={k: one[k] for k in ("top1", "top5", "loss",
                                             "img_s")},
             rank_eval_s=[r0["eval_s"], r1["eval_s"]],
             rank_idle_share=[r0["device_idle_share"],
                              r1["device_idle_share"]],
             rank_max_memory_allocated_gb=[r0["max_memory_allocated_gb"],
                                           r1["max_memory_allocated_gb"]],
             rank_launches=[r0["launches"], r1["launches"]],
             run_s=[r0["run_s"], r1["run_s"]])
        check(images == EVAL_IMAGES and r0["images"] == EVAL_IMAGES
              and r1["images"] == EVAL_IMAGES,
              f"distributed {name} eval scored {images} images "
              f"(reduced {r0['images']}, {r1['images']}), expected "
              f"{EVAL_IMAGES}")
        check(all(r0[k] == r1[k] for k in ("top1", "top5", "loss")),
              f"distributed {name} eval: the ranks' metrics differ")
        for k in ("top1", "top5"):
            check(abs(r0[k] - one[k]) <= DIST_TOP_POINTS,
                  f"distributed {name} {k} {r0[k]} vs one process "
                  f"{one[k]}")
        check(abs(r0["loss"] - one["loss"]) <= DIST_LOSS_REL
              * abs(one["loss"]), f"distributed {name} loss {r0['loss']} "
              f"vs one process {one['loss']}")
        for r, rr in enumerate((r0, r1)):
            for kname, n in rr["launches"].items():
                launches.setdefault(kname, {})[
                    f"eval_dp_{name}_rank{r}"] = n
    for r, rr in enumerate(res["lut"]):
        check(rr["launches"]["lut_window_bits"] > 0,
              f"rank {r} of the distributed LUT eval launched no "
              "lut_window_bits")
    t0, t1 = res["train"]
    emit("distributed_train", world=DIST_WORLD, batch=B,
         images=TRAIN_IMAGES, steps=t0["steps"], train_img_s=min(
             t0["train_img_s"], t1["train_img_s"]),
         step_ms=max(t0["step_ms"], t1["step_ms"]),
         rank_idle_share=[t0["device_idle_share"], t1["device_idle_share"]],
         rank_max_memory_allocated_gb=[t0["max_memory_allocated_gb"],
                                       t1["max_memory_allocated_gb"]],
         first_loss=t0["losses"][0], last_loss=t0["losses"][-1],
         val=t0["val"], weights_equal=t0["digest"] == t1["digest"],
         rank_launches=[t0["launches"], t1["launches"]],
         run_s=[t0["run_s"], t1["run_s"]])
    check(t0["steps"] == t1["steps"] == TRAIN_IMAGES // B
          and t0["step"] == TRAIN_IMAGES // B,
          f"distributed train ran {t0['steps']}, {t1['steps']} steps")
    check(t0["digest"] == t1["digest"],
          "distributed train: the ranks' final weights differ")
    check(t0["losses"] == t1["losses"] and t0["val"] == t1["val"],
          "distributed train: the ranks' metrics differ")
    check(all(np.isfinite(t0["losses"])), f"losses {t0['losses']}")
    for r, rr in enumerate((t0, t1)):
        check(not any(rr["launches"].values()),
              f"distributed train rank {r} launched {rr['launches']}")
        for kname, n in rr["launches"].items():
            launches.setdefault(kname, {})[f"train_dp_rank{r}"] = n
    # (c) the DP step against its plain version in one process
    work = dist["work"]
    model, loss, bits, rank0_gap = emulated_dp_step(args.seed, B,
                                                    DIST_WORLD)
    start = flagship(args.seed)
    dp = copy.deepcopy(start)
    dp.load_state_dict(torch.load(work / "dp_rank0.pth"))
    du = torch.cat([(p - s).double().ravel() for p, s in
                    zip(dp.parameters(), start.parameters())])
    dv = torch.cat([(p - s).double().ravel() for p, s in
                    zip(model.parameters(), start.parameters())])
    flips = outputs = 0
    for r in range(DIST_WORLD):
        got = np.load(work / f"dp_bits_rank{r}.npy")
        check(got.shape == bits[r].shape,
              f"rank {r} ran other Heavisides than its plain version")
        flips += int(np.unpackbits(got ^ bits[r]).sum())
        outputs += got.size * 8
    bn_diff = max(float((a - b).abs().max()) for (n, a), (_, b) in zip(
        dp.state_dict().items(), model.state_dict().items())
        if n.endswith(("running_mean", "running_var")))
    dloss = res["dp_step"][0]["loss"]
    parity = {"batch": B, "world": DIST_WORLD, "dp_loss": dloss,
              "plain_loss": loss,
              "rel_loss_gap": abs(dloss - loss) / abs(loss),
              "update_cosine": float(du @ dv / (du.norm() * dv.norm())),
              "update_norm_ratio": float(du.norm() / dv.norm()),
              "heaviside_outputs": outputs, "heaviside_flipped": flips,
              "flip_share": flips / outputs,
              "bn_stat_max_abs_diff": bn_diff,
              "bn_stat_rank0_gap": rank0_gap,
              "fused_launches_in_training": sum(
                  r["launches"]["fused_pointwise_block"]
                  for r in res["dp_step"])}
    emit("distributed_step_parity", **parity)
    check_parity(parity, "data-parallel step")
    check(abs(parity["update_norm_ratio"] - 1) <= DIST_UPDATE_NORM_TOL,
          f"data-parallel step: update norm {parity['update_norm_ratio']} "
          f"times the plain step's, beyond 1 +- {DIST_UPDATE_NORM_TOL}")
    check(bn_diff <= DIST_BN_STAT_TOL < rank0_gap,
          f"data-parallel step: BN statistics {bn_diff} from the plain "
          f"step's (limit {DIST_BN_STAT_TOL}; rank 0's alone would be "
          f"{rank0_gap} off)")
    shutil.rmtree(work)
    return launches


# ------------------------------------------------------- tensor parallel

# the flagship as two ranks on the one card, over gloo: one data index, the
# channels split over a model axis of two
TP_MESH = ["--mesh_data", "1", "--mesh_model", str(DIST_WORLD), "--tp"]


def _tp_rank_mesh(rank: int, world: int):
    """This rank's place on the 1 x ``world`` mesh."""
    from scale_imagenet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(1, world, world, rank)


def rank_tp_kernels(eval_dir: Path, B: int, seed: int, rank: int,
                    world: int) -> dict:
    """(b) in each rank: one ``--tp --lut`` forward of the first B eval
    images with the fused switch on, every launch of ``lut_window_bits``
    and ``fused_pointwise_block`` in it captured, then each held against
    its plain version and timed (``window_case``, ``fused_case``), the
    ranks taking turns on the card so that each times its launches
    alone.  Its launches are counted from 0 over the forward."""
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.lut_store import load_luts
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD, \
        shard_loader
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.parallel import barrier
    from scale_imagenet_tpu_torch.parallel.tp import shard_luts, \
        shard_model, tp_lut_apply
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    model = flagship(seed)
    model.load_state_dict(torch.load(eval_dir / "weights.pth"))
    mesh = _tp_rank_mesh(rank, world)
    local = shard_model(model, world, rank, mesh.model_group)
    luts = shard_luts(load_luts(str(eval_dir / "luts.npz"), model), local)
    images, _ = next(iter(shard_loader(str(eval_dir / "shards"), B)))
    x = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))(
        torch.as_tensor(images).cuda())
    bits, fused = [], []
    real_bits, real_block = lut_eval.lut_window_bits, lut_eval.block_tt

    def rec_bits(xb, words, k, stride, padding, heads=1):
        bits.append(("bits", xb, words, k, stride, padding, heads))
        return real_bits(xb, words, k, stride, padding, heads)

    def rec_block(block, h, *a, **k):
        fused.append((block, h))
        return real_block(block, h, *a, **k)

    reset_kernel_launches()
    with mock.patch.object(lut_eval, "lut_window_bits", rec_bits), \
            mock.patch.object(lut_eval, "block_tt", rec_block), \
            fused_blocks(True):
        logits = tp_lut_apply(luts, local, x)
    torch.cuda.synchronize()
    launches = kernel_launches()
    rows = {"bits": [], "fused": []}
    for r in range(world):
        if r == rank:
            rows["bits"] = [window_case(*launch, K) for launch in bits]
            rows["fused"] = [fused_case(block, h, FB)
                             for block, h in fused]
        barrier()
    return {"launches": launches, "rows": rows,
            "logits": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all())}


def rank_tp_step(seed: int, B: int, rank: int, world: int,
                 work: Path) -> dict:
    """(d) one f32 TP step of the flagship (``make_train_step`` over the
    rank's slice, reducing over the data group) on the whole seeded batch
    (one data index): its loss, this rank's Heaviside outputs (packed a
    site) and, from rank 0, the gathered weights."""
    from scale_imagenet_tpu_torch.parallel.tp import gather_train_payload, \
        shard_train_state
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model, mesh = flagship(seed), _tp_rank_mesh(rank, world)
    opt, _ = make_optimizer(0.1)
    local, opt_state = shard_train_state(
        model, opt.init(dict(model.named_parameters())), mesh)
    del model
    ts = TrainState(local, opt_state)
    step = make_train_step(local, opt, group=mesh.data_group)
    x, y = dp_step_batch(seed, B)
    bits = []
    reset_kernel_launches()
    with torch.enable_grad(), heaviside_outputs(bits):
        _, metrics = step(ts, x.cuda(), y.cuda())
    np.savez(work / f"tp_bits_rank{rank}.npz",
             *[np.packbits(b.cpu().numpy().reshape(-1)) for b in bits])
    payload = gather_train_payload(ts, mesh)
    if rank == 0:
        torch.save(payload["model"], work / "tp_step.pth")
    return {"loss": float(metrics["loss"]), "heavisides": len(bits),
            "launches": kernel_launches()}


def tp_phase(args) -> dict:
    """22's jobs (run by ``launch_phases``): the flagship at full width as
    two ranks on the one card over
    gloo, ``--mesh_data 1 --mesh_model 2 --tp``, each rank holding half of
    every channel-indexed tensor: (a) ``main --mode eval`` over the eval
    phase's 4,000 shard images, switch off; (b) ``--lut`` with that
    phase's archive, switch on, and every launch of one TP forward held
    against its plain version in each rank; (c) ten ``main --mode train``
    steps from the pre-crop shards, then a one-process ``--mode eval
    --ckpt`` of the gathered checkpoint (in ``check_tp``); (d) one TP
    step.  The checks are ``check_tp``'s."""
    B = args.batch
    torch.cuda.empty_cache()
    work = Path("build") / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    eval_dir = Path("build") / "chip_smoke_eval"
    train_dir = Path("build") / "chip_smoke_train"
    common = ["--eval_batch_size", str(B), "--seed", str(args.seed),
              "--root_dir", str(work / "logs"), *TP_MESH]
    evals_argv = ["--mode", "eval", "--shards_dir", str(eval_dir / "shards"),
                  "--ckpt", str(eval_dir / "weights.pth"), *common]
    jobs = [{"kind": "eval", "name": "conv", "argv": evals_argv},
            {"kind": "eval", "name": "lut", "fused": True,
             "argv": evals_argv + ["--lut", "--lut_path",
                                   str(eval_dir / "luts.npz")]},
            {"kind": "tp_kernels", "name": "kernels", "batch": B,
             "seed": args.seed, "eval_dir": str(eval_dir)},
            {"kind": "train", "name": "train", "steps": TRAIN_IMAGES // B,
             "batch": B, "argv": [
                 "--mode", "train", "--shards_dir", str(train_dir /
                                                        "shards"),
                 "--eval_shards_dir", str(eval_dir / "shards"),
                 "--train_batch_size", str(B), "--max_epochs", "1",
                 *common]},
            {"kind": "tp_step", "name": "tp_step", "seed": args.seed,
             "batch": B, "work": str(work)}]
    return {"jobs": jobs, "work": work}


def launch_phases(phases: tuple, out_dir: Path) -> float:
    """Every job of ``phases`` (21's and 22's) on one launch of the rank
    processes: a launch costs about 18 s of process start and set-up.
    Each phase gets its ``results`` by job name and its ``ranks_s``, the
    seconds of its own jobs (the slower rank's, job by job); returns the
    launch's seconds."""
    jobs = [job for phase in phases for job in phase["jobs"]]
    t0 = time.perf_counter()
    ranks = launch_dist(jobs, out_dir)
    launch_s = time.perf_counter() - t0
    i = 0
    for phase in phases:
        res, phase["ranks_s"] = {}, 0.0
        for job in phase["jobs"]:
            res[job["name"]] = [r[i] for r in ranks]
            phase["ranks_s"] += max(r[i]["run_s"] for r in ranks)
            i += 1
        phase["results"] = res
    return launch_s


def _within(got: dict, want: dict, what: str) -> None:
    for k in ("top1", "top5"):
        check(abs(got[k] - want[k]) <= DIST_TOP_POINTS,
              f"{what} {k} {got[k]} vs {want[k]}")
    check(abs(got["loss"] - want["loss"]) <= DIST_LOSS_REL
          * abs(want["loss"]), f"{what} loss {got['loss']} vs {want['loss']}")


def check_tp(tp: dict, evals: dict, args) -> dict:
    """The checks and lines of phase 22 (``tp_phase``); returns each
    kernel's launches by rank and run, and the captured launches' rows."""
    B = args.batch
    res = tp["results"]
    launches = {}
    batches = -(-EVAL_IMAGES // B)
    for name, one in (("conv", evals["conv"]), ("lut", evals["lut_load"])):
        r0, r1 = res[name]
        emit("tp_eval", run=name, mesh="1x2", batch=B,
             rank_images=[r0["rank_images"], r1["rank_images"]],
             images=r0["images"],
             img_s=EVAL_IMAGES / max(r0["eval_s"], r1["eval_s"]),
             img_s_after_first_batch=(
                 EVAL_IMAGES - r0["first_batch_images"]) / max(
                     r0["after_first_s"], r1["after_first_s"]),
             top1=r0["top1"], top5=r0["top5"], loss=r0["loss"],
             one_process={k: one[k] for k in ("top1", "top5", "loss",
                                             "img_s")},
             rank_idle_share=[r0["device_idle_share"],
                              r1["device_idle_share"]],
             rank_max_memory_allocated_gb=[r0["max_memory_allocated_gb"],
                                           r1["max_memory_allocated_gb"]],
             rank_launches=[r0["launches"], r1["launches"]],
             run_s=[r0["run_s"], r1["run_s"]])
        # one data index: each rank scores every image, on its channels
        check(r0["images"] == r1["images"] == EVAL_IMAGES
              and r0["rank_images"] == r1["rank_images"] == EVAL_IMAGES,
              f"tp {name} eval scored {r0['images']}, {r1['images']} "
              f"(rank counts {r0['rank_images']}, {r1['rank_images']}), "
              f"expected {EVAL_IMAGES}")
        check(all(r0[k] == r1[k] for k in ("top1", "top5", "loss")),
              f"tp {name} eval: the ranks' metrics differ")
        _within(r0, one, f"tp {name} eval vs one process")
        for r, rr in enumerate((r0, r1)):
            for kname, n in rr["launches"].items():
                launches.setdefault(kname, {})[f"eval_tp_{name}_rank{r}"] = n
    for r, rr in enumerate(res["conv"]):
        check(not any(rr["launches"].values()),
              f"tp conv eval rank {r} (switch off) launched "
              f"{rr['launches']}")
    for r, rr in enumerate(res["lut"]):
        got = rr["launches"]
        check(got["lut_window_bits"] == 8 * batches
              and got["fused_pointwise_block"] == batches,
              f"tp --lut eval rank {r} launched {got}, expected "
              f"{8 * batches} lut_window_bits and {batches} fused")
    # (b) every launch of one TP forward against its plain version
    rows = {"bits": [], "fused": []}
    for r, rr in enumerate(res["kernels"]):
        got = rr["launches"]
        check(got["lut_window_bits"] == 8
              and got["fused_pointwise_block"] == 1 and rr["finite"]
              and rr["logits"] == [B, 1000],
              f"tp forward rank {r}: launches {got}, logits {rr['logits']}")
        for kind in rows:
            for row in rr["rows"][kind]:
                row["rank"] = r
                rows[kind].append(row)
                emit("tp_kernels", kernel="lut_window_bits" if kind == "bits"
                     else "fused_pointwise_block", **row)
        for kname, n in got.items():
            launches.setdefault(kname, {})[f"tp_forward_rank{r}"] = n
    # (c) training, and the gathered checkpoint in one process
    t0, t1 = res["train"]
    reload = main_eval(["--mode", "eval", "--shards_dir",
                        str(Path("build") / "chip_smoke_eval" / "shards"),
                        "--eval_batch_size", str(B), "--ckpt",
                        str(Path(t0["ckpt_dir"]) / "last"), "--root_dir",
                        str(tp["work"] / "logs")], False)
    val = t0["val"][0]
    emit("tp_train", mesh="1x2", batch=B, images=TRAIN_IMAGES,
         steps=t0["steps"], train_img_s=min(t0["train_img_s"],
                                            t1["train_img_s"]),
         step_ms=max(t0["step_ms"], t1["step_ms"]),
         rank_idle_share=[t0["device_idle_share"], t1["device_idle_share"]],
         rank_max_memory_allocated_gb=[t0["max_memory_allocated_gb"],
                                       t1["max_memory_allocated_gb"]],
         first_loss=t0["losses"][0], last_loss=t0["losses"][-1], val=val,
         replicated_leaves_equal=t0["head_digest"] == t1["head_digest"],
         reload={k: reload[k] for k in ("top1", "top5", "loss", "img_s")},
         rank_launches=[t0["launches"], t1["launches"]],
         run_s=[t0["run_s"], t1["run_s"]])
    check(t0["steps"] == t1["steps"] == TRAIN_IMAGES // B
          and t0["step"] == TRAIN_IMAGES // B,
          f"tp train ran {t0['steps']}, {t1['steps']} steps")
    check(t0["head_digest"] == t1["head_digest"],
          "tp train: the ranks' classifier BN and lin2 differ")
    check(t0["digest"] != t1["digest"],
          "tp train: the ranks hold the same channels")
    check(t0["losses"] == t1["losses"] and t0["val"] == t1["val"],
          "tp train: the ranks' metrics differ")
    check(all(np.isfinite(t0["losses"])), f"losses {t0['losses']}")
    _within(reload, val, "the gathered TP checkpoint in one process vs the "
                         "TP validation")
    for r, rr in enumerate((t0, t1)):
        check(not any(rr["launches"].values()),
              f"tp train rank {r} launched {rr['launches']}")
        for kname, n in rr["launches"].items():
            launches.setdefault(kname, {})[f"train_tp_rank{r}"] = n
    # (d) the TP step against the one-process plain step
    work = tp["work"]
    start = flagship(args.seed)
    model = copy.deepcopy(start)
    x, y = dp_step_batch(args.seed, B)
    sink = []
    with torch.enable_grad():
        loss = one_train_step(model, x.cuda(), y.cuda(), sink)
    tp_model = copy.deepcopy(start)
    tp_model.load_state_dict(torch.load(work / "tp_step.pth"))
    du = torch.cat([(p - s).double().ravel() for p, s in
                    zip(tp_model.parameters(), start.parameters())])
    dv = torch.cat([(p - s).double().ravel() for p, s in
                    zip(model.parameters(), start.parameters())])
    flips = outputs = 0
    for r in range(DIST_WORLD):
        with np.load(work / f"tp_bits_rank{r}.npz") as got:
            check(len(got.files) == len(sink),
                  f"tp rank {r} ran other Heavisides than the plain step")
            for i, plain in enumerate(sink):
                half = plain.chunk(DIST_WORLD, dim=1)[r]
                want = np.packbits(half.cpu().numpy().reshape(-1))
                mine = got[f"arr_{i}"]
                check(mine.shape == want.shape,
                      f"tp rank {r} Heaviside site {i} has another shape")
                flips += int(np.unpackbits(mine ^ want).sum())
                outputs += half.numel()
    bn_diff = max(float((a - b).abs().max()) for (n, a), (_, b) in zip(
        tp_model.state_dict().items(), model.state_dict().items())
        if n.endswith(("running_mean", "running_var")))
    tloss = res["tp_step"][0]["loss"]
    parity = {"batch": B, "mesh": "1x2", "tp_loss": tloss,
              "plain_loss": loss, "rel_loss_gap": abs(tloss - loss)
              / abs(loss),
              "update_cosine": float(du @ dv / (du.norm() * dv.norm())),
              "update_norm_ratio": float(du.norm() / dv.norm()),
              "heaviside_outputs": outputs, "heaviside_flipped": flips,
              "flip_share": flips / outputs,
              "bn_stat_max_abs_diff": bn_diff,
              "fused_launches_in_training": sum(
                  r["launches"]["fused_pointwise_block"]
                  for r in res["tp_step"])}
    emit("tp_step_parity", **parity)
    check_parity(parity, "tensor-parallel step")
    check(abs(parity["update_norm_ratio"] - 1) <= DIST_UPDATE_NORM_TOL,
          f"tensor-parallel step: update norm {parity['update_norm_ratio']}"
          f" times the plain step's, beyond 1 +- {DIST_UPDATE_NORM_TOL}")
    check(bn_diff <= DIST_BN_STAT_TOL,
          f"tensor-parallel step: BN statistics {bn_diff} from the plain "
          f"step's (limit {DIST_BN_STAT_TOL})")
    shutil.rmtree(work)
    return {"launches": launches, "rows": rows}


# ----------------------------------------------------------------- sp

# the flagship as two ranks on the one card, over gloo: one data index, the
# image height split over a model axis of two
SP_MESH = ["--mesh_data", "1", "--mesh_model", str(DIST_WORLD), "--sp"]
SP_ATTACK_IMAGES = 256             # (c): one batch of self-labelled images
SP_ATTACK_EPS = 2 / 255
SP_ARGMAX_AGREEMENT = 0.99         # (b), (e): as fused vs unfused (PERF.md §2)
# (e): one sharded forward of a model of every other config type, at its
# registry width, B = 32; the fused launches each expects (its k = 1
# stride-1 heads, the switch on)
SP_FAMILY_BATCH = 32
SP_FAMILIES = {"TT_vf_19lv3_imgnet_xsmall_VGG": 1, "TT_FHE_SMALL": 2,
               "TT_FHE_XSMALL_vAlexnet": 1, "TT_vf_19lv2_imgnet": 0,
               "TT_general": 0, "TT_general_correctBN": 0,
               "mobilenet_v2_tt": 0, "mobilenet_v1_tt": 0,
               "model_general": 0, "cifar10lownoise": 0, "tt_certif": 0,
               "resnet50": 0}
# held in f64, their f32 agreement recorded (phase 17's rule for the
# DoReFa ResNets: cuDNN rounds a dense 3x3 conv of a slab otherwise than
# the whole tensor's, and the 4-bit activation steps turn an ulp into a
# step)
SP_FAMILY_F64 = ("resnet50",)
SP_V1_IMAGES = 512                 # (f): v1's --sp eval
# (f)'s bound at B = 64, where cuDNN takes the same kernels for a rank's
# slabs as for the whole tensors (exact logits on the card); at B = 128
# and 256 it takes others for some of v1's grouped convs, whose f32
# rounding moves a 2-bit step: the B = 256 run is recorded beside it
SP_V1_BATCH = 64
SP_CIFAR_IMAGES = 256              # (g) --certify, (h) TT_FHE_small


def _sp_prepared(eval_dir: Path, B: int, shard):
    """The rank's rows of the first B eval images, normalized on the card,
    and their (self-) labels."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD, \
        shard_loader
    from scale_imagenet_tpu_torch.parallel import local_rows
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    images, labels = next(iter(shard_loader(str(eval_dir / "shards"), B)))
    x = torch.as_tensor(images).cuda()
    if shard is not None:
        x = local_rows(x, shard)
    return (make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))(x),
            torch.as_tensor(labels).long().cuda())


def _fgsm_predictions(apply, model, x, labels) -> torch.Tensor:
    """The argmax of ``apply`` on FGSM images at ``SP_ATTACK_EPS`` (pixel
    units, through the ImageNet normalization), as ``--attack fgsm``
    computes them, the fused switch on."""
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.robust.attack import fgsm_attack, frozen
    from scale_imagenet_tpu_torch.train.steps import _on, _pixel_ball

    eps, lo, hi = _on(_pixel_ball(SP_ATTACK_EPS, (IMAGENET_MEAN,
                                                  IMAGENET_STD)), x.device)
    with frozen(model), fused_blocks(True):
        adv = fgsm_attack(apply, x, labels, eps, lo, hi)
        return apply(adv).argmax(1)


def rank_sp_forward(eval_dir: Path, work: Path, B: int, seed: int,
                    rank: int, world: int) -> dict:
    """(b)-(d) in each rank: one ``--sp`` forward of the first B eval
    images with the fused switch on, every fused launch in it captured and
    held against its plain version (the ranks taking turns on the card),
    its logits and Heaviside outputs written under ``work``; the FGSM
    predictions through the sharded forward; a ``utils.profile_trace`` of
    one forward, timed by ``utils.StepTimer``.  The launches are counted
    from 0 over the forward."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.parallel import barrier, sp, sp_forward
    from scale_imagenet_tpu_torch.parallel.mesh import make_mesh
    from scale_imagenet_tpu_torch.utils import StepTimer as PlainTimer, \
        profile_trace

    model = flagship(seed)
    model.load_state_dict(torch.load(eval_dir / "weights.pth"))
    shard = sp.row_shard(make_mesh(1, world, world, rank))
    apply = sp_forward(model, shard)
    x, labels = _sp_prepared(eval_dir, B, shard)
    fused, bits = [], []
    real = sp.block_tt

    def rec(block, h, *a, **k):
        if block.cfg.k in (1, (1, 1)):
            fused.append((block, h))
        return real(block, h, *a, **k)

    reset_kernel_launches()
    with mock.patch.object(sp, "block_tt", rec), fused_blocks(True), \
            heaviside_outputs(bits):
        logits = apply(x)
    torch.cuda.synchronize()
    launches = kernel_launches()
    np.save(work / f"sp_logits_rank{rank}.npy", logits.cpu().numpy())
    np.savez(work / f"sp_bits_rank{rank}.npz",
             *[np.packbits(b.cpu().numpy().reshape(-1)) for b in bits])
    rows = []
    for r in range(world):
        if r == rank:
            rows = [fused_case(block, h, FB) for block, h in fused]
        barrier()
    preds = _fgsm_predictions(apply, model, x, labels)
    np.save(work / f"sp_fgsm_rank{rank}.npy", preds.cpu().numpy())
    # (d) the utilities on one forward
    timer, trace = PlainTimer(), work / f"trace_rank{rank}"
    with fused_blocks(True), profile_trace(str(trace)):
        timer.start()
        timer.stop(apply(x))
    traces = sorted(trace.glob("*.pt.trace.json"))
    return {"launches": launches, "rows": rows, "heavisides": len(bits),
            "logits": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "traced_forward_ms": timer.mean * 1e3,
            "trace_files": len(traces),
            "trace_bytes": sum(f.stat().st_size for f in traces)}


def _sp_family_model(name: str, seed: int):
    """(e)'s model of ``name`` at its registry width on the card from
    ``seed``, and its batch: ``(md, model, x)``.  The families with fused
    heads have their BN statistics perturbed, as in their own phases (9,
    12), where the kernel's contract holds: with statistics set from the
    batch, 3 % of one head's Heaviside outputs differed from the plain
    version's on the card.  The others' BNs are set to the batch's
    statistics (``zoo_model``), so that the argmax depends on the
    image."""
    from scale_imagenet_tpu_torch.models import get_model

    md = get_model(name)
    side = getattr(md.config, "image_size", 224)
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((SP_FAMILY_BATCH, side, side, 3), generator=gen).cuda()
    if SP_FAMILIES[name]:
        model = md.init(seed=seed, device="cuda")
        perturb_bn(model, seed)
    else:
        md, model, _ = zoo_model(name, seed, x)
    return md, model, x


def _family_noise(md, seed: int) -> dict:
    """The keyword of a stochastic forward: one key, the same on every
    rank and in the one-process forward."""
    from scale_imagenet_tpu_torch.ops import NoiseKey

    return {"noise": NoiseKey(seed)} if md.stochastic else {}


def rank_sp_families(work: Path, seed: int, rank: int, world: int) -> dict:
    """(e) in each rank: for each model of ``SP_FAMILIES`` (weights and
    batch written by ``sp_phase``), one ``--sp`` forward with the fused
    switch on, its launches counted from 0 over it, its logits written
    under ``work``, and each fused launch on the rank's rows captured and
    held against its plain version (the ranks taking turns on the
    card)."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.block_tt import takes_fused_kernel
    from scale_imagenet_tpu_torch.parallel import barrier, local_rows, sp, \
        sp_forward, sp_interval_logits
    from scale_imagenet_tpu_torch.parallel.mesh import make_mesh

    shard = sp.row_shard(make_mesh(1, world, world, rank))
    real = sp.block_tt
    out = {}
    for i, name in enumerate(SP_FAMILIES):
        md = get_model(name)
        model = md.init(seed=seed + i, device="cuda")
        model.load_state_dict(torch.load(work / f"{name}.pth"))
        x = local_rows(torch.load(work / f"{name}_x.pt").cuda(), shard)
        fused = []

        def rec(block, h, *a, **k):
            if takes_fused_kernel(block.cfg, False):
                fused.append((block, h))
            return real(block, h, *a, **k)

        reset_kernel_launches()
        with mock.patch.object(sp, "block_tt", rec), fused_blocks(True):
            logits = sp_forward(model, shard)(x, **_family_noise(
                md, seed + i))
        torch.cuda.synchronize()
        launches = kernel_launches()
        np.save(work / f"{name}_logits_rank{rank}.npy", logits.cpu().numpy())
        if md.interval_logits is not None:
            iv = sp_interval_logits(model, shard)(x, ROBUST_EPS)
            np.save(work / f"{name}_bounds_rank{rank}.npy", torch.stack(
                [iv.vmin, iv.vmax]).cpu().numpy())
        if name in SP_FAMILY_F64:
            model.double()
            np.save(work / f"{name}_f64_logits_rank{rank}.npy",
                    sp_forward(model, shard)(x.double()).cpu().numpy())
        rows = []
        for r in range(world):
            if r == rank:
                rows = [{"model": name, **fused_case(block, h, FB)}
                        for block, h in fused]
            barrier()
        out[name] = {"launches": launches, "captured": len(fused),
                     "rows": rows, "logits": list(logits.shape),
                     "finite": bool(torch.isfinite(logits).all())}
        del model, fused
    return out


def sp_phase(args) -> dict:
    """23's jobs (run by ``launch_phases``): the flagship at full width as
    two ranks on the one card over gloo, ``--mesh_data 1 --mesh_model 2
    --sp``: (a) ``main --mode eval`` over the eval phase's 4,000 shard
    images, the switch off, then on; (b)-(d) ``rank_sp_forward``; (c)
    ``main --mode eval --attack fgsm`` over the first 256 of them, written
    here as shards of their own; (e) ``rank_sp_families``, whose weights
    and batches, and the one-process forwards they are held against, are
    made here; (f) ``main --mode eval`` of v1 over 512 images labelled by
    its forward; (g) ``--certify`` of ``cifar10lownoise`` over 256
    self-labelled 32² images; (h) ``TT_FHE_small`` over the same images
    twice from one ``--seed``.  The checks are ``check_sp``'s."""
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, shard_loader, write_shards
    from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import \
        ttnet_v1_apply
    from scale_imagenet_tpu_torch.train import make_input_pipeline

    B = args.batch
    work = Path("build") / "chip_smoke_sp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    eval_dir = Path("build") / "chip_smoke_eval"
    images, labels = next(iter(shard_loader(str(eval_dir / "shards"),
                                            SP_ATTACK_IMAGES)))
    write_shards(ArrayDataset(np.asarray(images), np.asarray(labels)),
                 str(work / "attack_shards"))
    common = ["--eval_batch_size", str(B), "--seed", str(args.seed),
              "--ckpt", str(eval_dir / "weights.pth"), "--root_dir",
              str(work / "logs"), *SP_MESH]
    evals = ["--mode", "eval", "--shards_dir", str(eval_dir / "shards"),
             *common]
    jobs = [{"kind": "eval", "name": "conv", "argv": evals},
            {"kind": "eval", "name": "conv_fused", "fused": True,
             "argv": evals},
            {"kind": "sp_forward", "name": "forward", "batch": B,
             "seed": args.seed, "eval_dir": str(eval_dir),
             "work": str(work)},
            {"kind": "eval", "name": "attack", "fused": True, "argv": [
                "--mode", "eval", "--shards_dir", str(work / "attack_shards"),
                "--attack", "fgsm", "--attack_eps", str(SP_ATTACK_EPS),
                *common]}]

    # (e) every other config type: its weights, batch and one-process
    # forward (the switch on, as the ranks run it)
    fam = work / "families"
    fam.mkdir()
    want = {}
    for i, name in enumerate(SP_FAMILIES):
        md, model, x = _sp_family_model(name, args.seed + 100 + i)
        torch.save(model.state_dict(), fam / f"{name}.pth")
        torch.save(x.cpu(), fam / f"{name}_x.pt")
        with fused_blocks(True):
            want[name] = model(x, **_family_noise(md, args.seed + 100 + i))
        want[name] = want[name].cpu()
        if md.interval_logits is not None:
            iv = md.interval_logits(model, x, ROBUST_EPS)
            want[f"{name}_bounds"] = torch.stack([iv.vmin, iv.vmax]).cpu()
        if name in SP_FAMILY_F64:
            want[f"{name}_f64"] = model.double()(x.double()).cpu()
        del model, x
    jobs.append({"kind": "sp_families", "name": "families",
                 "seed": args.seed + 100, "work": str(fam)})

    # (f)-(h): weights and self-labelled shards, the runs' flags
    # (their BNs set to the statistics of the first batch as the shard
    # eval normalizes it)
    runs = {}
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    imgs = np.random.default_rng(args.seed + 131).integers(
        0, 256, (SP_V1_IMAGES, 224, 224, 3), dtype=np.uint8)
    _, model, _ = zoo_model(V1_NAME, args.seed + 130,
                            prepare(torch.from_numpy(imgs[:B]).cuda()))
    self_labelled_shards(lambda xb: ttnet_v1_apply(model, xb), imgs,
                         SP_V1_BATCH, work / "v1_shards")
    torch.save(model.state_dict(), work / "v1.pth")
    runs["v1"] = ["--model", V1_NAME, "--shards_dir",
                  str(work / "v1_shards"), "--ckpt", str(work / "v1.pth"),
                  "--eval_batch_size", str(SP_V1_BATCH)]
    runs["v1_b256"] = runs["v1"][:-2]
    imgs = np.random.default_rng(args.seed + 133).integers(
        0, 256, (SP_CIFAR_IMAGES, 32, 32, 3), dtype=np.uint8)
    _, model, apply = zoo_model("cifar10lownoise", args.seed + 132,
                                prepare(torch.from_numpy(imgs).cuda()))
    self_labelled_shards(apply, imgs, B, work / "cifar_shards")
    torch.save(model.state_dict(), work / "cifar10lownoise.pth")
    runs["certify"] = ["--model", "cifar10lownoise", "--certify",
                       str(ROBUST_EPS), "--shards_dir",
                       str(work / "cifar_shards"), "--ckpt",
                       str(work / "cifar10lownoise.pth")]
    runs["fhe_small"] = ["--model", "TT_FHE_small", "--shards_dir",
                         str(work / "cifar_shards")]
    del model, imgs
    for name, argv in runs.items():
        runs[name] = ["--mode", "eval", "--eval_batch_size", str(B), *argv,
                      "--seed", str(args.seed), "--root_dir",
                      str(work / "logs")]
        for again in ("", "_again") if name == "fhe_small" else ("",):
            jobs.append({"kind": "eval", "name": name + again,
                         "argv": runs[name] + SP_MESH})
    return {"jobs": jobs, "work": work, "family_want": want, "runs": runs}


def check_sp(sp: dict, evals: dict, args) -> dict:
    """The checks and lines of phase 23 (``sp_phase``); returns each
    kernel's launches by rank and run, and the captured launches' rows."""
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply
    from scale_imagenet_tpu_torch.parallel import row_bounds

    B, work, res = args.batch, sp["work"], sp["results"]
    eval_dir = Path("build") / "chip_smoke_eval"
    launches = {}
    batches = -(-EVAL_IMAGES // B)
    # (a) conv eval with the height split, the switch off and on
    for name, fused_n in (("conv", 0), ("conv_fused", 6 * batches)):
        one = evals[name]
        r0, r1 = res[name]
        emit("sp_eval", run=name, mesh="1x2", batch=B,
             rank_images=[r0["rank_images"], r1["rank_images"]],
             images=r0["images"],
             img_s=EVAL_IMAGES / max(r0["eval_s"], r1["eval_s"]),
             img_s_after_first_batch=(
                 EVAL_IMAGES - r0["first_batch_images"]) / max(
                     r0["after_first_s"], r1["after_first_s"]),
             top1=r0["top1"], top5=r0["top5"], loss=r0["loss"],
             one_process={k: one[k] for k in ("top1", "top5", "loss",
                                             "img_s")},
             rank_idle_share=[r0["device_idle_share"],
                              r1["device_idle_share"]],
             rank_max_memory_allocated_gb=[r0["max_memory_allocated_gb"],
                                           r1["max_memory_allocated_gb"]],
             rank_launches=[r0["launches"], r1["launches"]],
             run_s=[r0["run_s"], r1["run_s"]])
        check(r0["images"] == r1["images"] == EVAL_IMAGES
              and r0["rank_images"] == r1["rank_images"] == EVAL_IMAGES,
              f"sp {name} eval scored {r0['images']}, {r1['images']} "
              f"(rank counts {r0['rank_images']}, {r1['rank_images']}), "
              f"expected {EVAL_IMAGES}")
        check(all(r0[k] == r1[k] for k in ("top1", "top5", "loss")),
              f"sp {name} eval: the ranks' metrics differ")
        _within(r0, one, f"sp {name} eval vs one process")
        for r, rr in enumerate((r0, r1)):
            got = rr["launches"]
            check(got["fused_pointwise_block"] == fused_n
                  and not got["lut_window_bits"] and not got["gate_cubes"],
                  f"sp {name} eval rank {r} launched {got}, expected "
                  f"{fused_n} fused")
            for kname, n in got.items():
                launches.setdefault(kname, {})[f"eval_sp_{name}_rank{r}"] = n
    # (b) one forward: its launches against their plain versions, its
    # logits and Heaviside outputs against the one-process forward's
    model = flagship(args.seed)
    model.load_state_dict(torch.load(eval_dir / "weights.pth"))
    x, labels = _sp_prepared(eval_dir, B, None)
    bits = []
    with fused_blocks(True), heaviside_outputs(bits):
        want = ttnet_imagenet_apply(model, x)
    rows, flips, outputs = [], 0, 0
    logits = [torch.from_numpy(np.load(work / f"sp_logits_rank{r}.npy"))
              for r in range(DIST_WORLD)]
    for r, rr in enumerate(res["forward"]):
        got = rr["launches"]
        check(got["fused_pointwise_block"] == 6 and rr["finite"]
              and rr["logits"] == [B, 1000],
              f"sp forward rank {r}: launches {got}, logits {rr['logits']}")
        check(rr["heavisides"] == len(bits),
              f"sp rank {r} ran {rr['heavisides']} Heaviside sites, the "
              f"one-process forward {len(bits)}")
        with np.load(work / f"sp_bits_rank{r}.npz") as mine:
            for i, full in enumerate(bits):
                lo, hi = row_bounds(full.shape[2], DIST_WORLD, r)
                part = np.packbits(full[:, :, lo:hi].cpu().numpy()
                                   .reshape(-1))
                check(mine[f"arr_{i}"].shape == part.shape,
                      f"sp rank {r} Heaviside site {i} has another shape")
                flips += int(np.unpackbits(mine[f"arr_{i}"] ^ part).sum())
                outputs += full[:, :, lo:hi].numel()
        for row in rr["rows"]:
            row["rank"] = r
            rows.append(row)
            emit("sp_kernels", kernel="fused_pointwise_block", **row)
        for kname, n in got.items():
            launches.setdefault(kname, {})[f"sp_forward_rank{r}"] = n
    want = want.cpu()
    agree = float((logits[0].argmax(1) == want.argmax(1)).float().mean())
    emit("sp_forward", mesh="1x2", batch=B,
         rank_launches=[rr["launches"] for rr in res["forward"]],
         ranks_logits_equal=bool(torch.equal(logits[0], logits[1])),
         logit_max_abs_diff=float((logits[0] - want).abs().max()),
         argmax_agreement=agree, heaviside_outputs=outputs,
         heaviside_flipped=flips, flip_share=flips / outputs)
    check(torch.equal(logits[0], logits[1]),
          "sp forward: the two ranks' logits differ")
    check(agree >= SP_ARGMAX_AGREEMENT,
          f"sp forward argmax agreement with one process {agree} < "
          f"{SP_ARGMAX_AGREEMENT}")
    # (c) FGSM through the CLI, and its predictions against one process
    c0, c1 = res["attack"]
    one = _fgsm_predictions(lambda t: ttnet_imagenet_apply(model, t), model,
                            x, labels).cpu().numpy()
    same = [float((np.load(work / f"sp_fgsm_rank{r}.npy") == one).mean())
            for r in range(DIST_WORLD)]
    emit("sp_attack", mesh="1x2", images=SP_ATTACK_IMAGES,
         eps=SP_ATTACK_EPS, top1=c0["top1"], adv=c0["adv"],
         img_s=SP_ATTACK_IMAGES / max(c0["eval_s"], c1["eval_s"]),
         rank_max_memory_allocated_gb=[c0["max_memory_allocated_gb"],
                                       c1["max_memory_allocated_gb"]],
         rank_launches=[c0["launches"], c1["launches"]],
         adv_prediction_agreement_with_one_process=same)
    check(c0["images"] == SP_ATTACK_IMAGES and all(
        c0[k] == c1[k] for k in ("top1", "adv")),
        f"sp attack scored {c0['images']}, ranks {c0['adv']}, {c1['adv']}")
    check(c0["adv"] <= c0["top1"],
          f"sp attack: adversarial top-1 {c0['adv']} > clean {c0['top1']}")
    for r, rr in enumerate((c0, c1)):
        check(rr["launches"]["fused_pointwise_block"] == 12,
              f"sp attack rank {r} launched {rr['launches']}, expected 12 "
              "fused (the clean and adversarial forwards)")
        for kname, n in rr["launches"].items():
            launches.setdefault(kname, {})[f"eval_sp_attack_rank{r}"] = n
    # (d) the utilities
    emit("sp_utils", traced_forward_ms=[rr["traced_forward_ms"]
                                        for rr in res["forward"]],
         trace_files=[rr["trace_files"] for rr in res["forward"]],
         trace_bytes=[rr["trace_bytes"] for rr in res["forward"]])
    check(all(rr["trace_files"] == 1 and rr["trace_bytes"] > 0
              for rr in res["forward"]),
          "utils.profile_trace wrote no trace of the sp forward")

    # (e) every other config type: the sharded forward against the
    # one-process one, each fused launch against its plain version
    family_rows = []
    for name, fused_n in SP_FAMILIES.items():
        got = [rr[name] for rr in res["families"]]
        logits = [np.load(work / "families" / f"{name}_logits_rank{r}.npy")
                  for r in range(DIST_WORLD)]
        want = sp["family_want"][name].numpy()
        agree = float((logits[0].argmax(1) == want.argmax(1)).mean())
        line = {"ranks_logits_equal": bool(np.array_equal(*logits)),
                "logit_max_abs_diff": float(np.abs(logits[0] - want).max()),
                "argmax_agreement": agree}
        if name in SP_FAMILY_F64:
            l64 = [np.load(work / "families"
                           / f"{name}_f64_logits_rank{r}.npy")
                   for r in range(DIST_WORLD)]
            w64 = sp["family_want"][f"{name}_f64"].numpy()
            line = {"f32": line, "f64": {
                "ranks_logits_equal": bool(np.array_equal(*l64)),
                "logit_max_abs_diff": float(np.abs(l64[0] - w64).max()),
                "argmax_agreement": float(
                    (l64[0].argmax(1) == w64.argmax(1)).mean())}}
        if f"{name}_bounds" in sp["family_want"]:
            # --certify's bounds over the eps-ball (raw [0, 1] pixels),
            # the certified masks at the one-process argmax
            b = [np.load(work / "families" / f"{name}_bounds_rank{r}.npy")
                 for r in range(DIST_WORLD)]
            wb = sp["family_want"][f"{name}_bounds"].numpy()
            pred = want.argmax(1)

            def certified(bounds):
                lo, hi = bounds
                mine = lo[np.arange(len(pred)), pred]
                hi = hi.copy()
                hi[np.arange(len(pred)), pred] = -np.inf
                return mine > hi.max(1)

            line["bounds"] = {
                "ranks_equal": bool(np.array_equal(*b)),
                "max_abs_diff": float(np.abs(b[0] - wb).max()),
                "certified": int(certified(wb).sum()),
                "mask_agreement": float((certified(b[0])
                                         == certified(wb)).mean())}
            check(line["bounds"]["ranks_equal"]
                  and line["bounds"]["mask_agreement"]
                  >= SP_ARGMAX_AGREEMENT,
                  f"sp {name} interval bounds: {line['bounds']}")
        emit("sp_family", model=name, mesh="1x2", batch=SP_FAMILY_BATCH,
             logits=got[0]["logits"], **line,
             rank_launches=[g["launches"] for g in got])
        held = line.get("f64", line)
        check(all(g["finite"] for g in got) and np.array_equal(*logits)
              and held["ranks_logits_equal"],
              f"sp {name}: non-finite logits, or the ranks' differ")
        check(held["argmax_agreement"] >= SP_ARGMAX_AGREEMENT,
              f"sp {name} argmax agreement with one process {line} < "
              f"{SP_ARGMAX_AGREEMENT}")
        for r, g in enumerate(got):
            n = g["launches"]
            check(g["captured"] == fused_n
                  and n["fused_pointwise_block"] == fused_n
                  and not n["lut_window_bits"] and not n["gate_cubes"],
                  f"sp {name} rank {r}: {g['captured']} fused heads, "
                  f"launches {n}, expected {fused_n} fused")
            for kname, k in n.items():
                launches.setdefault(kname, {})[
                    f"sp_family_{name}_rank{r}"] = k
            for row in g["rows"]:
                row["rank"] = r
                family_rows.append(row)
                emit("sp_kernels", kernel="fused_pointwise_block", **row)

    # (f)-(h) main --mode eval --sp of the other families against one
    # process
    for name, argv in sp["runs"].items():
        n = SP_V1_IMAGES if name.startswith("v1") else SP_CIFAR_IMAGES
        one = main_eval(argv, False, images=n)
        r0, r1 = res[name]
        keys = ("top1", "top5", "loss", *(("cert",) if name == "certify"
                                          else ()))
        line = {"run": name, "mesh": "1x2", "images": r0["images"],
                **{k: r0[k] for k in keys},
                "one_process": {k: one[k] for k in (*keys, "img_s")},
                "img_s": r0["images"] / max(r0["eval_s"], r1["eval_s"]),
                "rank_max_memory_allocated_gb": [
                    r0["max_memory_allocated_gb"],
                    r1["max_memory_allocated_gb"]],
                "rank_launches": [r0["launches"], r1["launches"]]}
        if name == "fhe_small":
            again = res["fhe_small_again"][0]
            line["again"] = {k: again[k] for k in keys}
        if name == "certify":
            # (g): cert and top-1 equal to one process's, or within one
            # image of them (the line says which)
            line["equal"] = all(r0[k] == one[k] for k in ("cert", "top1"))
            line["within_one_image"] = all(
                abs(r0[k] - one[k]) <= 100.0 / n for k in ("cert", "top1"))
        emit("sp_eval", **line)
        check(r0["images"] == r1["images"] == r0["rank_images"]
              == r1["rank_images"] == n,
              f"sp {name} scored {r0['images']}, {r1['images']} (rank "
              f"counts {r0['rank_images']}, {r1['rank_images']}), expected "
              f"{n}")
        check(all(r0[k] == r1[k] for k in keys),
              f"sp {name}: the ranks' metrics differ")
        # v1_b256 is recorded (``SP_V1_BATCH``)
        if name == "v1":
            _within(r0, one, "sp v1 eval vs one process")
        elif name == "certify":
            check(line["within_one_image"],
                  f"sp --certify vs one process: {line}")
        elif name == "fhe_small":
            check(line["again"] == {k: r0[k] for k in keys},
                  f"sp TT_FHE_small: two runs from one --seed differ: "
                  f"{line}")
        for r, rr in enumerate((r0, r1)):
            for kname, k in rr["launches"].items():
                launches.setdefault(kname, {})[
                    f"eval_sp_{name}_rank{r}"] = k
        if name == "fhe_small":
            for r, rr in enumerate(res["fhe_small_again"]):
                for kname, k in rr["launches"].items():
                    launches.setdefault(kname, {})[
                        f"eval_sp_{name}_again_rank{r}"] = k
    shutil.rmtree(work)
    return {"launches": launches, "rows": rows, "family_rows": family_rows}


SERVE_MESH_REQUESTS = 32            # one concurrent burst a server
SERVE_MESH_BATCH = 16               # --serve_batch: 8 images a replica


@contextlib.contextmanager
def replica_calls(module, attr: str, per: int, keep=None):
    """``module.attr`` patched to record, for each serving replica's
    thread (``replica-d<d>-m<m>``), the ``per`` calls (those ``keep``
    takes) of its second forward: the first is the server's warm-up batch
    of zeros.  Yields ``{thread name: [(args, kwargs, result)]}``."""
    real = getattr(module, attr)
    seen, kept, lock = {}, {}, threading.Lock()

    def rec(*a, **k):
        out = real(*a, **k)
        name = threading.current_thread().name
        if name.startswith("replica-") and (keep is None or keep(*a, **k)):
            with lock:
                i = seen[name] = seen.get(name, -1) + 1
                if per <= i < 2 * per:
                    kept.setdefault(name, []).append((a, k, out))
        return out

    with mock.patch.object(module, attr, rec):
        yield kept


def serve_mesh_phase(args, vgg: dict) -> dict:
    """Serving over several replicas in one process on the one card
    (module docstring, phase 24): ``main(..., devices=[cuda:0] * 2)``."""
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.compile import gate_device as GD
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.lut_eval import \
        compile_ttnet_lut, lut_multihead_apply, lut_ttnet_apply, \
        lut_ttnet_vgg_stem_apply
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.models import get_model, multihead
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
        ttnet_imagenet_apply

    t_phase = time.perf_counter()
    start_phase_launches()
    dev = torch.device("cuda", torch.cuda.current_device())
    one, two = [dev], [dev, dev]
    eval_dir = Path("build") / "chip_smoke_eval"
    weights, lut_path = eval_dir / "weights.pth", eval_dir / "luts.npz"
    n, B = SERVE_MESH_REQUESTS, SERVE_MESH_BATCH
    reqs = torch.rand((n, 224, 224, 3),
                      generator=torch.Generator().manual_seed(args.seed + 40))
    base = ["--ckpt", str(weights), "--seed", str(args.seed)]
    model = get_model("ttnet_imagenet_small", nfilter=8, tfilter=8,
                      layers=1).init(seed=args.seed, device=dev)
    cli.load_checkpoint(model, str(weights))

    def direct(apply, chunk: int) -> list:
        """Top-5 of ``apply`` over the requests, ``chunk`` at a time (a
        replica's padded batch)."""
        top = []
        for i in range(0, n, chunk):
            lg = apply(reqs[i:i + chunk].to(dev))
            top += torch.topk(torch.softmax(lg.float(), -1), 5).indices \
                .tolist()
        return top

    def served(what, argv, devices, want_top5=None, **want_launches):
        """One server's burst: served, top-5 against ``want_top5``, and
        ``want_launches`` a replica forward (the warm-up included)."""
        answers, health, counts = serve_requests(argv, reqs, B, devices)
        batches = health["batches"] + 1
        replicas = health["mesh"]["data"] * (
            health["mesh"]["model"] if health["spatial"] else 1)
        run = {"mesh": health["mesh"], "spatial": health["spatial"],
               "devices": health["devices"], "batches": health["batches"],
               "burst_s": health["burst_s"],
               "img_s": n / health["burst_s"],
               # the batcher's forward of a padded batch: split, replicas,
               # gather (the burst itself is paced by the HTTP front end)
               "batch_ms_p50": health["batch_ms_p50"],
               "batch_ms_p95": health["batch_ms_p95"],
               "forward_img_s": B / health["batch_ms_p50"] * 1e3,
               "launches": counts,
               "top5": [a["top5"] for a in answers],
               "probs": [a["probs"] for a in answers]}
        if want_top5 is not None:
            run["top5_equal"] = sum(a == w for a, w in
                                    zip(run["top5"], want_top5))
        emit("serve_mesh", run=what, **{k: v for k, v in run.items()
                                        if k not in ("top5", "probs")})
        check(health["served"] == n, f"serve_mesh {what}: served "
                                     f"{health['served']} of {n}")
        check(want_top5 is None or run["top5_equal"] == n,
              f"serve_mesh {what}: top-5 of {n - run.get('top5_equal', 0)} "
              "answers differ from the direct forward's")
        for kernel, per in want_launches.items():
            check(counts[kernel] == per * replicas * batches,
                  f"serve_mesh {what}: {counts}, expected {per} "
                  f"{kernel} a replica forward over {replicas} replicas "
                  f"and {batches} batches")
        return run

    def k1(block, *a, **k):
        return block.cfg.k in (1, (1, 1))

    runs, fused_rows, window_rows = {}, [], []
    # (a) two data replicas, the fused switch on; (c)'s one-device run is
    # the burst's one-replica baseline
    with fused_blocks(True):
        want = direct(lambda x: ttnet_imagenet_apply(model, x), B // 2)
        with replica_calls(multihead, "block_tt", 6, k1) as calls:
            runs["dp_fused"] = served(
                "dp_fused", ["--mesh_data", "2", *base], two, want,
                fused_pointwise_block=6)
    check(sorted(calls) == ["replica-d0-m0", "replica-d1-m0"]
          and all(len(v) == 6 for v in calls.values()),
          f"serve_mesh dp_fused: fused launches by replica "
          f"{ {k: len(v) for k, v in calls.items()} }")
    for name, rows in sorted(calls.items()):
        for (block, h, *_), _, _ in rows:
            row = fused_case(block, h, FB)
            row["replica"] = name
            fused_rows.append(row)
            emit("serve_mesh_kernels", kernel="fused_pointwise_block", **row)
    del calls

    # (b) --lut over two data replicas, the eval phase's archive
    luts = cli.load_or_compile_luts(model, str(lut_path))
    want = direct(lambda x: lut_ttnet_apply(luts, model, x), B // 2)
    with replica_calls(lut_eval, "lut_window_bits", 8) as calls:
        runs["dp_lut"] = served(
            "dp_lut", ["--lut", "--lut_path", str(lut_path), "--mesh_data",
                       "2", *base], two, want, lut_window_bits=8)
    check(sorted(calls) == ["replica-d0-m0", "replica-d1-m0"]
          and all(len(v) == 8 for v in calls.values()),
          "serve_mesh dp_lut: window launches by replica "
          f"{ {k: len(v) for k, v in calls.items()} }")
    for name, rows in sorted(calls.items()):
        for a, k, _ in rows:
            xb, words, kk, stride, padding, *rest = a
            heads = rest[0] if rest else k.get("heads", 1)
            row = window_case("bits", xb, words, kk, stride, padding, heads,
                              K)
            row["replica"] = name
            window_rows.append(row)
            emit("serve_mesh_kernels", kernel="lut_window_bits", **row)
    del calls, luts

    # (c) --mesh_model 2 --sp against one device, conv and fused
    sp = ["--mesh_model", "2", "--sp", *base]
    for fused in (False, True):
        tag = "fused" if fused else "conv"
        per = {"fused_pointwise_block": 6 if fused else 0}
        with fused_blocks(fused):
            runs[f"one_{tag}"] = served(f"one_{tag}", base, one, **per)
            runs[f"sp_{tag}"] = served(f"sp_{tag}", sp, two, **per)
        got, ref = runs[f"sp_{tag}"], runs[f"one_{tag}"]
        agree = sum(a == b for a, b in zip(got["top5"], ref["top5"]))
        gap = max(abs(p - q) for a, b in zip(got["probs"], ref["probs"])
                  for p, q in zip(a, b))
        got.update(top5_equal_one_device=agree, prob_max_abs_diff=gap)
        emit("serve_mesh_sp", switch=tag, top5_equal_one_device=agree,
             prob_max_abs_diff=gap)
        check(agree == n, f"serve_mesh sp_{tag}: top-5 of {n - agree} "
                          "answers differ from the one-device server's")

    # (d) the VGG stem's DNF circuit over two data replicas, from phase
    # vgg_stem's covers: each replica's gate bits equal to the tables'
    vmd = get_model("ttnet_imagenet_vgg_stem")
    vmodel = vmd.init(seed=args.seed, device=dev)
    vmodel.load_state_dict(vgg["state"])
    vweights = Path("build") / "chip_smoke_serve_mesh_vgg.pth"
    torch.save(vgg["state"], vweights)
    vluts = compile_ttnet_lut(vmodel)
    want = direct(lambda x: lut_ttnet_vgg_stem_apply(vluts, vmodel, x),
                  B // 2)
    real_gates = cli._as_gate_model

    def with_covers(m, form, gnets=None):
        return real_gates(m, form, vgg["gnets"])

    with mock.patch.object(cli, "_as_gate_model", with_covers), \
            replica_calls(GD, "gate_multihead_apply_device", 1) as calls:
        runs["dp_gates"] = served(
            "dp_gates", ["--model", vmd.name, "--ckpt", str(vweights),
                         "--gates", "dnf", "--mesh_data", "2"], two, want,
            gate_cubes=3)
    vweights.unlink()
    mism = {}
    for name, rows in sorted(calls.items()):
        (_, h), _, out = rows[0]
        mism[name] = int((out != lut_multihead_apply(vluts[0], h)).sum())
    runs["dp_gates"]["gate_bit_mismatches_vs_lut"] = mism
    emit("serve_mesh_gates", gate_bit_mismatches_vs_lut=mism)
    check(sorted(mism) == ["replica-d0-m0", "replica-d1-m0"]
          and not any(mism.values()),
          f"serve_mesh dp_gates: gate bits differ from the LUT's: {mism}")
    del calls, vluts, vmodel, model

    launches = phase_launches()
    phase_s = time.perf_counter() - t_phase
    speedup = runs["dp_fused"]["img_s"] / runs["one_fused"]["img_s"]
    emit("serve_mesh_phase", phase_s=phase_s, launches=launches,
         burst_img_s_one_replica=runs["one_fused"]["img_s"],
         burst_img_s_two_replicas=runs["dp_fused"]["img_s"],
         two_over_one=speedup,
         forward_img_s_one_replica=runs["one_fused"]["forward_img_s"],
         forward_img_s_two_replicas=runs["dp_fused"]["forward_img_s"],
         forward_two_over_one=runs["dp_fused"]["forward_img_s"]
         / runs["one_fused"]["forward_img_s"])
    for run in runs.values():
        del run["top5"], run["probs"]
    return {"runs": runs, "fused": fused_rows, "windows": window_rows,
            "launches": launches, "phase_s": phase_s}


def native_data_missing() -> str | None:
    """What the native decode phase lacks on this machine, or None: g++
    with ``jpeglib.h`` and libjpeg (one tiny program compiled and linked),
    and Pillow (to write the JPEGs and run the PIL route)."""
    import importlib.util

    if shutil.which("g++") is None:
        return "g++"
    r = subprocess.run(
        ["g++", "-x", "c++", "-", "-ljpeg", "-o", "/dev/null"],
        input="#include <cstdio>\n#include <jpeglib.h>\nint main() { "
              "jpeg_decompress_struct c; jpeg_create_decompress(&c); "
              "return 0; }\n", capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        errors = [ln for ln in r.stderr.splitlines() if "error" in ln]
        return "jpeglib.h or libjpeg (g++: " + \
            (errors or r.stderr.splitlines() or ["?"])[0][:200] + ")"
    if importlib.util.find_spec("PIL") is None:
        return "Pillow"
    return None


NATIVE_IMAGES = 512


def native_data_phase(args, out_dir: Path) -> dict | None:
    """22: where g++ finds libjpeg and Pillow imports, 512 seeded JPEGs of
    mixed sizes (four classes) under ``build/``, ``main --mode eval
    --data_dir`` over them with and without ``--native_data``: equal
    metrics (identical pixels), both eval rates, and both decode rates
    alone (one thread, the same images)."""
    missing = native_data_missing()
    if missing is not None:
        print(f"native_data: not run: {missing}", flush=True)
        return None
    from PIL import Image

    from scale_imagenet_tpu_torch.data import ImageFolder, \
        imagenet_eval_transform
    from scale_imagenet_tpu_torch.native.ttdata import load_eval_batch

    work = Path("build") / "chip_smoke_native"
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(args.seed + 11)
    sizes = [(500, 375), (375, 500), (640, 480), (256, 256), (300, 257),
             (1024, 683)]
    for i in range(NATIVE_IMAGES):
        d = work / "val" / f"n{i % 4:08d}"
        d.mkdir(parents=True, exist_ok=True)
        w, h = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([(xx * (i % 7 + 1)) % 256, (yy * 3) % 256,
                           ((xx + yy) // 2) % 256], -1)
        noise = rng.integers(0, 64, (h, w, 3))
        Image.fromarray(((smooth + noise) % 256).astype(np.uint8)).save(
            d / f"{i:04d}.jpg", quality=90)
    argv = ["--mode", "eval", "--data_dir", str(work), "--eval_batch_size",
            str(args.batch), "--seed", str(args.seed), "--root_dir",
            str(work / "logs")]
    runs = {"pil": main_eval(argv, False, NATIVE_IMAGES),
            "native": main_eval(argv + ["--native_data"], False,
                                NATIVE_IMAGES)}
    ds = ImageFolder(str(work / "val"), imagenet_eval_transform)
    paths = [p for p, _ in ds.samples]
    t = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    pil_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(0, len(paths), 64):
        load_eval_batch(paths[i:i + 64])
    native_s = time.perf_counter() - t
    emit("native_data", images=NATIVE_IMAGES,
         **{f"{k}_{m}": v[m] for k, v in runs.items()
            for m in ("top1", "top5", "loss", "img_s",
                      "device_idle_share")},
         pil_decode_img_s=NATIVE_IMAGES / pil_s,
         native_decode_img_s=NATIVE_IMAGES / native_s)
    check(all(runs["pil"][k] == runs["native"][k]
              for k in ("top1", "top5", "loss")),
          f"--native_data metrics {runs['native']} differ from the PIL "
          f"route's {runs['pil']}")
    shutil.rmtree(work)
    return runs


def serve_requests(argv: list, reqs: torch.Tensor, batch: int,
                   devices=None):
    """``main --mode serve --serve_batch batch`` (and ``argv``; over
    ``devices`` where given, ``main``'s hook) in a thread, one concurrent
    raw-f32 request an image of ``reqs``: the answers, ``/healthz`` with
    the burst's seconds (``burst_s``: the first request sent to the last
    answer) and the port's kernel launches of the run (the counts set to 0
    just before it)."""
    from scale_imagenet_tpu_torch import main as cli

    ready, stop = threading.Event(), threading.Event()
    errors = []
    reset_kernel_launches()

    def run_server():
        try:
            cli.main(["--mode", "serve", "--serve_batch", str(batch),
                      "--port", "0", *argv],
                     serve_ready=ready, serve_stop=stop, devices=devices)
        except BaseException as e:        # reported by the main thread
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run_server, daemon=True)
    th.start()
    check(ready.wait(600) and not errors, f"server failed: {errors}")
    url = f"http://127.0.0.1:{ready.port}"

    def post(i):
        req = urllib.request.Request(
            url + "/predict", data=reqs[i].numpy().tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(len(reqs)) as pool:
        t = time.perf_counter()
        answers = list(pool.map(post, range(len(reqs))))
        burst_s = time.perf_counter() - t
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    health["burst_s"] = burst_s
    stop.set()
    th.join(60)
    check(not th.is_alive() and not errors, f"server stop: {errors}")
    return answers, health, kernel_launches()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out_dir", type=Path, default=Path("build/chip_smoke"),
                    help="where the profile tables, the per-launch kernel "
                         "cases and the ptxas logs go")
    # a rank of the distributed phase (``launch_dist`` starts them)
    ap.add_argument("--dist_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist_jobs", type=str, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist_out", type=str, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with torch.no_grad():
        if args.dist_rank is not None:
            return dist_worker(args)
        return run(args)


def run(args) -> int:
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut, \
        lut_multihead_apply, lut_ttnet_apply, _bits
    from scale_imagenet_tpu_torch.kernels import build
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem, \
        ttnet_imagenet_apply

    smoke_t0 = time.perf_counter()
    laps, lap_t = {}, [smoke_t0]

    def lap(name):
        """The seconds since the last lap, under ``name`` (the smoke
        line's ``phase_s``: where the time limit goes)."""
        now = time.perf_counter()
        laps[name], lap_t[0] = now - lap_t[0], now
    card = card_line()
    print(card, flush=True)
    out_dir = args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    B = args.batch

    # ------------------------------------------------------------ setup
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            (out_dir / f"ptxas_{name}.log").write_text(log.read_text())
    fused_build = fused_build_report(libs["fused_block"], out_dir)
    for r in fused_build:
        r["function"] = re.sub(r"^_ZN\w*?_GLOBAL__N_\w*?\d+(fused)",
                               r"\1", r["function"])
    emit("fused_build", instantiations=fused_build)
    md = get_model("ttnet_imagenet_small", nfilter=8, tfilter=8, layers=1)
    model = md.init(seed=args.seed, device=dev)
    perturb_bn(model, args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    luts = compile_ttnet_lut(model)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    nonconst = sum(h.nonconstant for lut in luts
                   for h in [*lut.heads.values(), lut.convf])
    filters = sum(h.cfg.out_planes for lut in luts
                  for h in [*lut.heads.values(), lut.convf])
    emit("setup", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, compile_tables_s=compile_s,
         filters=filters, nonconstant_filters=nonconst)

    gen = torch.Generator().manual_seed(args.seed + 2)
    x = torch.rand((B, 224, 224, 3), generator=gen).to(dev)
    lap("setup")

    # ---------------------------------------------------------- kernels
    captured = []
    real_bits = lut_eval.lut_window_bits
    real_float = lut_eval.lut_window_float

    def rec_bits(xb, words, k, stride, padding, heads=1):
        captured.append(("bits", xb, words, k, stride, padding, heads))
        return real_bits(xb, words, k, stride, padding, heads)

    def rec_float(xb, table, k, stride, padding):
        captured.append(("float", xb, table, k, stride, padding, 1))
        return real_float(xb, table, k, stride, padding)

    with mock.patch.object(lut_eval, "lut_window_bits", rec_bits), \
            mock.patch.object(lut_eval, "lut_window_float", rec_float):
        lut_ttnet_apply(luts, model, x, last_via_conv=False)
    check([c[0] for c in captured].count("bits") == 8,
          "expected 8 lut_window_bits launches a forward")
    check([c[0] for c in captured].count("float") == 1,
          "expected 1 lut_window_float launch in the table-exact forward")
    cases = {"bits": [], "float": []}
    for kind, *launch in captured:
        row = window_case(kind, *launch, K)
        cases[kind].append(row)
        emit("kernels", kernel=f"lut_window_{kind}", **row)
    (out_dir / "kernel_cases.json").write_text(json.dumps(cases, indent=1))
    del captured
    torch.cuda.synchronize()
    lap("kernels")

    # ------------------------------------------------------------ model
    ref = ttnet_imagenet_apply(model, x)
    K.reset_launches()
    got = lut_ttnet_apply(luts, model, x)
    torch.cuda.synchronize()
    check(K.lut_window_bits.launches == 8,
          f"{K.lut_window_bits.launches} lut_window_bits launches, "
          "expected 8")
    check(ref.shape == (B, 1000) and bool(torch.isfinite(ref).all())
          and bool(torch.isfinite(got).all()), "non-finite or misshapen logits")
    with mock.patch.object(lut_eval, "lut_window_bits",
                           K.lut_window_bits_plain), \
            mock.patch.object(lut_eval, "lut_window_float",
                              K.lut_window_float_plain):
        got_plain = lut_ttnet_apply(luts, model, x)
        got_tab_plain = lut_ttnet_apply(luts, model, x, last_via_conv=False)
    check(torch.equal(got, got_plain),
          "LUT logits through the kernels differ from the plain versions'")
    # per-block agreement of the two chains, each fed by itself
    hc = stem(model, _nchw(x, model))
    hl = _bits(hc, None)
    mism = []
    for lut, block in zip(luts, model.blocks):
        hc = block(hc)
        hl = lut_multihead_apply(lut, hl, convf_float=block.Block_convf)
        if lut.convf.cfg.last:
            mism.append(float((hc - hl.float()).abs().max()))
        else:
            mism.append(float((hc != hl.float()).float().mean()))
    top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
    K.reset_launches()
    got_tab = lut_ttnet_apply(luts, model, x, last_via_conv=False)
    torch.cuda.synchronize()
    table_exact_launches = {"lut_window_bits": K.lut_window_bits.launches,
                            "lut_window_float": K.lut_window_float.launches}
    check(torch.equal(got_tab, got_tab_plain),
          "table-exact logits through the kernels differ from the plain "
          "versions'")
    tab_err = float((got_tab - got).abs().max())
    emit("model", batch=B, top1_agreement=top1,
         block_bit_mismatch_frac=mism[:-1], last_block_max_abs_diff=mism[-1],
         logit_max_abs_diff_conv_vs_lut=float((ref - got).abs().max()),
         kernel_equals_plain=True, table_exact_max_abs_diff=tab_err,
         table_exact_launches=table_exact_launches)
    check(top1 >= 0.99, f"top-1 agreement conv vs LUT {top1} < 0.99")
    check(table_exact_launches == {"lut_window_bits": 8,
                                   "lut_window_float": 1},
          f"table-exact launches {table_exact_launches}")
    check(torch.allclose(got_tab, got, rtol=1e-4, atol=1e-4),
          f"table-exact logits differ from the default by {tab_err}")
    lap("model")

    # ------------------------------------------------------------ serve
    imgs = torch.rand((16, 224, 224, 3), generator=gen)
    answers, health, serve_launches = serve_requests(
        ["--lut", "--seed", str(args.seed)], imgs, batch=8)
    # the direct forward: the same seed's model, unperturbed, B = 8 (the
    # server's padded shape)
    smodel = md.init(seed=args.seed, device=dev)
    sluts = compile_ttnet_lut(smodel)
    direct = []
    for i in range(0, 16, 8):
        lg = lut_ttnet_apply(sluts, smodel, imgs[i:i + 8].to(dev))
        direct += [torch.topk(torch.softmax(lg, -1), 5).indices.tolist()]
    direct = [row for chunk in direct for row in chunk]
    agree = sum(a["top5"] == d for a, d in zip(answers, direct))
    emit("serve", requests=16, healthz=health, top5_equal=agree,
         launches=serve_launches,
         latency_ms=[a["latency_ms"] for a in answers])
    check(health["served"] == 16, f"healthz served {health['served']}")
    check(agree == 16, f"top-5 of {16 - agree} answers differ from direct")
    # 8 launches a batch, the server's warm-up batch included
    check(serve_launches["lut_window_bits"] == 8 * (health["batches"] + 1),
          f"serve ran {serve_launches} launches")
    del smodel, sluts
    lap("serve")

    # ---------------------------------------------------- fused kernels
    fused_rows = fused_kernels_phase(model, x, out_dir)
    torch.cuda.synchronize()
    lap("fused_kernels")

    # ------------------------------------------------------------- eval
    evals = eval_phase(args, model, out_dir)
    lap("eval")

    # ----------------------------------------------- serving transforms
    transforms = serving_transforms_phase(args, md, model, x, out_dir)
    torch.cuda.synchronize()
    lap("serving_transforms")

    # ------------------------------------------------------------ gates
    gates = gates_phase(args, md, model, luts, x, out_dir)
    torch.cuda.synchronize()
    lap("gates")

    # --------------------------------------------------------- VGG stem
    vgg = vgg_stem_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("vgg_stem")

    # --------------------------------------------------------------- v2
    v2 = v2_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("v2")

    # ------------------------------------------------- VGG-stem training
    with torch.enable_grad():
        vgg_train_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("vgg_stem_training")

    # ------------------------------------------------------ TT_FHE family
    fhe = fhe_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("tt_fhe_family")

    # ---------------------------------------------- TT_FHE training
    with torch.enable_grad():
        fhe_train_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("tt_fhe_training")

    # -------------------------------------------------------- v1 family
    v1_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("v1_family")

    # --------------------------------- TT_general, the CIFAR zoo, ResNets
    zoo = {"general": general_phase(args, out_dir)}
    torch.cuda.synchronize()
    zoo["cifar_zoo"] = cifar_zoo_phase(args, out_dir)
    torch.cuda.synchronize()
    zoo["resnet"] = resnet_phase(args, out_dir)
    torch.cuda.synchronize()
    lap("tt_general_the_cifar_zoo_resnets")

    # ------------------------------------------------------------ robust
    zoo["robust"] = robust_phase(args, model, out_dir)
    torch.cuda.synchronize()
    lap("robust")

    # ------------------------------------------------------------ train
    with torch.enable_grad():
        train_phase(args, model, out_dir)
    lap("train")

    # ------------------------- distributed, tensor and spatial parallel
    # one launch of the rank processes runs the three phases' jobs; the tp
    # and sp laps take their own jobs' seconds, the launch's set-up stays
    # with 21
    t0 = time.perf_counter()
    dist, tp, sp = distributed_phase(args), tp_phase(args), sp_phase(args)
    launch_s = launch_phases((dist, tp, sp), out_dir)
    dist_launches = check_distributed(dist, evals, args)
    emit("distributed_phase", seconds=time.perf_counter() - t0
         - tp["ranks_s"] - sp["ranks_s"], ranks_s=dist["ranks_s"],
         launch_s=launch_s)
    lap("distributed")
    laps["distributed"] -= tp["ranks_s"] + sp["ranks_s"]

    t0 = time.perf_counter()
    tp_checked = check_tp(tp, evals, args)
    emit("tp_phase", seconds=time.perf_counter() - t0 + tp["ranks_s"],
         ranks_s=tp["ranks_s"])
    lap("tp")
    laps["tp"] += tp["ranks_s"]

    t0 = time.perf_counter()
    sp_checked = check_sp(sp, evals, args)
    shutil.rmtree(Path("build") / "chip_smoke_train")
    emit("sp_phase", seconds=time.perf_counter() - t0 + sp["ranks_s"],
         ranks_s=sp["ranks_s"])
    lap("sp")
    laps["sp"] += sp["ranks_s"]

    # ---------------------------------------- serving over two replicas
    serve_mesh = serve_mesh_phase(args, vgg)
    shutil.rmtree(Path("build") / "chip_smoke_eval")
    torch.cuda.synchronize()
    lap("serve_mesh")

    # ------------------------------------------------------- native data
    t0 = time.perf_counter()
    native = native_data_phase(args, out_dir)
    emit("native_data_phase", ran=native is not None,
         seconds=time.perf_counter() - t0)
    lap("native_data")

    # ------------------------------------------------------------- perf
    x1 = x[:1].contiguous()
    perf = {
        "conv_b1_ms": wall_ms(lambda: ttnet_imagenet_apply(model, x1), 50),
        "lut_b1_ms": wall_ms(lambda: lut_ttnet_apply(luts, model, x1), 50),
        "conv_b256_ms": wall_ms(lambda: ttnet_imagenet_apply(model, x), 10),
        "lut_b256_ms": wall_ms(lambda: lut_ttnet_apply(luts, model, x), 10),
    }
    with fused_blocks(True):
        perf["conv_fused_b256_ms"] = wall_ms(
            lambda: ttnet_imagenet_apply(model, x), 10)
        perf["lut_fused_b256_ms"] = wall_ms(
            lambda: lut_ttnet_apply(luts, model, x), 10)
    for name in ("conv", "conv_fused", "lut", "lut_fused"):
        perf[f"{name}_img_s"] = B / perf[f"{name}_b256_ms"] * 1e3
    emit("perf", card=card, batch=B, **perf)
    profile_forward("conv", lambda: ttnet_imagenet_apply(model, x), B,
                    out_dir)
    with fused_blocks(True):
        profile_forward("conv_fused", lambda: ttnet_imagenet_apply(model, x),
                        B, out_dir)
    convs = {"lut": profile_forward(
        "lut", lambda: lut_ttnet_apply(luts, model, x), B, out_dir)}
    with fused_blocks(True):
        convs["lut_fused"] = profile_forward(
            "lut_fused", lambda: lut_ttnet_apply(luts, model, x), B, out_dir)
    # no index conv: the stem's conv, and the last block's float fuse head
    # (two convs) unless the fused kernel runs it
    check(convs == {"lut": 3, "lut_fused": 1},
          f"convolutions a LUT forward: {convs}, expected the stem's and "
          "the float fuse head's only")

    def sums(rows, prefix=""):
        """A forward's launches summed: ms, plain, bound (and the library
        lookup and chain where the rows have them)."""
        out = {f"{prefix}{k}": sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "bound_fma_ms",
                         "library_ms", "chain_ms") if k in rows[0]}
        # the kind that bounds the larger part of the summed bound
        share = {kind: sum(r["bound_ms"] for r in rows
                           if r["bound_by"] == kind)
                 for kind in ("bytes", "operations")}
        out[f"{prefix}bound_by"] = max(share, key=share.get)
        return out

    def entry(name, source, replaces, by_path, rows, vgg_rows=(),
              err="max_abs_err", library=True, more=()):
        """One kernel's line: ``launches`` the sum over the paths that
        launch it, each counted from 0 over its run (``launches_by_path``);
        the times a flagship forward's launches take, the VGG stem's under
        ``vgg_stem_*`` and those of ``more``'s ``(prefix, rows)``; the
        worst error over every case."""
        extra = [r for _, rs in more for r in rs]
        line = {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(r[err] for r in [*rows, *vgg_rows,
                                                    *extra]),
                **sums(rows)}
        if not library:
            line["library_ms"] = None
        if vgg_rows:
            line.update(sums(vgg_rows, "vgg_stem_"))
        for prefix, rs in more:
            line.update(sums(rs, prefix))
        return line

    fhe_models = fhe["models"]

    def fhe_paths(kernel, runs):
        """This kernel's launches in each TT_FHE model's eval runs."""
        return {f"eval_fhe_{m}_{run}": res["evals"][run]["launches"][kernel]
                for m, res in fhe_models.items() for run in runs
                if run in res["evals"]}

    def by_model(rows):
        return [(f"fhe_{m}_", [r for r in rows if r["model"] == m])
                for m in FHE_CASES]

    vgg_evals = vgg["evals"]
    kernels = [
        entry("lut_window_bits",
              "scale_imagenet_tpu_torch/csrc/lut_gather.cu",
              "scale_imagenet_tpu/pallas/lut_gather.py:84",
              {"serve_flagship": serve_launches["lut_window_bits"],
               "serve_vgg_stem": vgg["serve_launches"]["lut"][
                   "lut_window_bits"],
               "eval_vgg_stem_lut": vgg_evals["lut_write"]["launches"][
                   "lut_window_bits"],
               **fhe_paths("lut_window_bits", ("lut",))},
              cases["bits"], vgg["windows"],
              more=by_model(fhe["windows"])),
        entry("lut_window_float",
              "scale_imagenet_tpu_torch/csrc/lut_gather.cu",
              "scale_imagenet_tpu/pallas/lut_gather.py:107",
              {"table_exact_forward": table_exact_launches[
                  "lut_window_float"]}, cases["float"]),
        entry("fused_pointwise_block",
              "scale_imagenet_tpu_torch/csrc/fused_block.cu",
              "scale_imagenet_tpu/pallas/fused_block.py:41, "
              "scale_imagenet_tpu/pallas/fused_block.py:191",
              {"eval_conv_fused": evals["conv_fused"]["launches"][
                  "fused_pointwise_block"],
               **{f"eval_{k}": v["launches"]["fused_pointwise_block"]
                  for k, v in transforms["evals"].items()},
               "eval_vgg_stem_conv_fused": vgg_evals["conv_fused"][
                   "launches"]["fused_pointwise_block"],
               "eval_v2_conv_fused": v2["evals"]["conv_fused"]["launches"][
                   "fused_pointwise_block"],
               "serve_v2_fused": v2["serve_launches"][
                   "fused_pointwise_block"],
               **fhe_paths("fused_pointwise_block", ("conv_fused",))},
              fused_rows, vgg["fused"], err="max_abs_err_float32",
              library=False,
              more=[("v2_", v2["fused"]), *by_model(fhe["fused"])]),
        entry("gate_cubes", "scale_imagenet_tpu_torch/csrc/gate_cubes.cu",
              "scale_imagenet_tpu/compile/gate_device.py:195 (XLA ops; no "
              "Pallas kernel)",
              {"eval_gates_flagship": gates["launches"],
               "serve_vgg_stem_gates_dnf": vgg["serve_launches"][
                   "gates_dnf"]["gate_cubes"],
               **{f"eval_vgg_stem_{k}": vgg_evals[k]["launches"][
                   "gate_cubes"] for k in ("gates_dnf", "gates_cnf")},
               **fhe_paths("gate_cubes", ("gates_dnf", "gates_cnf"))},
              gates["dnf_cases"], [r for r in vgg["gates"]
                                   if not r["invert"]], library=False,
              more=[(p, [r for r in rs if not r["invert"]])
                    for p, rs in by_model(fhe["gates"])]),
    ]
    # the zoo and robust phases, each counted from 0 over the whole phase
    # (every run, forward, calibration and step in it,
    # ``phase_launches``): none in the zoo's; in the robust one the fused
    # launches of the flagship attacks' clean and adversarial forwards
    for line in kernels:
        for phase, res in zoo.items():
            line["launches_by_path"][phase] = res["launches"][line["name"]]
            line["launches"] += res["launches"][line["name"]]
        # phase serve_mesh's servers, each counted from 0 over its run
        # (every replica's batches, the warm-up's included)
        for name, res in serve_mesh["runs"].items():
            n = res["launches"][line["name"]]
            if n:
                line["launches_by_path"][f"serve_mesh_{name}"] = n
                line["launches"] += n
        # the distributed, tensor- and spatial-parallel phases' ranks, each
        # run counted from 0 in its rank's process
        for runs in (dist_launches, tp_checked["launches"],
                     sp_checked["launches"]):
            for path, n in runs.get(line["name"], {}).items():
                line["launches_by_path"][path] = n
                line["launches"] += n
    # the launches of one TP --lut forward, each rank's at its local width,
    # and of one --sp forward, each rank's on its rows, against their plain
    # versions: times summed over rank 0's forward
    for line, prefix, got, err in (
            (kernels[0], "tp_", tp_checked["rows"]["bits"], "max_abs_err"),
            (kernels[2], "tp_", tp_checked["rows"]["fused"],
             "max_abs_err_float32"),
            (kernels[2], "sp_", sp_checked["rows"], "max_abs_err_float32"),
            (kernels[2], "sp_families_", sp_checked["family_rows"],
             "max_abs_err_float32")):
        line.update(sums([r for r in got if r["rank"] == 0], prefix))
        line["max_abs_err"] = max(line["max_abs_err"],
                                  *(r[err] for r in got))
    # the launches of one served batch on each replica of phase serve_mesh
    # against their plain versions: times summed over replica d0's batch
    for line, got, err in ((kernels[0], serve_mesh["windows"], "max_abs_err"),
                           (kernels[2], serve_mesh["fused"],
                            "max_abs_err_float32")):
        line.update(sums([r for r in got if r["replica"] == "replica-d0-m0"],
                         "serve_mesh_"))
        line["max_abs_err"] = max(line["max_abs_err"],
                                  *(r[err] for r in got))
    # the cases under the serving transforms: bf16 x, folded biases
    fused_line = kernels[2]
    fused_line["max_abs_err"] = max(
        fused_line["max_abs_err"],
        *(r["max_abs_err_float32"] for r in transforms["rows"]))
    fused_line.update({f"{t}_{k}": v for t in ("bf16", "fold") for k, v in
                       sums([r for r in transforms["rows"]
                             if r["transform"] == t]).items()})
    # every gate case, CNF included, counts towards the worst error
    kernels[3]["max_abs_err"] = max(
        r["max_abs_err"] for r in [*gates["cases"], *vgg["gates"],
                                   *fhe["gates"]])
    lap("perf")
    emit("smoke", seconds=time.perf_counter() - smoke_t0, phase_s=laps)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
