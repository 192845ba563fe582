"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--batch 256] [--out_dir build/chip_smoke]

Drives the port's main paths on the flagship TTnet-Small (p = 64,
--layers 1, 224x224): served as its compiled truth tables over HTTP,
evaluated from uint8 shards (``--mode eval``, conv and ``--lut``, with the
fused pointwise kernel on), compiled to gate circuits and evaluated as them
(``--mode compile``, ``--mode eval --gates dnf|cnf``) and trained from
uint8 pre-crop shards (``--mode train``), and holds every CUDA kernel
against its plain PyTorch version.  Phases, each printing one line of its
numbers:

1. setup:  build every CUDA source (one nvcc each, all started together),
           build the flagship from --seed with its BN running statistics
           perturbed, compile its truth tables;
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
           chain, times of the kernel, the plain version and the chain,
           the bound;
6. eval:   5,000 seeded uint8 images labelled by the unfused conv
           forward's argmax (the classifier BN's statistics set from the
           first batch, so that the labels spread over many classes),
           written with ``write_shards`` under ``build/``, then
           ``main --mode eval --shards_dir`` at B=256 four times: conv with
           the switch off, conv with it on, ``--lut --lut_path F`` (writes
           F) and again (loads F); top-1/5, loss, img/s, the device's idle
           share and the launch counts of each run;
7. gates:  (a) the flagship's covers compiled once in-process (seconds,
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
           (e) ``evaluate`` over the eval phase's 5,000 shard images through
           the function ``main --mode eval --gates`` uses, DNF and CNF: img/s,
           idle share, top-1 >= 99 %; (f) ``export_model_verilog`` of the
           same covers, its total equal to ``total_gates``; (g) ``main --mode
           compile --verilog`` in a subprocess from the same weights, its
           ``total_gates`` equal to the in-process total on the boolean
           heads and its Verilog total equal to it (each filter minimized
           once: the Verilog reuses the artifacts' covers); (h) the
           ``gate_cubes`` card tests (``tests/test_torch_cuda.py -k gate_``)
           in a subprocess, all passed.  Artifacts go under ``build/``;
8. train:  (a) one f32 step of the flagship at B=256, no augmentation, on
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
9. perf:   B=1 latency and B=256 throughput, conv and LUT (each with the
           switch off and on: with it on, the LUT forward's last float
           fuse head runs through the fused kernel), and each B=256
           forward's device time by kernel (``torch.profiler``); a LUT
           forward runs no convolution but the stem's and the last float
           fuse head's.

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
import json
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
EVAL_IMAGES = 5000
TRAIN_IMAGES = 2560                # 10 steps of B = 256 an epoch
# one f32 step of the flagship, card against CPU (PERF.md states these):
# relative loss gap, cosine of the parameter updates, flipped Heavisides
TRAIN_LOSS_GAP = 1e-3
TRAIN_UPDATE_COSINE = 0.99
TRAIN_FLIP_SHARE = 1e-3
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


def fused_case(block, x, FB):
    """Kernel vs plain (f32 and bf16) and vs the exact-erf unfused chain at
    one captured launch of the fused pointwise block; times and bound."""
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
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        got = rows(FB.fused_pointwise_nchw(xd, params, act))
        want = FB.fused_pointwise_block_plain(rows(xd), *params, act=act)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        check(got.dtype == dt, f"fused kernel stored {got.dtype} at {where}")
        if act == "relu":
            err = float((got.float() - want.float()).abs().max())
            # f32: FMA contraction and summation order; bf16: one step
            check(torch.allclose(got.float(), want.float(), rtol=(
                0 if dt == torch.float32 else 2 ** -8), atol=1e-5),
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
    nbytes = (x.numel() * x.element_size() + b * h * w * g * co * 4
              + sum(t.numel() * 4 for t in params))
    ops = fused_ops(b * h * w, g, ci, m, co)
    row.update(ms=time_ms(run), plain_ms=time_ms(plain),
               chain_ms=time_ms(chain), bytes=nbytes, ops=ops,
               bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= ops / OPS_PER_S else "operations")
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


def eval_phase(args, model, out_dir: Path) -> dict:
    """``main --mode eval`` over self-labelled shards: conv (switch off,
    on), LUT writing its archive, LUT loading it."""
    from torch.profiler import ProfilerActivity, profile

    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.data import ArrayDataset, IMAGENET_MEAN, \
        IMAGENET_STD, pad_batches, write_shards
    from scale_imagenet_tpu_torch.kernels import fused_block as FB
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch.layers.linear import linear
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
    # with the init's statistics, the classifier BN maps every image of a
    # seeded random network to one class; set them from the first batch so
    # that the argmax depends on the image
    model = copy.deepcopy(model)
    head = model.classifier
    with fused_blocks(False):
        z = linear(ttnet_imagenet_features(model, prepare(
            torch.from_numpy(imgs[:B]).cuda())), head.lin1.weight)
        head.BN2.running_mean.copy_(z.mean(0))
        head.BN2.running_var.copy_(z.var(0))
        labels = []
        for batch, _ in pad_batches(((imgs[i:i + B], np.zeros(
                min(B, n - i), np.int32)) for i in range(0, n, B)), B):
            xb = prepare(torch.from_numpy(batch).cuda())
            labels.append(ttnet_imagenet_apply(model, xb).argmax(1).cpu())
    labels = torch.cat(labels)[:n].numpy().astype(np.int32)
    write_shards(ArrayDataset(imgs, labels), str(work / "shards"))
    ckpt = work / "weights.pth"
    torch.save(model.state_dict(), ckpt)
    lut_path = work / "luts.npz"
    del imgs, model, z
    emit("eval_setup", images=n, batch=B, classes_hit=int(
        np.unique(labels).size), setup_s=time.perf_counter() - t0)

    base = ["--mode", "eval", "--shards_dir", str(work / "shards"),
            "--eval_batch_size", str(B), "--seed", str(args.seed),
            "--ckpt", str(ckpt), "--root_dir", str(work / "logs")]
    batches = -(-n // B)
    real_evaluate = cli.evaluate
    results = {}
    for name, extra, fused in (
            ("conv", [], False), ("conv_fused", [], True),
            ("lut_write", ["--lut", "--lut_path", str(lut_path)], True),
            ("lut_load", ["--lut", "--lut_path", str(lut_path)], True)):
        stats = {}

        def timed(*a, **k):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                res = real_evaluate(*a, **k)
                torch.cuda.synchronize()
                stats["wall_s"] = time.perf_counter() - t
            stats["busy_s"] = busy_ns(device_spans(prof)) / 1e9
            return res

        K.reset_launches()
        FB.reset_launches()
        t = time.perf_counter()
        with mock.patch.object(cli, "evaluate", timed), fused_blocks(fused):
            top1, top5, loss = cli.main(base + extra)
        torch.cuda.synchronize()
        launches = {"fused_pointwise_block": FB.fused_pointwise_block.launches,
                    "lut_window_bits": K.lut_window_bits.launches,
                    "lut_window_float": K.lut_window_float.launches}
        results[name] = {"top1": top1, "top5": top5, "loss": loss,
                         "img_s": n / stats["wall_s"],
                         "eval_s": stats["wall_s"],
                         "device_idle_share": 1 - stats["busy_s"]
                         / stats["wall_s"],
                         "run_s": time.perf_counter() - t,
                         "launches": launches}
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
    # the shards and the weights stay: the gates phase scores them, the
    # train phase validates on the shards
    lut_path.unlink()
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
            top1, top5, loss = cli._eval(cfg, apply, x.device, 224)
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
    (eval_dir / "weights.pth").unlink()

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
    ``sink`` as a bool tensor on its device (the stem's, each Block_TT's and
    each pooled head 4's)."""
    from scale_imagenet_tpu_torch.models import block_tt, ttnet_imagenet
    from scale_imagenet_tpu_torch.ops import binarize

    real = binarize.heaviside01

    def rec(x, *a, **k):
        out = real(x, *a, **k)
        sink.append(out.detach() > 0)
        return out

    with mock.patch.object(binarize, "heaviside01", rec), \
            mock.patch.object(block_tt, "heaviside01", rec), \
            mock.patch.object(ttnet_imagenet, "heaviside01", rec):
        yield


def one_train_step(model, x, y, sink: list) -> float:
    """One plain f32 step (SGD, lr 0.1) of ``model`` in place, recording
    its Heaviside outputs into ``sink``; returns the loss."""
    from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    opt, _ = make_optimizer(0.1)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    with heaviside_outputs(sink):
        _, metrics = step(ts, x, y)
    return float(metrics["loss"])


def step_parity(model, B: int, seed: int) -> dict:
    """12(a): one f32 step of the seeded flagship without augmentation on
    the card, with the fused switch on (training must not take the eval
    kernel), and on the CPU (the plain path), from the same weights and
    batch: the relative loss gap, the cosine between the two parameter
    updates and the share of Heaviside outputs that flipped."""
    from scale_imagenet_tpu_torch.kernels import fused_block as FB

    gen = torch.Generator().manual_seed(seed + 5)
    x = torch.randn((B, 224, 224, 3), generator=gen)
    y = torch.randint(0, 1000, (B,), generator=gen)
    cpu_model = copy.deepcopy(model).cpu()
    start = [p.detach().cpu().clone() for p in model.parameters()]
    card_bits, cpu_bits = [], []
    FB.reset_launches()
    with fused_blocks(True):
        card_loss = one_train_step(model, x.cuda(), y.cuda(), card_bits)
    torch.cuda.synchronize()
    fused_launches = FB.fused_pointwise_block.launches
    card_bits = [b.cpu() for b in card_bits]
    t = time.perf_counter()
    cpu_loss = one_train_step(cpu_model, x, y, cpu_bits)
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
    return {"batch": B, "card_loss": card_loss, "cpu_loss": cpu_loss,
            "rel_loss_gap": abs(card_loss - cpu_loss) / abs(cpu_loss),
            "update_cosine": float(du @ dv / (du.norm() * dv.norm())),
            "heaviside_outputs": outputs, "heaviside_flipped": flips,
            "flip_share": flips / outputs, "heavisides": len(card_bits),
            "fused_launches_in_training": fused_launches, "cpu_step_s": cpu_s}


class StepTimer:
    """Wraps a train step: keeps every step's loss (a device scalar, read
    after the run), and times steps 2..``steps`` from a synchronised start
    to a synchronised end, with the card's kernels profiled over the same
    window (device idle share)."""

    def __init__(self, steps: int):
        self.steps, self.calls, self.losses = steps, 0, []
        self.prof = None
        self.t0 = self.t1 = None
        self.busy_s = None

    def wrap(self, step):
        from torch.profiler import ProfilerActivity, profile

        def timed(ts, images, labels, generator=None):
            i = self.calls
            self.calls += 1
            if i == 1:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            ts, metrics = step(ts, images, labels, generator)
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
    """12(a)-(d): the step against the CPU, an overfit check on one batch,
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
    parity = step_parity(copy.deepcopy(model), B, args.seed)
    emit("train_step_parity", **parity)
    check(parity["rel_loss_gap"] <= TRAIN_LOSS_GAP,
          f"card/CPU loss gap {parity['rel_loss_gap']} > {TRAIN_LOSS_GAP}")
    check(parity["update_cosine"] >= TRAIN_UPDATE_COSINE,
          f"card/CPU update cosine {parity['update_cosine']} < "
          f"{TRAIN_UPDATE_COSINE}")
    check(parity["flip_share"] <= TRAIN_FLIP_SHARE,
          f"card/CPU Heaviside flip share {parity['flip_share']} > "
          f"{TRAIN_FLIP_SHARE}")
    check(parity["fused_launches_in_training"] == 0,
          "a training forward launched the eval-only fused kernel")

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
    shutil.rmtree(work)
    shutil.rmtree(Path("build") / "chip_smoke_eval")
    return {"parity": parity, "overfit": losses, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out_dir", type=Path, default=Path("build/chip_smoke"),
                    help="where the profile tables, the per-launch kernel "
                         "cases and the ptxas logs go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with torch.no_grad():
        return run(args)


def run(args) -> int:
    from scale_imagenet_tpu_torch.compile import lut_eval
    from scale_imagenet_tpu_torch.compile.lut_eval import compile_ttnet_lut, \
        lut_multihead_apply, lut_ttnet_apply, _bits
    from scale_imagenet_tpu_torch.kernels import build
    from scale_imagenet_tpu_torch.kernels import lut_gather as K
    from scale_imagenet_tpu_torch import main as cli
    from scale_imagenet_tpu_torch.models import get_model
    from scale_imagenet_tpu_torch.models.ttnet_imagenet import _nchw, stem, \
        ttnet_imagenet_apply

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

    # ------------------------------------------------------------ serve
    ready, stop = threading.Event(), threading.Event()
    K.reset_launches()
    server_err = []

    def run_server():
        try:
            cli.main(["--mode", "serve", "--lut", "--serve_batch", "8",
                      "--port", "0", "--seed", str(args.seed)],
                     serve_ready=ready, serve_stop=stop)
        except BaseException as e:        # reported by the main thread
            server_err.append(e)
            ready.set()

    th = threading.Thread(target=run_server, daemon=True)
    th.start()
    check(ready.wait(600) and not server_err, f"server failed: {server_err}")
    url = f"http://127.0.0.1:{ready.port}"
    imgs = torch.rand((16, 224, 224, 3), generator=gen)

    def post(i):
        req = urllib.request.Request(
            url + "/predict", data=imgs[i].numpy().tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(16) as pool:
        answers = list(pool.map(post, range(16)))
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    stop.set()
    th.join(60)
    check(not th.is_alive() and not server_err, f"server stop: {server_err}")
    serve_launches = {"lut_window_bits": K.lut_window_bits.launches,
                      "lut_window_float": K.lut_window_float.launches}
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

    # ---------------------------------------------------- fused kernels
    fused_rows = fused_kernels_phase(model, x, out_dir)
    torch.cuda.synchronize()

    # ------------------------------------------------------------- eval
    evals = eval_phase(args, model, out_dir)

    # ------------------------------------------------------------ gates
    gates = gates_phase(args, md, model, luts, x, out_dir)
    torch.cuda.synchronize()

    # ------------------------------------------------------------ train
    with torch.enable_grad():
        train_phase(args, model, out_dir)

    # ------------------------------------------------------------- perf
    def wall_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

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

    def entry(kind, replaces, launches):
        rows = cases[kind]
        return {"name": f"lut_window_{kind}", "route": "cuda",
                "source": "scale_imagenet_tpu_torch/csrc/lut_gather.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows) else "operations",
                "library_ms": sum(r["library_ms"] for r in rows),
                "chain_ms": sum(r["chain_ms"] for r in rows)}

    kernels = [
        entry("bits", "scale_imagenet_tpu/pallas/lut_gather.py:84",
              serve_launches["lut_window_bits"]),
        entry("float", "scale_imagenet_tpu/pallas/lut_gather.py:107",
              table_exact_launches["lut_window_float"]),
        {"name": "fused_pointwise_block", "route": "cuda",
         "source": "scale_imagenet_tpu_torch/csrc/fused_block.cu",
         "replaces": "scale_imagenet_tpu/pallas/fused_block.py:41, "
                     "scale_imagenet_tpu/pallas/fused_block.py:191",
         "launches": evals["conv_fused"]["launches"][
             "fused_pointwise_block"],
         "max_abs_err": max(r["max_abs_err_float32"] for r in fused_rows),
         "ms": sum(r["ms"] for r in fused_rows),
         "plain_ms": sum(r["plain_ms"] for r in fused_rows),
         "bound_ms": sum(r["bound_ms"] for r in fused_rows),
         "bound_by": "operations" if all(r["bound_by"] == "operations"
                                         for r in fused_rows) else "bytes",
         "library_ms": None,
         "chain_ms": sum(r["chain_ms"] for r in fused_rows)},
        {"name": "gate_cubes", "route": "cuda",
         "source": "scale_imagenet_tpu_torch/csrc/gate_cubes.cu",
         "replaces": "scale_imagenet_tpu/compile/gate_device.py:195 (XLA "
                     "ops; no Pallas kernel)",
         "launches": gates["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in gates["cases"]),
         "ms": sum(r["ms"] for r in gates["dnf_cases"]),
         "plain_ms": sum(r["plain_ms"] for r in gates["dnf_cases"]),
         "bound_ms": sum(r["bound_ms"] for r in gates["dnf_cases"]),
         "bound_by": "operations" if all(
             r["bound_by"] == "operations" for r in gates["dnf_cases"])
         else "bytes",
         "library_ms": None},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
