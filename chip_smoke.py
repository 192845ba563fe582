"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0] [--batch 256] [--out_dir build/chip_smoke]

Drives the port's main paths on the flagship TTnet-Small (p = 64,
--layers 1, 224x224): served as its compiled truth tables over HTTP, and
evaluated from uint8 shards (``--mode eval``, conv and ``--lut``, with the
fused pointwise kernel on), and holds every CUDA kernel against its plain
PyTorch version.  Phases, each printing one line of its numbers:

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
7. perf:   B=1 latency and B=256 throughput, conv and LUT (each with the
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
# the data sheet gives no int32 rate; its non-tensor float32 rate is an
# upper bound on the shift/mask/index ops, so the op time stays a least time
OPS_PER_S = 67e12
# f32 operations of one GELU in csrc/fused_block.cu (an FMA counts 2): the
# scale by 1/sqrt2, min, a*a, one FMA for t, 16 Horner FMAs, a*acc, 1+e,
# 0.5*v and the product.  |.| (an operand modifier) and copysign (an
# integer op) take no f32 instruction and are not counted
GELU_OPS = 41
EVAL_IMAGES = 5000
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
    """Device time of ``iters`` forwards by kernel (``torch.profiler``):
    busy share of the window, device kernels a forward and the kernels that
    take the most time.
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
    shutil.rmtree(work)
    return results


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
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
