"""One run of one cell: set-up, the measured window, the traced stretch,
then the comparison with the plain reference.

The window drives the program as its entry point does:

* eval: ``runtime/evaluate.py::evaluate`` over ``train/steps.py::
  make_eval_step`` of the family's forward (conv, or the compiled tables
  through ``lut_ttnet_apply``), fed by ``data/shards.py::shard_loader`` ->
  ``data/loader.py::pad_batches`` -> ``device_prefetch`` (``main.py::
  _score``'s path), the shard loader looped epoch after epoch;
* train: ``make_train_step`` (SGD, momentum, weight decay; on-device
  augmentation from pre-crops) over the shuffled ``drop_last`` shard
  loader, one ``device_prefetch`` an epoch, the step's generator seeded
  and the loss read at log points as ``main.py::_train`` does; no
  validation or checkpoint.

Whole batches run until ``seconds`` have passed, then the card is
synchronised; the window runs from the first timed batch's start to that
synchronisation.  The benchmark's own span around each ``next()`` of the
feed it hands the loop gives the host's wait for data.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import itertools
import os
import tempfile
import time

import numpy as np
import torch

from . import inputs, manifest, roofline, weights
from .correct import eval_numbers, train_numbers
from .trace import Stretch


def _entry(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed at ``step``, as ``main.py``
    seeds it in one process."""
    return ((seed << 32) + step) % 2 ** 64


@dataclasses.dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0               # batches or train steps in the window
    batch: int = 0
    feed_wait_s: list = dataclasses.field(default_factory=list)
    stretch: Stretch | None = None
    stretch_steps: int = 0
    peak_bytes: int = 0
    flops_per_image: int = 0
    window_launches: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    numbers: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)   # set-up, s

    def phase(self, name: str, t: float) -> float:
        """Note the set-up phase that began at ``t``; returns now."""
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    @property
    def mode(self) -> str:
        return self.cell.traffic["mode"]

    @property
    def images(self) -> int:
        return self.steps * self.batch


class Feed:
    """The iterator the loop gets: counts batches, times each ``next()``,
    ends at the deadline (checked between batches) and starts and stops
    the traced stretch between batches."""

    def __init__(self, run: Run):
        self.run = run
        self.index = -1          # the batch the loop holds (global count)
        self.deadline = None
        self.t0 = None
        self.plan = None         # (start after s, length s) of the stretch
        self.stretch_from = None

    def arm(self, seconds: float) -> None:
        self.t0 = None
        self.deadline = seconds
        self.run.steps = 0
        if self.run.trace:
            self.plan = (seconds / 3, max(1.0, seconds / 5))

    def __call__(self, it):
        run = self.run
        while True:
            now = time.perf_counter()
            if self.deadline is not None and self.t0 is not None:
                st = run.stretch
                if self.plan and st is None and \
                        now - self.t0 >= self.plan[0]:
                    run.stretch = Stretch()
                    run.stretch.start()
                    self.stretch_from = run.steps
                elif st is not None and st.prof is not None and \
                        now - st.t0 >= self.plan[1]:
                    st.stop()
                    run.stretch_steps = run.steps - self.stretch_from
                if now - self.t0 >= self.deadline:
                    return
            t = time.perf_counter()
            if self.t0 is None and self.deadline is not None:
                self.t0 = t
            traced = run.stretch is not None and run.stretch.prof is not None
            try:
                # named in the trace, so an idle gap spent here says so
                with torch.profiler.record_function("feed_wait") if traced \
                        else contextlib.nullcontext():
                    item = next(it)
            except StopIteration:
                return
            if self.deadline is not None:
                run.feed_wait_s.append(time.perf_counter() - t)
                run.steps += 1
            self.index += 1
            yield item


def _endless(loader):
    for epoch in itertools.count():
        loader.set_epoch(epoch)
        yield from loader


def _program_model(cfg: dict, state: dict, device):
    from scale_imagenet_tpu_torch.device import exact_float32
    from scale_imagenet_tpu_torch.models.registry import get_model

    prog = cfg["program"]
    md = get_model(prog["registry"], **prog.get("flags", {}))
    with torch.device("meta"):
        model = _entry(prog["module"])(md.config)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    exact_float32()
    return model.eval()


def _weights(cfg: dict, seed: int, device) -> dict:
    """The seed's weights, made on the device, as a state dict on the
    host: the program is given them at set-up, the reference after the
    window."""
    ref = manifest.reference(cfg["reference"]).build(cfg["model"])
    ref = weights.fill(ref.to_empty(device=device), seed,
                       cfg["model"]["image_size"])
    return {n: t.detach().cpu() for n, t in ref.state_dict().items()}


def _reference(cfg: dict, state: dict, device):
    ref = manifest.reference(cfg["reference"]).build(cfg["model"])
    ref = ref.to_empty(device=device)
    ref.load_state_dict(state, strict=True)
    return ref.eval()


def _tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, tf32_control: bool = False) -> Run:
    """Set-up, window and comparison of one run.  ``t_start``: the
    process's start on ``time.perf_counter``'s clock.  ``tf32_control``
    compares the reference computed with TF32 on in the program's place
    (the control of the comparison) instead of the program."""
    device = torch.device(device)
    run = Run(cell, seed, seconds, trace, device)
    run.batch = cell.traffic["batch"]
    if device.type == "cuda":
        torch.zeros(1, device=device)        # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as tmp:
        if run.mode == "eval":
            _eval(run, tmp, t_start, tf32_control)
        else:
            _train(run, tmp, t_start, tf32_control)
    return run


# ------------------------------------------------------------------ eval

def _eval(run: Run, tmp: str, t_start: float, control: bool) -> None:
    from scale_imagenet_tpu_torch import config as prog_config
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.data.loader import device_prefetch, \
        pad_batches
    from scale_imagenet_tpu_torch.data.shards import shard_loader
    from scale_imagenet_tpu_torch.runtime.evaluate import evaluate
    from scale_imagenet_tpu_torch.train.steps import make_eval_step

    cfg, tr, dev, B = run.cell.config, run.cell.traffic, run.device, run.batch
    mcfg = cfg["model"]
    launched = _launches()
    t = time.perf_counter()
    state = _weights(cfg, run.seed, dev)
    t = run.phase("weights", t)
    model = _program_model(cfg, state, dev)
    t = run.phase("model", t)
    shards = os.path.join(tmp, "shards")
    inputs.write_shards(shards, tr["images"], mcfg["image_size"],
                        mcfg["num_classes"], tr["shard_size"], run.seed, dev)
    t = run.phase("shards", t)
    prog_config.performance.fused_pointwise_blocks = tr["fused"]
    if tr["path"] == "lut":
        from scale_imagenet_tpu_torch.main import load_or_compile_luts
        luts = load_or_compile_luts(model)
        t = run.phase("tables", t)
        apply = functools.partial(_entry(cfg["program"]["lut"]), luts, model)
        run.window_launches = roofline.window_launches(
            manifest.reference(cfg["reference"]).build(mcfg), B,
            mcfg["image_size"])
    else:
        apply = functools.partial(_entry(cfg["program"]["conv"]), model)
    run.flops_per_image = cfg["flops_per_image"]

    nb = -(-tr["images"] // B)
    # the compared batches: the first of a permutation drawn from the seed
    # that the window ran; each batch index keeps its latest logits
    order = [int(i) for i in np.random.default_rng(run.seed).permutation(nb)]
    kept: dict = {}
    feed = Feed(run)

    def kept_apply(x, **kw):
        logits = apply(x, **kw)
        if feed.deadline is not None:
            kept[feed.index % nb] = logits
        return logits

    step = make_eval_step(kept_apply, (IMAGENET_MEAN, IMAGENET_STD))
    host = pad_batches(_endless(shard_loader(shards, B)), B)
    prefetch = device_prefetch(host, dev)
    it = feed(prefetch)
    try:
        evaluate(step, itertools.islice(it, tr["warmup_batches"]),
                 log_interval=tr["log_interval"], verbose=False)
        sync(dev)
        t = run.phase("warmup", t)
        if run.trace:
            Stretch().warm()
        sync(dev)
        run.setup_s = time.perf_counter() - t_start
        feed.arm(run.seconds)
        evaluate(step, it, log_interval=tr["log_interval"], verbose=False)
        sync(dev)
        run.window_s = time.perf_counter() - feed.t0
    finally:
        it.close()
        prefetch.close()
        host.close()
    if run.stretch is not None and run.stretch.prof is not None:
        run.stretch.stop()
        run.stretch_steps = run.steps - feed.stretch_from
    _check_path(run, launched)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    sampled = [i for i in order if i in kept][:tr["compared_batches"]]
    got = {i: kept[i].float().cpu() for i in sampled}
    del kept, apply, step, model, prefetch, host, it
    if tr["path"] == "lut":
        del luts
    _free(dev)
    # the reference, from the same weights and shard files
    ref = _reference(cfg, state, dev)
    mean = torch.tensor(np.asarray(IMAGENET_MEAN), device=dev)
    std = torch.tensor(np.asarray(IMAGENET_STD), device=dev)
    want: dict = {}
    controls: dict = {}
    with torch.no_grad():
        for i in sampled:
            # a short last batch is padded with its last image, as the feed
            # pads it
            rows = np.minimum(np.arange(i * B, (i + 1) * B),
                              tr["images"] - 1)
            imgs, _ = inputs.rows(shards, rows, tr["shard_size"])
            x = ((torch.from_numpy(imgs).to(dev).float() / 255.0 - mean)
                 / std).permute(0, 3, 1, 2)
            _tf32(False)
            want[i] = ref(x).float().cpu()
            if control:
                _tf32(True)
                controls[i] = ref(x).float().cpu()
                _tf32(False)
    run.numbers = eval_numbers(controls if control else got, want)
    del ref
    _free(dev)


def _launches() -> dict:
    """The program's launch counters of its hand-written kernels."""
    from scale_imagenet_tpu_torch.kernels import fused_block, lut_gather

    return {"lut_window_bits": lut_gather.lut_window_bits.launches,
            "fused_pointwise_block":
                fused_block.fused_pointwise_block.launches}


def _check_path(run: Run, before: dict) -> None:
    """The launches since ``before`` show the path the cell names: the
    window kernels in a table cell and in no other, the fused kernel only
    where the traffic turns it on.  On the CPU the plain versions run and
    nothing is counted."""
    after = _launches()
    run.launches = {k: after[k] - before[k] for k in after}
    if run.device.type != "cuda":
        return
    tr = run.cell.traffic
    want = {"lut_window_bits": tr["path"] == "lut",
            "fused_pointwise_block": bool(tr.get("fused"))}
    got = {k: v > 0 for k, v in run.launches.items()}
    if got != want:
        raise RuntimeError(f"the {tr['path']} path launched {run.launches}")


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- train

class _Trainer:
    """``main.py::_train``'s inner loop over a ``TrainState``: a fresh
    ``device_prefetch`` each epoch, the step's generator seeded by the
    step, the loss and top-1 read at log points."""

    def __init__(self, run, loader, train_step, ts, feed, log_interval):
        self.run, self.loader, self.step_fn = run, loader, train_step
        self.ts, self.feed, self.log = ts, feed, log_interval
        self.generator = torch.Generator(run.device)
        self.epoch = 0
        self.i = 0
        self.prefetch = self.host = self.it = None
        self.metrics = []

    def steps(self, n: int | None = None):
        """Run ``n`` steps, or until the feed ends (the deadline)."""
        from scale_imagenet_tpu_torch.data.loader import device_prefetch

        done = 0
        while n is None or done < n:
            if self.it is None:
                self.loader.set_epoch(self.epoch)
                self.host = iter(self.loader)
                self.prefetch = device_prefetch(self.host, self.run.device)
                self.it = self.feed(self.prefetch)
                self.i = 0
            try:
                images, labels = next(self.it)
            except StopIteration:
                if self.feed.deadline is not None and \
                        self.feed.t0 is not None and \
                        time.perf_counter() - self.feed.t0 >= \
                        self.feed.deadline:
                    return
                self.close()
                self.epoch += 1
                continue
            self.generator.manual_seed(step_seed(self.run.seed,
                                                 self.ts.step))
            self.ts, m = self.step_fn(self.ts, images, labels,
                                      self.generator, None)
            self.metrics.append(m["loss"])
            if self.i % self.log == 0:
                float(m["loss"])
                float(m["top1"])
            self.i += 1
            done += 1

    def close(self):
        if self.it is not None:
            self.it.close()
            self.prefetch.close()
            self.host.close()
        self.it = self.prefetch = self.host = None


def _train(run: Run, tmp: str, t_start: float, control: bool) -> None:
    from scale_imagenet_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from scale_imagenet_tpu_torch.data.shards import shard_loader
    from scale_imagenet_tpu_torch.train import make_optimizer
    from scale_imagenet_tpu_torch.train.steps import TrainState, \
        make_train_step

    cfg, tr, dev, B = run.cell.config, run.cell.traffic, run.device, run.batch
    mcfg = cfg["model"]
    launched = _launches()
    t = time.perf_counter()
    p0 = _weights(cfg, run.seed, dev)
    t = run.phase("weights", t)
    model = _program_model(cfg, p0, dev)
    t = run.phase("model", t)
    shards = os.path.join(tmp, "shards")
    inputs.write_shards(shards, tr["images"], tr["image_size"],
                        mcfg["num_classes"], tr["shard_size"], run.seed, dev)
    t = run.phase("shards", t)
    run.flops_per_image = cfg["flops_per_image"]
    loader = shard_loader(shards, B, drop_last=True, shuffle=True,
                          seed=run.seed)
    opt, _ = make_optimizer(tr["lr"], momentum=tr["momentum"],
                            weight_decay=tr["wd"],
                            milestones=tuple(tr["milestones"]),
                            steps_per_epoch=len(loader),
                            max_epochs=tr["max_epochs"])
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    train_step = make_train_step(
        model, opt, normalize=(IMAGENET_MEAN, IMAGENET_STD),
        augment=tr["augment"])
    feed = Feed(run)
    trainer = _Trainer(run, loader, train_step, ts, feed,
                       tr["log_interval"])
    checked = tr["checked_steps"]
    got: dict = {}
    try:
        trainer.steps(1)
        got["momentum"] = {n: m.detach().cpu().clone() for n, m in
                           trainer.ts.opt_state["momentum"].items()}
        trainer.steps(checked - 1)
        got["params"] = {n: p.detach().cpu().clone()
                         for n, p in model.named_parameters()}
        got["bn"] = {n: b.detach().cpu().clone()
                     for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}
        got["loss"] = [float(v) for v in trainer.metrics[:checked]]
        t = run.phase("checked_steps", t)
        trainer.steps(tr["warmup_steps"])
        sync(dev)
        t = run.phase("warmup", t)
        if run.trace:
            Stretch().warm()
        sync(dev)
        run.setup_s = time.perf_counter() - t_start
        feed.arm(run.seconds)
        trainer.steps()
        sync(dev)
        run.window_s = time.perf_counter() - feed.t0
    finally:
        trainer.close()
    if run.stretch is not None and run.stretch.prof is not None:
        run.stretch.stop()
        run.stretch_steps = run.steps - feed.stretch_from
    _check_path(run, launched)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    del trainer, ts, model, train_step, opt, loader
    _free(dev)
    want = _reference_steps(run, shards, checked, p0, tf32=False)
    if control:
        got = _reference_steps(run, shards, checked, p0, tf32=True)
    run.numbers = train_numbers(got, want, p0)


def _reference_steps(run: Run, shards: str, checked: int, state: dict,
                     tf32: bool) -> dict:
    cfg, tr, dev, B = run.cell.config, run.cell.traffic, run.device, run.batch
    aug = manifest.reference("augment")
    steps = manifest.reference("train_step")
    order = inputs.train_order(tr["images"], tr["shard_size"], B, run.seed,
                               epoch=0)
    g = torch.Generator(dev)

    def batches():
        for s in range(checked):
            imgs, labels = inputs.rows(shards, order[s], tr["shard_size"])
            g.manual_seed(step_seed(run.seed, s))
            x = aug.augment(torch.from_numpy(imgs).to(dev), g,
                            cfg["model"]["image_size"])
            yield x.permute(0, 3, 1, 2), torch.from_numpy(labels).to(dev)

    _tf32(tf32)
    try:
        ref = _reference(cfg, state, dev)
        out = steps.run(ref, batches(), tr["lr"], tr["momentum"], tr["wd"])
    finally:
        _tf32(False)
    res = {"loss": [float(v) for v in out["loss"]],
           "grad_norm": {n: float(v) for n, v in out["grad_norm"].items()}}
    for k in ("momentum", "params", "bn"):
        res[k] = {n: t.cpu() for n, t in out[k].items()}
    del ref, out
    _free(dev)
    return res
