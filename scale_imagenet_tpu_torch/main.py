"""Command-line entry (counterpart of ``scale_imagenet_tpu/main.py``): the
``--mode eval [--lut]`` and ``--mode serve [--lut]`` subsets.

    python -m scale_imagenet_tpu_torch.main --mode eval --shards_dir D \\
        [--lut [--lut_path F]] --eval_batch_size 256
    python -m scale_imagenet_tpu_torch.main --mode serve --lut --port 8000

``--mode eval`` scores the model on pre-decoded uint8 shards
(``--shards_dir``, normalized on the device) or on an ImageFolder
(``--data_dir``/val, decoded on host threads), padding the last batch and
masking its pad rows, and prints ``final: top1 … top5 … loss …`` as the
JAX CLI does.  ``--lut`` evaluates the compiled truth tables instead of the
conv forward; ``--lut_path`` loads them from an archive, or writes it after
compiling.  ``--write_shards`` decodes ``--data_dir``/val into shards and
exits.  ``--mode serve`` serves the model over HTTP
(``runtime/server.py``).  Weights come from ``--seed`` or from a reference
``.pth`` (``--ckpt``, loaded strict).  ``config.performance`` is not a
flag, as in the JAX package.

Every other mode and flag of the JAX CLI arrives with a later slice and
raises here naming ``ROADMAP.md``; the training flags that the JAX CLI
refuses in eval raise with its messages.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from .compile.lut_eval import compile_ttnet_lut, lut_ttnet_apply
from .compile.lut_store import load_luts, save_luts
from .data import DataLoader, ImageFolder, IMAGENET_MEAN, IMAGENET_STD, \
    device_prefetch, imagenet_eval_crop_u8, imagenet_eval_transform, \
    pad_batches, shard_loader, write_shards
from .device import resolve_device
from .models import get_model
from .models.ttnet_imagenet import ttnet_imagenet_apply
from .runtime.evaluate import evaluate
from .runtime.server import serve
from .train import MetricsLogger, make_eval_step

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


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TTnet PyTorch/CUDA harness")
    p.add_argument("--mode", default="eval",
                   help="eval or serve (the other JAX modes: see "
                        "ROADMAP.md)")
    p.add_argument("--model", type=str, default="ttnet_imagenet_small")
    p.add_argument("--nfilter", type=int, default=8)
    p.add_argument("--tfilter", type=int, default=8)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--lut", action="store_true",
                   help="evaluate / serve the compiled truth tables instead "
                        "of the conv forward")
    p.add_argument("--lut_path", type=str, default=None,
                   help="LUT archive (.npz): loaded if present, else "
                        "written after compilation")
    p.add_argument("--root_dir", type=str, default="./",
                   help="eval logs go to <root_dir>/logs/<log_name>/<date>")
    p.add_argument("--log_name", type=str, default="ttnet_imagenet_small")
    p.add_argument("--data_dir", type=str, default=None,
                   help="ImageFolder root; eval reads <data_dir>/val")
    p.add_argument("--shards_dir", type=str, default=None,
                   help="eval from a pre-decoded uint8 shard dir "
                        "(data/shards.py); normalization runs on the "
                        "device")
    p.add_argument("--write_shards", type=str, default=None,
                   help="decode <data_dir>/<shards_split> once into this "
                        "shard dir, then exit")
    p.add_argument("--shards_split", type=str, default="val")
    p.add_argument("--shard_size", type=int, default=2048,
                   help="images per shard file for --write_shards")
    p.add_argument("--eval_batch_size", type=int, default=100)
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
                   help="reference-layout .pth state dict, loaded strict")
    args, unknown = p.parse_known_args(argv)
    if args.mode not in ("eval", "serve"):
        raise ValueError(f"--mode {args.mode} is not ported yet (the port "
                         "has --mode eval and serve; see ROADMAP.md)")
    if args.mode == "eval":
        for flag in unknown:
            refusal = _EVAL_REFUSALS.get(flag.split("=")[0])
            if refusal:
                raise ValueError(refusal)
    if unknown:
        raise ValueError(f"not ported yet: {' '.join(unknown)} (the port "
                         "has the --mode eval/serve subset; see "
                         "ROADMAP.md)")
    if args.shards_split != "val":
        raise ValueError(f"--shards_split {args.shards_split}: the train "
                         "crop comes with training (see ROADMAP.md)")
    if args.lut_path and not args.lut:
        raise ValueError("--lut_path is the archive of --lut; add --lut")
    if args.write_shards and not args.data_dir:
        raise ValueError("--write_shards decodes --data_dir/<shards_split>; "
                         "give --data_dir")
    if args.mode == "eval" and not (args.shards_dir or args.data_dir):
        raise ValueError("--mode eval reads --shards_dir or --data_dir; "
                         "give one")
    return args


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """A reference-layout ``.pth`` (a state dict, or one under
    ``model_state_dict`` as the JAX exporter writes it), loaded strict."""
    if not path.endswith(".pth"):
        raise ValueError(f"--ckpt {path}: the port loads .pth state dicts; "
                         "other checkpoint formats: see ROADMAP.md")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model_state_dict", sd)
    model.load_state_dict(sd, strict=True)


def load_or_compile_luts(model, lut_path: str | None = None):
    """The model's truth tables: loaded from ``lut_path`` when it exists,
    else compiled (2^n patterns a head) and written there if given."""
    if lut_path and not lut_path.endswith(".npz"):
        lut_path += ".npz"
    if lut_path and os.path.exists(lut_path):
        print(f"loading LUTs from {lut_path}")
        return load_luts(lut_path, model)
    print("compiling truth tables (2^n patterns per head)...")
    luts = compile_ttnet_lut(model)
    if lut_path:
        save_luts(lut_path, luts, model)
        print(f"saved LUTs -> {lut_path}")
    return luts


def _eval(cfg, apply, device, image_size: int):
    bs = cfg.eval_batch_size
    normalize = None
    if cfg.shards_dir:
        loader = shard_loader(cfg.shards_dir, bs)
        normalize = (IMAGENET_MEAN, IMAGENET_STD)
        print(f"eval shards: {len(loader.dataset)} images")
    else:
        if image_size != 224:
            raise ValueError("the port's ImageFolder eval is the 256 -> 224 "
                             "ImageNet pipeline; other resolutions: see "
                             "ROADMAP.md")
        ds = ImageFolder(os.path.join(cfg.data_dir, "val"),
                         imagenet_eval_transform)
        print(f"eval dataset: {len(ds)} images / {len(ds.classes)} "
              "classes")
        loader = DataLoader(ds, bs, num_workers=cfg.num_workers)
    date = str(datetime.now()).replace(" ", "_").replace("-", "_") \
        .replace(":", "_").replace(".", "_")
    logger = MetricsLogger(os.path.join(cfg.root_dir, "logs", cfg.log_name,
                                        date))
    feed = device_prefetch(pad_batches(iter(loader), bs), device)
    try:
        top1, top5, loss = evaluate(make_eval_step(apply, normalize), feed,
                                    logger=logger,
                                    log_interval=cfg.log_interval)
    finally:
        feed.close()
        logger.close()
    print(f"final: top1 {top1:.3f}% top5 {top5:.3f}% loss {loss:.4f}")
    return top1, top5, loss


def main(argv=None, *, serve_ready=None, serve_stop=None):
    """CLI entry.  ``--mode eval`` returns ``(top1, top5, loss)``.
    ``serve_ready``/``serve_stop``: optional events for callers that run
    the server in a thread."""
    cfg = parse_args(argv)
    if cfg.write_shards:
        src = ImageFolder(os.path.join(cfg.data_dir, cfg.shards_split),
                          imagenet_eval_crop_u8)
        meta = write_shards(src, cfg.write_shards, shard_size=cfg.shard_size,
                            num_workers=cfg.num_workers)
        print(f"wrote {meta['n']} images -> {cfg.write_shards}")
        return meta
    device = resolve_device(cfg.device)
    md = get_model(cfg.model, nfilter=cfg.nfilter, tfilter=cfg.tfilter,
                   layers=cfg.layers)
    model = md.init(seed=cfg.seed, device=device)
    if cfg.ckpt:
        load_checkpoint(model, cfg.ckpt)
    name = md.name
    if cfg.lut:
        luts = load_or_compile_luts(model, cfg.lut_path)
        name += "+lut"

        def apply(x):
            return lut_ttnet_apply(luts, model, x)
    else:
        def apply(x):
            return ttnet_imagenet_apply(model, x)
    size = md.config.image_size
    if cfg.mode == "eval":
        return _eval(cfg, apply, device, size)
    return serve(apply, name, (size, size, 3), device=device,
                 host=cfg.serve_host, port=cfg.port,
                 batch_size=cfg.serve_batch, max_wait_ms=cfg.serve_wait_ms,
                 ready_event=serve_ready, stop_event=serve_stop)


if __name__ == "__main__":
    main()
