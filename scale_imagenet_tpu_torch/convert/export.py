"""``--mode export``: the model's weights as a reference-compatible ``.pth``
(counterpart of ``scale_imagenet_tpu/convert/torch_export.py:153-178``).

The port's module tree is the reference's, so its state dict already has
the reference layout (``convert/from_jax.py``): export writes it as it is,
``torch.save({"model_state_dict": sd})`` of CPU tensors, which is what the
JAX exporter writes for the same weights, key for key.  The family rule is
the JAX package's: the ttnet_imagenet family (the VGG-stem variant is not
of it) and ``TTFHEConfig`` (``export_tt_fhe``; not the vAlexnet model).
"""

from __future__ import annotations

import torch

from ..models.tt_fhe import TTFHEConfig
from ..models.ttnet_imagenet import TTnetImageNetConfig


def save_torch_checkpoint(path: str, model) -> str:
    """Write ``model``'s weights to ``path`` as contiguous CPU tensors under
    ``model_state_dict``, as the reference README's checkpoints and the JAX
    exporter store them (``torch_export.py:153-178``: the family rule and
    its refusal)."""
    if not isinstance(model.cfg, (TTnetImageNetConfig, TTFHEConfig)):
        raise ValueError(
            "torch export supports the ttnet_imagenet and TT_FHE families "
            "(the released-checkpoint and deployment families), not "
            f"{type(model.cfg).__name__}")
    sd = {k: v.detach().cpu().contiguous()
          for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": sd}, path)
    return path
