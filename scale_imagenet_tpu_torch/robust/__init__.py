"""Certified robustness (counterpart of ``scale_imagenet_tpu/robust/``).

* ``Interval``: interval-arithmetic abstract interpretation (the
  reference's ``AbstractTensor``, netbin.py:84-129) through the layer
  transformers of ``interval.py``, to the logits of the three models
  whose registry entries carry ``interval_logits``;
* the multi-sample perturbation forward (``MultiSampleTensor``,
  netbin.py:131-181, and ``forward_with_multi_sample``, netbin.py:710-724);
* the activation-stability losses accumulated at each Heaviside;
* ``bias_regularizer_loss``, "cardinality bound decay" (``BiasRegularizer``,
  netbin.py:786-864), over the ``(scale, bias)`` pairs of ``stats_bn``;
* ``attack.py``: FGSM and PGD, the empirical side of the certificate.
"""

from .interval import (
    Interval,
    interval_from_eps_ball,
    interval_linear,
    interval_mono,
    interval_conv2d,
    interval_bin_linear_pos,
    interval_batch_norm,
    interval_heaviside,
    interval_flatten,
)
from .multisample import (
    multi_sample_pack,
    multi_sample_heaviside,
    multi_sample_unpack_natural,
)
from .regularizer import bias_regularizer_loss, \
    bn_internals_collector, fanin_nonzero
from .collect import multi_sample_forward, stability_loss_collector

__all__ = [
    "Interval", "interval_from_eps_ball", "interval_linear",
    "interval_mono", "interval_conv2d", "interval_bin_linear_pos",
    "interval_batch_norm", "interval_heaviside", "interval_flatten",
    "multi_sample_pack", "multi_sample_heaviside",
    "multi_sample_unpack_natural",
    "bias_regularizer_loss",
    "bn_internals_collector",
    "fanin_nonzero",
    "multi_sample_forward", "stability_loss_collector",
]
