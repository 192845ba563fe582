"""Numerics and performance switches (counterpart of
``scale_imagenet_tpu/config.py:14-100``).

One process-wide ``numerics`` and one ``performance`` object, as in the JAX
package.  The port has the fields of the paths it carries so far; the other
numerics fields, ``fast_gelu`` and ``merge_heads12`` come with the paths
that read them (``ROADMAP.md``).  ``use_scalar_scale_last_layer`` and
``remove_last_bn`` are fields of ``ModelGeneralConfig`` here, as the JAX
package's models read them.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class NumericsConfig:
    # scale of the tanh' straight-through surrogate of the Heaviside
    # backward; ``None`` selects the hardtanh mask surrogate instead
    # (the reference's ``g_bingrad_soft_tanh_scale``)
    bingrad_soft_tanh_scale: float | None = 1.0
    # weight decay added to the gradient of the {0,1} and ternary weight
    # binarizers (the reference's ``g_weight_decay``)
    weight_decay: float = 1e-7
    # std of the initial learned ``weight_mask`` (``g_weight_mask_std``)
    weight_mask_std: float = 0.01


numerics = NumericsConfig()


@dataclasses.dataclass
class PerformanceConfig:
    # Run every eval-mode k=1 stride-1 Block_TT (head 3 and the fuse head
    # of each multi-head block) as the fused pointwise kernel
    # (kernels/fused_block.py): one launch instead of conv -> BN -> GELU
    # -> conv -> BN -> act, with the polynomial erf in its GELU.  Off by
    # default, as in the JAX package.
    fused_pointwise_blocks: bool = False
    # Bytes of covers on the card under which ``--gates`` circuits run
    # there (the ``gate_cubes`` kernel), counted as the port holds them:
    # cubes, offsets and constant filters
    # (``compile/gate_device.py::device_bytes``), not as the JAX package
    # counts its padded cube tensors (``circuit_device_bytes``).  Larger
    # circuits, or a budget <= 0, run on the host native evaluator.
    gates_device_budget: int = 1 << 30


performance = PerformanceConfig()


@contextlib.contextmanager
def exact_numerics():
    """Turn the fused kernel (and with it the polynomial erf) off for the
    duration, and restore the switch afterwards, exception or not.  The
    truth-table compiler runs under it: a table row flips when a
    pre-activation sits within ~1e-6 of the Heaviside threshold, and a
    compiled table must not depend on the switch."""
    saved = performance.fused_pointwise_blocks
    performance.fused_pointwise_blocks = False
    try:
        yield
    finally:
        performance.fused_pointwise_blocks = saved
