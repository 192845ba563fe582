"""Numerics and performance switches (counterpart of
``scale_imagenet_tpu/config.py:14-100``).

One process-wide ``numerics`` and one ``performance`` object, as in the JAX
package.  The port has the fields of the paths it carries so far; the other
numerics fields, ``fast_gelu``, ``merge_heads12`` and
``gates_device_budget`` come with the paths that read them
(``ROADMAP.md``).
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


numerics = NumericsConfig()


@dataclasses.dataclass
class PerformanceConfig:
    # Run every eval-mode k=1 stride-1 Block_TT (head 3 and the fuse head
    # of each multi-head block) as the fused pointwise kernel
    # (kernels/fused_block.py): one launch instead of conv -> BN -> GELU
    # -> conv -> BN -> act, with the polynomial erf in its GELU.  Off by
    # default, as in the JAX package.
    fused_pointwise_blocks: bool = False


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
