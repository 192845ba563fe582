"""Training of ``resnet18_cifar`` with 4-bit weights and 4-bit
activations, the registry's default, against the JAX package on the CPU
in f64 (each quantizer alone is in ``tests/test_torch_resnet.py``).

Two f64 SGD steps match ``make_train_step`` to 1e-9 on 32x32 batches.  At
8x8 some pre-ReLU sums of the quantized grid are 0 in exact arithmetic,
the two frameworks' reductions round them apart by under 1e-15, and the
ReLU's gradient mask differs there; ``test_w4a4_relu_ties`` counts those
entries at 8x8 and finds none at 32x32.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads, port_and_trees, site_disagreements, \
    x64  # noqa: F401
from test_torch_resnet import assert_two_steps_match

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def test_w4a4_two_train_steps_match_jax(x64):  # noqa: F811
    assert_two_steps_match(4, 4, 32)


@pytest.mark.parametrize("side", [8, 32])
def test_w4a4_relu_ties(x64, side):  # noqa: F811
    jm, params, state, md, model = port_and_trees(
        "resnet18_cifar", seed=5, num_classes=10, wbit=4, abit=4)
    x = np.random.default_rng(6).uniform(-1, 1, (4, side, side, 3))
    sites = site_disagreements(jm, params, state, x, model,
                               (jax.nn, "relu"), (torch, "relu"),
                               lambda a: a > 0)
    apart = [s for s in sites if s[0]]
    if side == 32:
        assert not apart, sites
    else:
        assert apart and max(s[1] for s in apart) < 1e-12, sites
