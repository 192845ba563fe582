"""Training of the CIFAR zoo's mobilenets (``models/ttnet_cifar.py``)
against the JAX package on the CPU in f64.

Two f64 SGD steps of ``mobilenet_v2_tt_32_32`` (the TT_50 pair, at a
small ``(n, t)`` patched into both packages' stage tables) and of
``mobilenet_v1_tt`` (p = 4) match ``make_train_step`` to 1e-9, at the rate
of the card's ten-step check at the registry width (0.1, where the TT_50
pair's loss stayed near ln 10).  ``mobilenet_v1_tt`` runs at B = 16: at
B = 4 a train-mode BN's mean lands on a 2-bit level of its input, the
port's normalized input is an exact 0 there and JAX's fused reduction
rounds it below 0, so the two Heavisides take different values;
``test_v1_heaviside_ties`` shows both.
"""

import numpy as np
import pytest

from _torch_port import few_threads, site_disagreements, \
    x64  # noqa: F401
from test_torch_cifar_zoo import TOL, ZOO, assert_two_steps_match, zoo_pair

from scale_imagenet_tpu.models import ttnet_cifar as jcifar
from scale_imagenet_tpu_torch.models import ttnet_cifar as pcifar

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

V1_KW = dict(ZOO)["mobilenet_v1_tt"]


def test_mobilenet_v2_tt_32_32_two_train_steps_match_jax(x64):  # noqa: F811
    # BN bias entries that both steps leave near 1e-12 (a gradient of 0,
    # rounded) differ by up to ~2e-12: the trees are held to TOL's atol
    assert_two_steps_match("mobilenet_v2_tt_32_32", {}, 0.1, 4,
                           atol=TOL["atol"])


def test_mobilenet_v1_tt_two_train_steps_match_jax(x64):  # noqa: F811
    assert_two_steps_match("mobilenet_v1_tt", V1_KW, 0.1, 16)


@pytest.mark.parametrize("batch", [4, 16])
def test_v1_heaviside_ties(x64, batch):  # noqa: F811
    """The training forward's Heaviside inputs on the same weights and
    batch: at B = 4 a first site where every disagreement is an exact 0 of
    the port's (later sites follow from it); at B = 16 none."""
    jm, params, state, md, model = zoo_pair("mobilenet_v1_tt", V1_KW,
                                            seed=5)
    x = np.random.default_rng(13).uniform(0, 1, (batch, 32, 32, 3))
    sites = site_disagreements(jm, params, state, x, model,
                               (jcifar, "binarize01_act"),
                               (pcifar, "heaviside01"), lambda a: a >= 0)
    apart = [s for s in sites if s[0]]
    if batch == 16:
        assert not apart, sites
    else:
        assert apart and apart[0][1] == 0.0, sites
