"""The ten v1 ImageNet models at 224x224 against the JAX package on the
CPU, at the smallest width every one of their configs accepts (p = 4:
head 3's ``in_planes / 4`` groups need four channels): the port's seeded
model (BN statistics perturbed) in both packages through
``convert/from_jax.py``'s inverse map, f64 logits to 1e-9.  The 32x32
clones and the parts are in ``tests/test_torch_v1_models.py`` and
``tests/test_torch_v1.py``.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, images, port_and_trees, \
    x64  # noqa: F401

from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import V1_STAGES

SMALLEST = dict(nfilter=1, tfilter=4)


@pytest.mark.parametrize("name", list(V1_STAGES))
def test_logits_match_jax_f64_at_224(x64, name):  # noqa: F811
    jm, params, state, md, model = port_and_trees(name, seed=1, **SMALLEST)
    assert md.config.p == 4 and md.config.image_size == 224
    x = images((1, 224, 224, 3), 3) * 2 - 1
    fwd = jax.jit(lambda p, s, a: jm.apply(p, s, a)[0])
    want = fwd.lower(params, state, x).compile(_FAST_COMPILE)(params,
                                                              state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-9)
