"""Compiled-LUT archives shared between the packages: the port's weight
digest equals the JAX package's for the same weights, an archive written
by either package loads in the other with equal tables, and a stale or
wrong-version archive is refused.  Both sides hold the same f32 weights
and enumerate their tables in f32, where they are equal
(``tests/test_torch_lut_eval.py::test_lut_forward_matches_jax_lut``)."""

import copy

import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port

from scale_imagenet_tpu import compile as jcompile
from scale_imagenet_tpu_torch.compile import lut_eval
from scale_imagenet_tpu_torch.compile.lut_store import LUT_FORMAT_VERSION, \
    _table, load_luts, model_digest, params_digest, save_luts
from scale_imagenet_tpu_torch.convert import jax_trees

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

NAME, KW = "ttnet_imagenet_xsmall", dict(nfilter=4, tfilter=4, layers=0)


@pytest.fixture
def both():
    return jax_and_port(NAME, np.float32, **KW)


def _heads(luts):
    return [lut for ml in luts for lut in [*ml.heads.values(), ml.convf]]


def test_digest_matches_jax(both):
    jm, params, state, md, model = both
    assert model_digest(model) == jcompile.params_digest(params, state)
    assert params_digest(*jax_trees(model)) == \
        jcompile.params_digest(params, state)
    assert model_digest(model) != model_digest(copy.deepcopy(model).double())


def _assert_tables(got, want, what):
    """Bit tables equal; float tables (a last block's) within f32
    summation order."""
    if got.cfg.last:
        torch.testing.assert_close(got.packed, want.packed, rtol=0,
                                   atol=1e-6, msg=what)
    else:
        assert torch.equal(got.packed, want.packed), what


def test_jax_archive_loads_in_the_port(both, tmp_path):
    jm, params, state, md, model = both
    path = str(tmp_path / "jax.npz")
    jcompile.save_luts(path, jcompile.compile_ttnet_lut(params, state,
                                                        jm.config),
                       params, state)
    loaded = load_luts(path, model)
    compiled = lut_eval.compile_ttnet_lut(model)
    with np.load(path) as data:
        stored = [data[f"b{i}_{key}_table"] for i, ml in enumerate(loaded)
                  for key in [*(f"h{h}" for h in ml.heads), "convf"]]
    for i, (a, b) in enumerate(zip(_heads(loaded), _heads(compiled))):
        assert a.cfg == b.cfg and a.nonconstant == b.nonconstant
        # the load is lossless: the archive's table comes back as it was
        np.testing.assert_array_equal(_table(a).numpy(), stored[i])
        _assert_tables(a, b, f"head {i}")
    x = torch.from_numpy(images((2, 224, 224, 3), 5).astype(np.float32))
    assert torch.equal(lut_eval.lut_ttnet_apply(loaded, model, x),
                       lut_eval.lut_ttnet_apply(compiled, model, x))


def test_port_archive_loads_in_jax(both, tmp_path):
    jm, params, state, md, model = both
    path = str(tmp_path / "port.npz")
    save_luts(path, lut_eval.compile_ttnet_lut(model), model)
    got = jcompile.load_luts(path, jm.config, params, state)
    want = jcompile.compile_ttnet_lut(params, state, jm.config)
    for g, w in zip(got, want):
        for a, b in zip([*g.heads.values(), g.convf],
                        [*w.heads.values(), w.convf]):
            if a.cfg.last:       # f32 summation order of the two compilers
                np.testing.assert_allclose(np.asarray(a.table),
                                           np.asarray(b.table), rtol=0,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(a.table),
                                              np.asarray(b.table))
                np.testing.assert_array_equal(np.asarray(a.packed),
                                              np.asarray(b.packed))


def test_stale_or_old_archive_is_refused(both, tmp_path):
    jm, params, state, md, model = both
    path = str(tmp_path / "a.npz")
    save_luts(path, lut_eval.compile_ttnet_lut(model), model)
    with torch.no_grad():
        model.features[2].running_mean.add_(0.5)       # other weights
    with pytest.raises(ValueError, match="DIFFERENT weights"):
        load_luts(path, model)
    with np.load(path) as data:
        arrs = dict(data)
    arrs["__format_version__"] = np.int64(LUT_FORMAT_VERSION - 1)
    np.savez(str(tmp_path / "old.npz"), **arrs)
    with pytest.raises(ValueError, match="format version 1"):
        load_luts(str(tmp_path / "old.npz"), model)
    del arrs["__params_digest__"], arrs["__format_version__"]
    np.savez(str(tmp_path / "none.npz"), **arrs)
    with pytest.raises(ValueError, match="format version None"):
        load_luts(str(tmp_path / "none.npz"), model)
