"""``scale_imagenet_tpu_torch/utils/`` against ``scale_imagenet_tpu/utils/``
on the same inputs: every public name of the JAX package's ``utils``, and
``tap_norm``.

* ``rgb_to_hsv`` to 1e-6 in f32, ties of the smallest channel included;
* ``count_parameters`` and ``get_sparsity_stat`` on one model built from
  one JAX init (``cifar10lownoise``, whose binarized convs carry
  ``weight_mask``), its printed table's total line too;
* ``AverageMetric``, ``LimitedDatasetIter`` and ``ReplayDatasetIter``
  exactly; ``get_mean_and_std`` to 1e-6;
* ``cast_floating``: the floating tensors in bf16, the integer ones kept,
  as JAX casts the trees;
* ``print_tree_shapes``'s lines, and ``tap_norm``'s forward and ``:grad``
  lines, equal JAX's on ``tests/test_harness.py::
  test_tap_norm_prints_inside_jit``'s function;
* ``StepTimer`` closes its region with a host read, and
  ``profile_trace`` writes a trace file on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import few_threads, jax_and_port  # noqa: F401

from scale_imagenet_tpu import utils as jutils
from scale_imagenet_tpu.utils.tracing import tap_norm as jtap_norm
from scale_imagenet_tpu_torch import utils

pytestmark = pytest.mark.usefixtures("few_threads")


def test_utils_holds_every_public_name_of_the_jax_package():
    assert set(jutils.__all__) | {"tap_norm"} == set(utils.__all__)


def test_rgb_to_hsv_matches_jax_ties_included():
    rng = np.random.default_rng(0)
    smooth = rng.uniform(size=(6, 7, 3))
    # three levels: many pixels with two or three equal channels
    ties = rng.integers(0, 3, (6, 7, 3)) / 2.0
    for img in (smooth, ties):
        img = img.astype(np.float32)
        want = np.asarray(jutils.rgb_to_hsv(jnp.asarray(img)))
        got = utils.rgb_to_hsv(torch.from_numpy(img)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(want).max())))
    # a tie of the minimum takes the first channel's branch, as jnp.argmin
    got = utils.rgb_to_hsv(torch.tensor([[[0.2, 0.2, 0.6]]]))
    want = jutils.rgb_to_hsv(jnp.asarray([[[0.2, 0.2, 0.6]]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def masked():
    _, params, state, _, model = jax_and_port("cifar10lownoise", np.float32,
                                              seed=4, jit=True)
    return params, model


def test_count_parameters_matches_jax(masked, capsys):
    params, model = masked
    want = jutils.count_parameters(params)
    jax_table = capsys.readouterr().out
    got = utils.count_parameters(model)
    table = capsys.readouterr().out
    assert got == want == sum(p.numel() for p in model.parameters())
    assert table.splitlines()[-1] == jax_table.splitlines()[-1] == \
        f"Total Trainable Params: {want:,}"
    assert len(table.splitlines()) == len(jax_table.splitlines())
    assert utils.count_parameters(model, verbose=False) == want
    assert capsys.readouterr().out == ""


def test_get_sparsity_stat_matches_jax(masked):
    params, model = masked
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight_mask"):
                # a third of the mask below the 1e-4 threshold, on both
                p.view(-1)[::3] = 5e-5
    from scale_imagenet_tpu_torch.convert import jax_trees

    params, _ = jax_trees(model)
    want = jutils.get_sparsity_stat(params)
    got = utils.get_sparsity_stat(model)
    assert got[1:] == want[1:] and got[2] > 0 and got[1] >= got[2] // 3
    assert got[0] == pytest.approx(want[0], abs=0)


def test_average_metric_and_iterators_are_exact():
    values = [(0.5, 3), (2.25, 1), (1.0, 4)]
    jm, pm = jutils.AverageMetric(), utils.AverageMetric()
    for v, n in values:
        jm.add(v, n)
        pm.add(torch.tensor(v), n)
    assert (pm.avg, pm.count) == (jm.avg, jm.count)
    assert utils.AverageMetric().avg == jutils.AverageMetric().avg == 0.0

    loader = [(i, i * i) for i in range(7)]
    for limit in (3, 10):
        j, p = jutils.LimitedDatasetIter(loader, limit), \
            utils.LimitedDatasetIter(loader, limit)
        assert len(p) == len(j) and list(p) == list(j) == list(p)

    class Once:
        """A loader that can run one epoch only."""
        def __init__(self):
            self.epochs = 0

        def __len__(self):
            return 4

        def __iter__(self):
            self.epochs += 1
            assert self.epochs == 1
            return iter(range(4))

    j, p = jutils.ReplayDatasetIter(Once()), utils.ReplayDatasetIter(Once())
    for _ in range(3):
        assert list(p) == list(j) == [0, 1, 2, 3]
        assert len(p) == len(j) == 4


def test_get_mean_and_std_matches_jax():
    rng = np.random.default_rng(1)
    data = [(rng.uniform(size=(5, 6, 3)).astype(np.float32), i)
            for i in range(9)]
    tdata = [(torch.from_numpy(x), y) for x, y in data]
    for batches in (4, 64):
        want = jutils.get_mean_and_std(data, batches)
        got = utils.get_mean_and_std(tdata, batches)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_cast_floating_matches_jax(masked):
    _, model = masked
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tree = {k: jnp.asarray(v.numpy()) for k, v in sd.items()}
    want = jutils.cast_floating(tree)
    got = utils.cast_floating(model)
    assert got is model
    for k, v in model.state_dict().items():
        # JAX holds the int64 counters as int32 (x64 off): which tensors
        # are cast is the same
        assert (v.dtype == torch.bfloat16) == (want[k].dtype == jnp.bfloat16)
        assert v.dtype == (torch.bfloat16 if sd[k].is_floating_point()
                           else sd[k].dtype), k
    model.float()


def test_print_tree_shapes_matches_jax(capsys):
    rng = np.random.default_rng(2)
    tree = {"conv": {"weight": rng.standard_normal((4, 3)).astype(
        np.float32)}, "steps": np.zeros((2,), np.int32)}
    jutils.print_tree_shapes("t", jax.tree.map(jnp.asarray, tree))
    want = capsys.readouterr().out
    utils.print_tree_shapes("t", {"conv": {"weight": torch.from_numpy(
        tree["conv"]["weight"])}, "steps": torch.from_numpy(tree["steps"])})
    assert capsys.readouterr().out == want
    assert "[t] conv/weight: (4, 3) float32" in want
    lin = torch.nn.Linear(3, 2)
    utils.print_tree_shapes("m", lin)
    assert capsys.readouterr().out.splitlines() == [
        "[m] weight: (2, 3) float32", "[m] bias: (2,) float32"]


def test_tap_norm_lines_match_jax(capfd):
    """``test_tap_norm_prints_inside_jit``'s function on both sides: the
    forward line and the ``:grad`` line are the same text."""
    @jax.jit
    def f(x):
        return (jtap_norm("mid", x, grad=True) ** 2).sum()

    g = jax.grad(f)(jnp.arange(4.0))
    jax.effects_barrier()
    want = capfd.readouterr().out.splitlines()
    x = torch.arange(4.0, requires_grad=True)
    (utils.tap_norm("mid", x, grad=True) ** 2).sum().backward()
    got = capfd.readouterr().out.splitlines()
    assert got == want
    assert got[0] == "[mid] shape=(4,) min=0 max=3 norm=3.742"
    assert got[1].startswith("[mid:grad] shape=(4,)")
    assert x.grad.tolist() == np.asarray(g).tolist()
    # without grad: one line, the input itself back
    y = torch.ones(2, 3)
    assert utils.tap_norm("t", y) is y
    assert capfd.readouterr().out == "[t] shape=(2, 3) min=1 max=1 " \
                                     "norm=2.449\n"


def test_step_timer_and_profile_trace(tmp_path):
    timer = utils.StepTimer()
    for sync in (None, torch.ones(3), {"loss": torch.zeros(()),
                                       "n": torch.ones(2)}):
        timer.start()
        dt = timer.stop(sync)
        assert dt >= 0
    assert len(timer.times) == 3
    assert timer.mean == pytest.approx(sum(timer.times) / 3)
    assert utils.StepTimer().mean == 0.0
    with utils.profile_trace(str(tmp_path)):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
