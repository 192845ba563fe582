"""The port's serving transforms (``--fold_bn``, ``--bf16``), ``--mode
export`` and ``--list_models`` against the JAX package, on
``ttnet_imagenet_xsmall`` (nfilter 4, tfilter 4, ``--layers 0``) on the
CPU; one JAX init feeds both sides through ``convert/from_jax.py``.

Tolerances: the folded parameters equal JAX's ``fold_model_bns`` to 1e-12
in f64 and the folded forward JAX's to 1e-9 (summation order only); with
the fused switch on (its plain version here), the folded forward equals the
unfolded one as the fused kernel's tests hold it: at most 1e-4 of the
Heaviside outputs flip, each within 1e-4 of its threshold, and the logits
agree to 1e-4.  bf16 is held to JAX's argmax-agreement gate (>= 0.75,
``tests/test_bf16_eval.py``).  The exported file equals JAX's export of
the same weights key for key, and JAX's forward from it equals the port's
to 1e-9 in f64.
"""

import io
import threading
import urllib.request
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, tree_np, x64  # noqa: F401
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu import main as jmain
from scale_imagenet_tpu.convert import bn_fold as jfold
from scale_imagenet_tpu.convert.torch_export import save_torch_checkpoint
from scale_imagenet_tpu.convert.torch_import import import_ttnet_imagenet, \
    load_torch_state_dict
from scale_imagenet_tpu.models import get_model as jget
from scale_imagenet_tpu.models import list_models as jlist_models
from scale_imagenet_tpu.utils import cast_floating
from scale_imagenet_tpu_torch import config
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import bn_fold, state_dict_from_jax
from scale_imagenet_tpu_torch.data import ArrayDataset, write_shards
from scale_imagenet_tpu_torch.kernels import fused_block as FB
from scale_imagenet_tpu_torch.models import get_model, list_models
from scale_imagenet_tpu_torch.models import multihead
from scale_imagenet_tpu_torch.models.block_tt import BlockTT, BlockTTConfig
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_apply

NAME = "ttnet_imagenet_xsmall"
KW = dict(nfilter=4, tfilter=4, layers=0)
SMALL = ["--model", NAME, "--nfilter", "4", "--tfilter", "4", "--layers",
         "0"]
TOL = dict(rtol=1e-9, atol=1e-9)


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _out_first(w: torch.Tensor) -> np.ndarray:
    """Port OIHW conv / (out, in) linear weight -> the JAX layout (output
    axis last)."""
    a = w.detach().numpy()
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_folded_parameters_match_jax(x64):
    jm, params, state, md, model = jax_and_port(NAME, np.float64, seed=1,
                                                **KW)
    pairs = bn_fold.conv_bn_pairs_ttnet_imagenet(model)
    jpairs = jfold.conv_bn_pairs_ttnet_imagenet(jm.config)
    # the stem, 4 heads x 2 convs in each of 2 blocks, the classifier
    assert len(pairs) == len(jpairs) == 1 + 2 * 4 * 2 + 1
    jp, js = jfold.fold_model_bns(params, state, jpairs)
    assert bn_fold.fold_model_bns(model) == len(jpairs)
    for (conv, bn), (cpath, bpath) in zip(pairs, jpairs):
        jc = _get(jp, cpath)
        np.testing.assert_allclose(_out_first(conv.weight),
                                   np.asarray(jc["weight"]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(conv.bias.detach().numpy(),
                                   np.asarray(jc["bias"]), rtol=0, atol=1e-12)
        for ours, (tree, key) in ((bn.weight, (jp, "weight")),
                                  (bn.bias, (jp, "bias")),
                                  (bn.running_mean, (js, "running_mean")),
                                  (bn.running_var, (js, "running_var"))):
            np.testing.assert_array_equal(
                ours.detach().numpy(), np.asarray(_get(tree, bpath)[key]))


def test_folded_forward_matches_jax(x64):
    jm, params, state, md, model = jax_and_port(NAME, np.float64, seed=2,
                                                **KW)
    x = images((2, 224, 224, 3), 3)
    with torch.no_grad():
        unfolded = ttnet_imagenet_apply(model, torch.from_numpy(x))
        bn_fold.fold_model_bns(model)
        got = ttnet_imagenet_apply(model, torch.from_numpy(x))
    jp, js = jfold.fold_model_bns(
        params, state, jfold.conv_bn_pairs_ttnet_imagenet(jm.config))
    ref, _ = jax.jit(jm.apply)(jax.tree.map(jnp.asarray, jp),
                               jax.tree.map(jnp.asarray, js), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # folding is exact up to rounding: the same function in f64
    torch.testing.assert_close(got, unfolded, rtol=1e-9, atol=1e-9)


@pytest.fixture
def fused_on():
    saved = config.performance.fused_pointwise_blocks
    config.performance.fused_pointwise_blocks = True
    try:
        yield
    finally:
        config.performance.fused_pointwise_blocks = saved


def _k1_inputs(model, x) -> list:
    """``(block, input)`` of every k=1 Block_TT of a forward (head 3 and
    the fuse head of each block)."""
    seen = []
    real = multihead.block_tt

    def rec(block, h, *a, **k):
        if block.cfg.k in (1, (1, 1)):
            seen.append((block, h))
        return real(block, h, *a, **k)
    multihead.block_tt = rec
    try:
        ttnet_imagenet_apply(model, x)
    finally:
        multihead.block_tt = real
    return seen


def test_folded_fused_forward_equals_unfolded(fused_on):
    """With the fused switch on, the folded model's k=1 blocks carry their
    conv biases into the kernel's affines: each block's output equals the
    unfolded block's within the kernel's flip tolerance, and the logits
    agree.  Leaving the biases out of ``pointwise_params`` breaks both."""
    _, _, _, md, model = jax_and_port(NAME, np.float32, seed=3, **KW)
    x = torch.from_numpy(images((2, 224, 224, 3), 4).astype(np.float32))
    folded = md.init(device="cpu")
    folded.load_state_dict(model.state_dict())
    with torch.no_grad():
        bn_fold.fold_model_bns(folded)
        want = ttnet_imagenet_apply(model, x)
        got = ttnet_imagenet_apply(folded, x)
        cases = list(zip(_k1_inputs(model, x), _k1_inputs(folded, x)))
        assert len(cases) == 2 * len(model.blocks)
        for (block, h), (fblock, _) in cases:
            assert fblock.conv1.bias is not None
            a, b = block(h), fblock(h)
            if block.cfg.last:
                torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
                continue
            flips = a != b
            assert float(flips.float().mean()) <= 1e-4
            pre = FB.fused_pointwise_preact_plain(
                h.permute(0, 2, 3, 1).reshape(-1, h.shape[1]),
                *block.pointwise_params())
            near = pre.reshape(a.shape[0], a.shape[2], a.shape[3], -1) \
                .permute(0, 3, 1, 2)[flips]
            assert bool((near.abs() < 1e-4).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_pointwise_params_fold_conv_biases_in_f32():
    """``b += s * cb`` for both affines, in f32 from a bf16 module too, and
    the cached fold is redone when the fold adds the biases."""
    torch.manual_seed(0)
    block = BlockTT(BlockTTConfig(in_planes=16, out_planes=16, k=1,
                                  padding=0, groupsici=4)).eval()
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
    before = block.pointwise_params()
    bn_fold.fold_bn_into_conv(block.conv1, block.bn1)
    bn_fold.fold_bn_into_conv(block.conv2, block.bn2)
    after = block.pointwise_params()
    assert after is not before
    w1, s1, b1, w2, s2, b2 = after
    torch.testing.assert_close(b1, s1 * block.conv1.bias.reshape(4, -1))
    torch.testing.assert_close(b2, s2 * block.conv2.bias.reshape(4, -1))
    # the neutral BNs scale by one; the block computes what it did
    torch.testing.assert_close(s1, torch.ones_like(s1))
    torch.testing.assert_close(s2, torch.ones_like(s2))
    x = (torch.rand(3, 16) < 0.5).float()
    torch.testing.assert_close(FB.fused_pointwise_preact_plain(x, *after),
                               FB.fused_pointwise_preact_plain(x, *before),
                               rtol=1e-5, atol=1e-5)
    half = block.to(torch.bfloat16).pointwise_params()
    assert all(t.dtype == torch.float32 for t in half)
    torch.testing.assert_close(half[2], b1, rtol=1e-2, atol=1e-2)


def _smooth_batch() -> np.ndarray:
    """JAX's bf16 test batch: smooth structured images (noise images sit on
    random Heaviside boundaries far more often than natural ones)."""
    base = jax.random.uniform(jax.random.PRNGKey(1), (8, 14, 14, 3))
    return np.asarray(jax.image.resize(base, (8, 224, 224, 3), "linear"))


def test_bf16_forward_agrees_with_jax():
    """``--bf16`` casts the floating parameters and buffers: bf16 logits,
    argmax agreement >= 0.75 with the f32 forward and with JAX's
    ``cast_floating`` forward, the fused switch's bf16 path too, and TF32
    stays off."""
    jm = jget(NAME, **KW)
    params, state = jm.init(jax.random.PRNGKey(0))
    model = get_model(NAME, **KW).init(device="cpu")
    model.load_state_dict(state_dict_from_jax(tree_np(params),
                                              tree_np(state), model.cfg))
    x = _smooth_batch()
    xt = torch.from_numpy(x.copy())
    with torch.no_grad():
        f32 = ttnet_imagenet_apply(model, xt)
        cfg = cli.parse_args(["--bf16", "--shards_dir", "d", *SMALL])
        cli.apply_serving_transforms(cfg, model)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert all(t.dtype == torch.bfloat16 for t in model.parameters())
        got = ttnet_imagenet_apply(model, xt)
        saved = config.performance.fused_pointwise_blocks
        config.performance.fused_pointwise_blocks = True
        try:
            fused = ttnet_imagenet_apply(model, xt)
        finally:
            config.performance.fused_pointwise_blocks = saved
    assert got.dtype == fused.dtype == torch.bfloat16
    ref = jm.apply(cast_floating(params), cast_floating(state),
                   jnp.asarray(x, jnp.bfloat16), training=False)[0]
    assert ref.dtype == jnp.bfloat16
    top = got.float().argmax(1).numpy()
    for other in (f32.argmax(1).numpy(),
                  np.asarray(jnp.argmax(ref.astype(jnp.float32), -1)),
                  fused.float().argmax(1).numpy()):
        assert float(np.mean(top == other)) >= 0.75


def test_bf16_eval_metrics_match_jax():
    """The eval step's sums on bf16 logits, as the JAX step takes them: the
    log-softmax in bf16, the masked sums in f32 (its pad rows left out);
    top-k counts equal, the loss to bf16's step."""
    from scale_imagenet_tpu.train.losses import masked_metric_sums as jsums
    from scale_imagenet_tpu_torch.train.losses import masked_metric_sums

    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((9, 1000)) * 3).astype(np.float32)
    labels = rng.integers(0, 1000, 9).astype(np.int32)
    labels[-2:] = -1                                     # pad rows
    got = masked_metric_sums(torch.from_numpy(logits).to(torch.bfloat16),
                             torch.from_numpy(labels))
    want = jsums(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    assert got[0].dtype == torch.float32 and want[0].dtype == jnp.float32
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=2 ** -7)
    assert [float(c) for c in got[1]] == [float(c) for c in want[1]]
    assert float(got[2]) == float(want[2]) == 7.0


def _shards(tmp_path, n=6):
    rng = np.random.default_rng(11)
    root = str(tmp_path / "shards")
    write_shards(ArrayDataset(rng.integers(0, 256, (n, 224, 224, 3),
                                           dtype=np.uint8),
                              rng.integers(0, 10, n).astype(np.int32)), root)
    return root


def test_cli_eval_with_the_serving_transforms(tmp_path):
    """``--mode eval`` with ``--fold_bn``, ``--bf16`` and both: the fold
    scores as the unfolded conv does; bf16 runs to a finite loss."""
    base = ["--mode", "eval", "--device", "cpu", "--shards_dir",
            _shards(tmp_path), "--eval_batch_size", "4", "--seed", "3",
            "--root_dir", str(tmp_path), *SMALL]
    with redirect_stdout(io.StringIO()) as out:
        runs = {name: cli.main(base + extra) for name, extra in (
            ("conv", []), ("fold", ["--fold_bn"]), ("bf16", ["--bf16"]),
            ("fold_bf16", ["--fold_bn", "--bf16"]))}
    assert out.getvalue().count("folded 18 conv/BN pairs") == 2
    assert runs["fold"][:2] == runs["conv"][:2]
    assert abs(runs["fold"][2] - runs["conv"][2]) < 1e-4
    for name in ("bf16", "fold_bf16"):
        assert np.isfinite(runs[name][2]) and 0 <= runs[name][0] <= 100


def test_cli_serve_with_the_serving_transforms():
    """``--mode serve --fold_bn --bf16``: the answers are the transformed
    model's direct forward's."""
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                cli.main(["--mode", "serve", "--fold_bn", "--bf16",
                          "--device", "cpu", "--port", "0", "--serve_batch",
                          "2", "--seed", "5", *SMALL],
                         serve_ready=ready, serve_stop=stop)
        except Exception as e:                  # surfaced below
            errors.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    xs = images((2, 224, 224, 3), 14).astype(np.float32)
    try:
        assert ready.wait(120) and not errors, errors
        answers = []
        for x in xs:
            req = urllib.request.Request(
                f"http://127.0.0.1:{ready.port}/predict", data=x.tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.loads(r.read()))
    finally:
        stop.set()
        th.join(30)
    assert not th.is_alive() and not errors
    model = get_model(NAME, **KW).init(seed=5, device="cpu")
    with torch.no_grad(), redirect_stdout(io.StringIO()):
        cli.apply_serving_transforms(cli.parse_args(
            ["--mode", "serve", "--fold_bn", "--bf16", *SMALL]), model)
        logits = ttnet_imagenet_apply(model, torch.from_numpy(xs))
    # bf16 logits tie often, and tied classes may come in either order: the
    # answers' classes carry the direct forward's probabilities, which are
    # its five largest
    probs = torch.softmax(logits.float(), -1).numpy()
    for a, p in zip(answers, probs):
        np.testing.assert_array_equal(np.float32(a["probs"]), p[a["top5"]])
        np.testing.assert_array_equal(np.float32(a["probs"]),
                                      np.sort(p)[::-1][:5])


def test_export_equals_jax_export_and_loads_in_jax(tmp_path, x64):
    """``--mode export`` from a JAX-written ``.pth``: the file equals JAX's
    ``save_torch_checkpoint`` of the same weights key for key (values,
    dtypes), and JAX's importer reads it into a forward equal to the
    port's in f64."""
    jm, params, state, md, _ = jax_and_port(NAME, np.float32, seed=6, **KW)
    theirs = str(tmp_path / "jax.pth")
    save_torch_checkpoint(theirs, params, state, jm.config)
    ours = str(tmp_path / "port.pth")
    with redirect_stdout(io.StringIO()) as out:
        assert cli.main(["--mode", "export", "--device", "cpu", "--ckpt",
                         theirs, "--export_out", ours, *SMALL]) == ours
    assert "wrote reference-compatible checkpoint" in out.getvalue()
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert list(a) == list(b) == ["model_state_dict"]
    a, b = a["model_state_dict"], b["model_state_dict"]
    assert sorted(a) == sorted(b)
    for k in b:
        # the JAX exporter's ``np.ascontiguousarray`` writes the 0-d buffers
        # (``num_batches_tracked``, ``grad_scale``) as shape (1,); the port
        # writes them 0-d, as the reference modules' own state dicts hold
        # them, and torch loads either
        want = b[k].reshape(()) if a[k].dim() == 0 else b[k]
        assert a[k].dtype == want.dtype and torch.equal(a[k], want), k
    ip, istate = import_ttnet_imagenet(load_torch_state_dict(ours),
                                       jm.config)
    ip, istate = tree_np(ip, np.float64), tree_np(istate, np.float64)
    model = md.init(device="cpu", dtype=torch.float64)
    cli.load_checkpoint(model, ours)
    x = images((2, 224, 224, 3), 7)
    ref, _ = jax.jit(jm.apply)(jax.tree.map(jnp.asarray, ip),
                               jax.tree.map(jnp.asarray, istate),
                               jnp.asarray(x))
    with torch.no_grad():
        got = ttnet_imagenet_apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_list_models():
    with redirect_stdout(io.StringIO()) as out:
        names = cli.main(["--list_models"])
    assert names == list_models() == out.getvalue().split()
    assert set(names) <= set(jlist_models())


def _jax_refusal(argv, tmp_path) -> str:
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        jmain.main(argv + ["--mesh_data", "1", "--root_dir", str(tmp_path),
                           "--export_out", str(tmp_path / "x.pth")])
    return str(err.value)


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--bf16", "--lut"],
    ["--mode", "eval", "--fold_bn", "--lut"],
    ["--mode", "eval", "--fold_bn", "--bf16", "--lut"],
    ["--mode", "eval", "--gates", "dnf", "--bf16"],
    ["--mode", "eval", "--gates", "cnf", "--fold_bn"],
    ["--mode", "serve", "--bf16", "--lut"],
    ["--mode", "serve", "--fold_bn", "--lut"],
    ["--mode", "serve", "--gates", "dnf", "--bf16"],
    ["--mode", "serve", "--gates", "dnf", "--fold_bn"],
    ["--mode", "export", "--lut"],
    ["--mode", "export", "--gates", "dnf"],
    ["--mode", "export", "--fold_bn"],
    ["--mode", "export", "--bf16"],
    ["--mode", "export", "--amp"],
    ["--mode", "export", "--grad_accum", "2"],
    ["--mode", "export", "--remat"],
    ["--mode", "export", "--ema", "0.9"],
    ["--mode", "export", "--label_smooth", "0.1"],
    ["--mode", "export", "--shards_dir", "d"],
], ids=lambda a: "_".join(x.strip("-") for x in a[1:]))
def test_refusals_are_the_jax_messages(argv, tmp_path):
    shards = ["--shards_dir", "d"] if argv[1] == "eval" else []
    want = _jax_refusal(argv + shards + SMALL, tmp_path)
    with pytest.raises(ValueError) as err:
        cli.main(argv + shards + SMALL + ["--device", "cpu"])
    assert str(err.value) == want


@pytest.mark.parametrize("argv,match", [
    (["--mode", "eval", "--shards_dir", "d", "--compile_cache", "c"],
     "--compile_cache is the JAX package's persistent XLA"),
    (["--mode", "compile", "--bf16"], "--bf16 casts conv-serving weights"),
])
def test_flags_the_jax_cli_takes_and_the_port_refuses(argv, match):
    """The JAX CLI accepts both (an XLA cache; a cast compile does not
    read): the port refuses a flag that would do nothing."""
    with pytest.raises(ValueError, match=match):
        cli.main(argv + SMALL + ["--device", "cpu"])
