"""The v1 family's refusals against the JAX CLI's, on the CPU: ``--lut``
and ``--gates`` (eval and serve) refuse with JAX's family text,
``--mode export`` with its exporter's, ``--fold_bn`` and ``--remat`` with
theirs, and ``--mode compile`` with JAX's enumeration error (n = 49 or 64
bits); on the two small variants, whose first head has 16 bits, the JAX
CLI fails with an AttributeError, which the port's ValueError names.
"""

import io
from contextlib import redirect_stdout

import pytest

from _torch_port import jax_cli_refusal
from _torch_port import few_threads  # noqa: F401

from scale_imagenet_tpu_torch import main as cli


# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("name,argv", [
    ("TT_vf_19lv2_cifar", ["--mode", "eval", "--lut"]),
    ("TT_vf_19lv2_cifar", ["--mode", "eval", "--gates", "dnf"]),
    ("TT_vf_19lv2_cifar", ["--mode", "serve", "--lut"]),
    ("TT_vf_19lv2_cifar", ["--mode", "serve", "--gates", "cnf"]),
    ("TT_vf_19lv2_cifar", ["--mode", "export"]),
    ("TT_vf_19lv2_cifar", ["--mode", "eval", "--fold_bn"]),
    ("TT_vf_19lv2_cifar", ["--mode", "train", "--remat"]),
    ("TT_vf_19lv2_cifar", ["--mode", "compile"]),
    ("TT_vf_64bit_cifar", ["--mode", "compile"]),
    ("TT_vf_small_cifar", ["--mode", "compile"]),
], ids=["eval_lut", "eval_gates", "serve_lut", "serve_gates", "export",
        "fold_bn", "remat", "compile_n49", "compile_n64",
        "compile_small"])
def test_refusals_are_the_jax_clis(name, argv, tmp_path):
    """What the JAX CLI refuses, with its text.  On the two small variants
    its compile fails with an AttributeError, which the port names."""
    argv = argv + ["--model", name, "--nfilter", "2", "--tfilter", "2"]
    argv += {"export": ["--export_out", str(tmp_path / "e.pth")],
             "compile": ["--compile_out", str(tmp_path / "c")]}.get(
                 argv[1], [])
    if argv[1] in ("eval", "train"):
        argv += ["--shards_dir", str(tmp_path)]
    want = jax_cli_refusal(argv, str(tmp_path))
    with pytest.raises(ValueError) as err, redirect_stdout(io.StringIO()):
        cli.main(argv + ["--device", "cpu", "--root_dir", str(tmp_path)])
    if isinstance(want, AttributeError):
        assert "'quant'" in str(want) and "'quant'" in str(err.value)
    else:
        assert isinstance(want, ValueError) and str(err.value) == str(want)
