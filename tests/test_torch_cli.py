"""The port's CLI accepts the reference's ``--nthreads`` where the JAX
package's does: hidden, on ``inference``, ``generate``, ``chat``, ``serve``
and ``worker``, and ignored (the card sets the parallelism)."""

import pytest

from dllama_tpu import cli as jcli
from dllama_tpu_torch import cli as tcli

MODES = ("inference", "generate", "chat", "serve", "worker")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("package", [jcli, tcli], ids=["jax", "torch"])
def test_nthreads_parses(package, mode):
    parser = package.build_parser()
    args = parser.parse_args([mode, "--model", "m.m", "--tokenizer", "t.t", "--nthreads", "4"])
    assert args.nthreads == 4
    sub = parser._subparsers._group_actions[0].choices[mode]
    assert "--nthreads" not in sub.format_help() and "--model" in sub.format_help()
