"""Defaults-dict -> argparse auto-generation (copy of unet_tpu/utils/args.py).

Every key of a defaults dict becomes a `--key` CLI flag whose type is
inferred from the default value, and boolean flags accept explicit
true/false-style words (`--flag true`) rather than argparse's store_true,
so command lines stay the same as the JAX package's.
"""

from __future__ import annotations

import argparse
from typing import Dict

_TRUE_WORDS = frozenset({"1", "t", "y", "true", "yes", "on"})
_FALSE_WORDS = frozenset({"0", "f", "n", "false", "no", "off"})


def str2bool(value) -> bool:
    """Parse the reference CLI's explicit boolean words (utils.py:13-24
    semantics; also used by guided-diffusion, which both repos derive
    from)."""
    if isinstance(value, bool):
        return value
    word = str(value).strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    raise argparse.ArgumentTypeError(
        f"expected a boolean word (true/false/...), got {value!r}")


def add_dict_to_argparser(parser: argparse.ArgumentParser,
                          defaults: Dict) -> None:
    """One `--<key>` flag per defaults entry; type follows the default
    (None -> free-form string, bool -> str2bool)."""
    for key, default in defaults.items():
        if default is None:
            parse = str
        elif isinstance(default, bool):
            parse = str2bool
        else:
            parse = type(default)
        parser.add_argument(f"--{key}", type=parse, default=default)


def args_to_dict(args: argparse.Namespace, keys) -> Dict:
    """Project the parsed namespace back onto a config dict."""
    return {key: getattr(args, key) for key in keys}
