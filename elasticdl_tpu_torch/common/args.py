"""Boolean command-line flags (port of elasticdl_tpu/common/args.py,
trimmed to ``bool_flag`` and ``add_bool_argument``; the PS server's own
flags live in ``ps/server.py:parse_ps_args``)."""

import argparse


def bool_flag(value):
    """Accept the reference's bool spellings (--use_async=True) beside
    0/1; anything else is an argparse error."""
    lowered = str(value).strip().lower()
    if lowered in ("true", "yes", "1"):
        return 1
    if lowered in ("false", "no", "0"):
        return 0
    raise argparse.ArgumentTypeError(
        "expected a boolean (true/false/1/0), got %r" % (value,)
    )


def add_bool_argument(parser, name, default=0, help=None):
    """A bool flag whose bare spelling (``--use_async`` with no value)
    flips the default, while ``--use_async=True`` or ``--use_async 1``
    still parse through ``bool_flag``."""
    parser.add_argument(
        name,
        nargs="?",
        const=0 if default else 1,
        type=bool_flag,
        default=default,
        help=help,
    )
