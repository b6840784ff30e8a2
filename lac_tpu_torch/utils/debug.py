"""Debug output of the CLI's ``--debug-*`` encode flags (the part of
lac_tpu/utils/debug.py those flags use)."""

import sys


def debug_log(msg: str) -> None:
    sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")
