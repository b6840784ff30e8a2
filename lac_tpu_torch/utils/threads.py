"""Worker-count resolution (thread_limit.hpp:10-33, main.cpp:560-591; the
port's copy of lac_tpu/utils/threads.py).

The library never reads the environment itself; the CLI resolves
``--threads`` then ``LAC_THREADS`` and passes an explicit count (0 =
auto). In the port the count caps the native runtime's host workers
(planning, emit, decode) — device parallelism is the array dimension.
"""


def parse_thread_limit(value) -> int:
    """Strict positive-integer parse; '' / None -> 0 (auto)."""
    if value is None or value == "":
        return 0
    if not all("0" <= c <= "9" for c in value):
        raise ValueError("LAC_THREADS must be a positive integer")
    parsed = int(value)
    if parsed == 0:
        raise ValueError("LAC_THREADS must be a positive integer")
    return parsed


def parse_threads_flag(flag: str):
    """Parse ``--threads=N``; returns N or None if the flag is not ours."""
    prefix = "--threads="
    if not flag.startswith(prefix):
        return None
    value = flag[len(prefix):]
    if not value or not all("0" <= c <= "9" for c in value):
        raise ValueError("--threads requires a positive integer")
    parsed = int(value)
    if parsed == 0:
        raise ValueError("--threads requires a positive integer")
    return parsed
