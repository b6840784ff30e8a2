"""Crash-safe staged output: write into a private temp dir beside the
destination, then atomically rename into place (main.cpp:446-558; the
port's copy of lac_tpu/utils/staged_output.py).

Failed runs never clobber or remove an existing output file; temp
directories are always cleaned up.
"""

import os
import random
import time


def _paths_refer_to_same_file(a: str, b: str) -> bool:
    try:
        sa = os.stat(a)
        sb = os.stat(b)
        return (sa.st_dev, sa.st_ino) == (sb.st_dev, sb.st_ino)
    except OSError:
        pass
    try:
        return os.path.realpath(a) == os.path.realpath(b)
    except OSError:
        return False


paths_refer_to_same_file = _paths_refer_to_same_file


class StagedOutputFile:
    def __init__(self, output_path: str):
        self.output_path = output_path
        self.temporary_directory = None
        self.temporary_path = None
        parent = os.path.dirname(output_path) or "."
        if not os.path.basename(output_path):
            return
        for _ in range(128):
            token = f"{time.monotonic_ns() ^ random.getrandbits(64):x}"
            candidate = os.path.join(parent, f".lac-tmp.{token}")
            try:
                os.mkdir(candidate, 0o700)
            except FileExistsError:
                continue
            except OSError:
                return
            self.temporary_directory = candidate
            self.temporary_path = os.path.join(candidate, "output")
            return

    def is_ready(self) -> bool:
        return self.temporary_path is not None

    def path(self) -> str:
        return self.temporary_path

    def publish(self, input_path: str) -> bool:
        if not self.is_ready():
            return False
        if _paths_refer_to_same_file(input_path, self.output_path):
            return False
        try:
            os.replace(self.temporary_path, self.output_path)
        except OSError:
            return False
        self.temporary_path = None
        try:
            os.rmdir(self.temporary_directory)
            self.temporary_directory = None
        except OSError:
            pass
        return True

    def cleanup(self):
        if self.temporary_path is not None:
            try:
                os.remove(self.temporary_path)
            except OSError:
                pass
            self.temporary_path = None
        if self.temporary_directory is not None:
            try:
                os.rmdir(self.temporary_directory)
            except OSError:
                pass
            self.temporary_directory = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
        return False
