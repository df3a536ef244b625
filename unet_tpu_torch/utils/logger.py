"""Key-value metrics logger, openai-baselines style (copy of
unet_tpu/utils/logger.py, which imports no JAX; the port keeps its own).

`Logger` (`logkv`, `logkv_mean`, `dumpkvs`) writes a human-readable table
and, given a directory, a CSV file; `TextLog` is the CUDA trainer's plain
line log, mirrored to stdout and appended to a file.  The output is the JAX
package's, character for character.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Dict, List, Optional, TextIO


class HumanOutputFormat:
    """Boxed k/v table, like the reference's HumanOutputFormat
    (train_unet.py:556-591)."""

    def __init__(self, stream: TextIO):
        self.stream = stream

    def writekvs(self, kvs: Dict[str, float]) -> None:
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._trunc(key)] = self._trunc(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in key2str.items():
            lines.append(f"| {key}{' ' * (keywidth - len(key))} "
                         f"| {val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 30) -> str:
        return s[:maxlen - 3] + "..." if len(s) > maxlen else s


class CSVOutputFormat:
    """Append-mode CSV with dynamic header extension
    (reference train_unet.py:594-633)."""

    def __init__(self, filename: str):
        self.file = open(filename, "w+t")
        self.keys: List[str] = []

    def writekvs(self, kvs: Dict[str, float]) -> None:
        extra_keys = sorted(kvs.keys() - self.keys)
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.write(",".join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line[:-1] + "," * len(extra_keys) + "\n")
            self.file.truncate()
        vals = [str(kvs.get(k, "")) for k in self.keys]
        self.file.write(",".join(vals) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class Logger:
    """logkv / logkv_mean / dumpkvs (reference train_unet.py:636-655)."""

    def __init__(self, log_dir: Optional[str] = None,
                 stream: Optional[TextIO] = None):
        """`stream` None: the `sys.stdout` of the time of the call."""
        self.name2val: Dict[str, float] = {}
        self.name2cnt: Dict[str, int] = {}
        self.formats = [HumanOutputFormat(stream or sys.stdout)]
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            self.formats.append(
                CSVOutputFormat(os.path.join(log_dir, f"log_{stamp}.csv")))

    def logkv(self, key: str, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key: str, val) -> None:
        oldval = self.name2val.get(key, 0.0)
        cnt = self.name2cnt.get(key, 0)
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> Dict[str, float]:
        out = dict(self.name2val)
        for fmt in self.formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out


class TextLog:
    """The CUDA trainer's minimal printf+append log (reference
    train_unet.cu:4993-4995, :5045-5051): one line per flush, mirrored to
    stdout and an append-mode file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            open(path, "w").close()  # truncate, like fopen(...,"w") at init

    def log(self, line: str) -> None:
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
