"""The JSONL history writer of the Trainer (the port's own small copy of
`JsonlWriter` in dnsplatter_tpu/utils/writers.py; the TensorBoard writer
comes with the CLI)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np


class JsonlWriter:
    """One json object per logged step (metrics.jsonl)."""

    def __init__(self, log_dir: Path, name: str = "metrics.jsonl"):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / name
        self._f = open(self.path, "a")

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": step}
        row.update({
            k: (float(v)
                if isinstance(v, (int, float, np.floating, np.integer))
                else v)
            for k, v in scalars.items()
        })
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
