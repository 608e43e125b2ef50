"""What every driver uses: the outcome it hands to run.py, the check's
numbers beside their limits, the device's synchronisation and peak, the
set-up's notes, and the Gaussian state as the program reads it (its
checkpoint, its cameras, its scene source).

A driver is `drivers/<kind>.py`; it gets its plain reference from
`cells.reference(cfg)` and passes that module to `ref_cam`, so nothing
here imports a reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import scene as S

# The Gaussian leaves, as the program's checkpoint names them
# (`params.<field>`) and as the plain reference holds them.
PROGRAM_FIELDS = ("means", "scales", "quats", "features_dc", "features_rest",
                  "opacities", "normals")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def note(t_start: float, what: str) -> None:
    """A set-up phase's end on stderr, in seconds since the process
    started."""
    print(f"[{time.perf_counter() - t_start:8.2f} s] {what}", file=sys.stderr,
          flush=True)


def quiet():
    """The program's stdout goes to stderr: the result line is stdout's."""
    return contextlib.redirect_stdout(sys.stderr)


def checkpoint_buffer(state: Dict[str, torch.Tensor], step: int,
                      with_adam: bool) -> io.BytesIO:
    """The state as the program's uncompressed npz checkpoint, in memory:
    params.<field>, alive, step and, for training, Adam's moments,
    accumulators and counts at zero."""
    flat = {f"params.{f}": state[f].cpu().numpy() for f in PROGRAM_FIELDS}
    flat["alive"] = state["alive"].cpu().numpy()
    flat["step"] = np.asarray(step)
    if with_adam:
        for f in PROGRAM_FIELDS:
            z = np.zeros(state[f].shape, np.float32)
            for kind in ("mu", "nu", "accum"):
                flat[f"adam.{kind}.{f}"] = z
            flat[f"adam.count.{f}"] = np.asarray(0, np.int32)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    buf.seek(0)
    return buf


def ref_cam(R, scene: S.Scene, i: int):
    """Frame i's camera as the reference module `R` takes it (`R.Cam`)."""
    it = scene.intr
    return R.Cam(c2w=scene.c2ws[i], fx=it["fx"], fy=it["fy"], cx=it["cx"],
                 cy=it["cy"], width=it["width"], height=it["height"])


def program_cameras(scene: S.Scene, device) -> List:
    from dnsplatter_torch.ops.camera import Camera

    it = scene.intr
    return [Camera.create(it["fx"], it["fy"], it["cx"], it["cy"], c2w,
                          it["width"], it["height"], device=device)
            for c2w in scene.c2ws]


class Frames:
    """The Trainer's scene source: frame i's camera and its targets as
    float32 device tensors."""

    def __init__(self, cams, targets):
        self.cams, self.targets = cams, targets

    def __len__(self) -> int:
        return len(self.cams)

    def get(self, i: int):
        return self.cams[i], self.targets[i]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> List[float]:
    """Each kept leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([ref[f] for f in keep]))
    return [abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30) for f in keep]


@dataclasses.dataclass
class Outcome:
    """What a driver hands to run.py."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak: int
    trace: Optional[Dict] = None
    layer_ctx: Optional[Dict] = None


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """The numbers that the cell's limits name, each beside its limit."""
    return {k: {"value": float(numbers[k]), "limit": float(v)}
            for k, v in limits.items()}
