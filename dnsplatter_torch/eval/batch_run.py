"""Batch experiment runner: dataset sweeps over scenes and flag configs
(counterpart of dnsplatter_tpu/eval/batch_run.py).

Composes per-scene training command lines (`python -m dnsplatter_torch.cli
train ...`; `--device` and other flags go through `extra_flags`) and
dispatches them to free accelerators, as the reference's GPUtil polling
does. `--device-slots N` is that polling's equivalent: a lockfile slot pool
dispatches each job as a slot frees up and pins it via
CUDA_VISIBLE_DEVICES / DNSPLATTER_DEVICE_SLOT, file-based so that it also
coordinates processes sharing a filesystem. `--jobs N` alone runs N jobs at
once; the default stays sequential.

A slot held by a process that died is reclaimed. The JAX package's reclaim
read the owner's pid, checked it was dead and unlinked, unguarded: another
process could reclaim and re-acquire the slot between the read and the
unlink, which then deleted a live lock. Here the read, the check and the
unlink run under an exclusive `flock` on `reclaim.guard` in the slot root,
and the pid is read again just before the unlink.
"""

from __future__ import annotations

import argparse
import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

DATASET_SCENES: Dict[str, List[str]] = {
    # the reference's scene lists
    "mushroom": ["coffee_room", "honka", "kokko", "sauna", "activity",
                 "classroom"],
    "replica": ["office0", "office1", "office2", "office3", "office4",
                "room0", "room1", "room2"],
    "scannetpp": ["8b5caf3398", "b20a261fdf"],
}


@dataclasses.dataclass
class ExperimentConfig:
    """Flag bundle swept over scenes (the reference's batch_run.py)."""

    method: str = "dn-splatter"
    dataparser: str = "mushroom"
    use_depth_loss: bool = True
    depth_lambda: float = 0.2
    use_normal_loss: bool = True
    normal_lambda: float = 0.1
    normal_supervision: str = "mono"
    max_iterations: int = 30000
    extra_flags: Optional[List[str]] = None

    def command(self, data_root: Path, scene: str,
                out_root: Path) -> List[str]:
        cmd = [
            sys.executable, "-m", "dnsplatter_torch.cli", "train",
            self.method, self.dataparser,
            "--data", str(data_root / scene),
            "--output-dir", str(out_root / scene),
            "--max-iterations", str(self.max_iterations),
            "--model.use-depth-loss", str(self.use_depth_loss),
            "--model.depth-lambda", str(self.depth_lambda),
            "--model.use-normal-loss", str(self.use_normal_loss),
            "--model.normal-lambda", str(self.normal_lambda),
            "--model.normal-supervision", self.normal_supervision,
        ]
        if self.extra_flags:
            cmd += self.extra_flags
        return cmd


class DeviceSlots:
    """Accelerator-availability dispatch: slot occupancy is atomic lockfiles
    under `root` (O_CREAT|O_EXCL acquire writing the owner's pid, unlink
    release), which works across processes and hosts sharing a filesystem.
    The acquired slot index is exported to the job via CUDA_VISIBLE_DEVICES
    and DNSPLATTER_DEVICE_SLOT."""

    def __init__(self, root: Path, n_slots: int, poll_s: float = 5.0):
        self.root = root
        self.n = n_slots
        self.poll_s = poll_s
        root.mkdir(parents=True, exist_ok=True)

    def _owner(self, path: Path) -> int:
        """The pid recorded in a lockfile; 0 when it is empty (created by
        `acquire` but not yet written), unreadable or gone."""
        try:
            return int(path.read_text().strip() or "0")
        except (OSError, ValueError):
            return 0

    def _try_reclaim(self, i: int) -> bool:
        """Reclaim a slot whose recorded owner pid is gone (a hard crash or
        SIGKILL leaves the lockfile behind otherwise). Same-host only: a
        lockfile with an empty, unreadable or live pid stays. Reclaims are
        serialized by a flock on `reclaim.guard`, and the pid is read again
        before the unlink. Returns True if the stale lock was removed."""
        path = self.root / f"slot{i}.lock"
        with open(self.root / "reclaim.guard", "a") as guard:
            fcntl.flock(guard, fcntl.LOCK_EX)
            pid = self._owner(path)
            if pid <= 0:
                return False
            try:
                os.kill(pid, 0)
                return False  # owner alive
            except ProcessLookupError:
                pass  # owner gone: stale
            except PermissionError:
                return False  # alive under another uid
            if self._owner(path) != pid:
                return False
            try:
                path.unlink()
            except FileNotFoundError:
                return False
        print(f"device-slots: reclaimed slot {i} from dead pid {pid}",
              flush=True)
        return True

    def acquire(self) -> int:
        waited = 0.0
        while True:
            for i in range(self.n):
                try:
                    fd = os.open(self.root / f"slot{i}.lock",
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.write(fd, str(os.getpid()).encode())
                    os.close(fd)
                    return i
                except FileExistsError:
                    if self._try_reclaim(i):
                        continue  # the next pass picks it up
            time.sleep(self.poll_s)
            waited += self.poll_s
            if waited % 60.0 < self.poll_s:
                # name the blockers instead of hanging silently
                holders = [
                    f"slot{i}=pid {self._owner(self.root / f'slot{i}.lock')}"
                    for i in range(self.n)]
                print(f"device-slots: waiting {waited:.0f}s for a free "
                      f"slot under {self.root} ({', '.join(holders)}); "
                      f"delete stale *.lock files to force-release",
                      flush=True)

    def release(self, i: int) -> None:
        try:
            (self.root / f"slot{i}.lock").unlink()
        except FileNotFoundError:
            pass


def run_scene(cmd: List[str], log_path: Path,
              slots: Optional[DeviceSlots] = None) -> int:
    log_path.parent.mkdir(parents=True, exist_ok=True)
    slot = slots.acquire() if slots is not None else None
    env = None
    if slot is not None:
        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = str(slot)
        env["DNSPLATTER_DEVICE_SLOT"] = str(slot)
    try:
        with open(log_path, "w") as log:
            proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  env=env)
        return proc.returncode
    finally:
        if slot is not None:
            slots.release(slot)


def dispatch_jobs(cfg: ExperimentConfig, data_root: Path, out_root: Path,
                  scenes: List[str], jobs: int = 1,
                  device_slots: int = 0) -> Dict[str, int]:
    results: Dict[str, int] = {}
    slots = (DeviceSlots(out_root / ".slots", device_slots)
             if device_slots > 0 else None)
    if slots is not None and jobs <= 1:
        jobs = device_slots  # availability dispatch implies concurrency
    if jobs <= 1:
        for scene in scenes:
            print(f"[batch_run] {scene} ...", flush=True)
            results[scene] = run_scene(
                cfg.command(data_root, scene, out_root),
                out_root / scene / "train.log",
                slots,
            )
    else:
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futs = {
                scene: ex.submit(
                    run_scene,
                    cfg.command(data_root, scene, out_root),
                    out_root / scene / "train.log",
                    slots,
                )
                for scene in scenes
            }
            for scene, fut in futs.items():
                results[scene] = fut.result()
    (out_root / "batch_results.json").write_text(json.dumps(results, indent=2))
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=sorted(DATASET_SCENES),
                   default="mushroom")
    p.add_argument("--data-root", type=Path, required=True)
    p.add_argument("--output-root", type=Path, default=Path("runs/batch"))
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--method", default="dn-splatter")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--device-slots", type=int, default=0,
                   help="dispatch jobs to N accelerator slots as they free "
                        "up (lockfile pool; pins CUDA_VISIBLE_DEVICES per "
                        "job)")
    p.add_argument("--max-iterations", type=int, default=30000)
    args = p.parse_args(argv)

    cfg = ExperimentConfig(
        method=args.method, dataparser=args.dataset,
        max_iterations=args.max_iterations,
    )
    scenes = args.scenes or DATASET_SCENES[args.dataset]
    results = dispatch_jobs(cfg, args.data_root, args.output_root, scenes,
                            args.jobs, device_slots=args.device_slots)
    bad = {s: c for s, c in results.items() if c != 0}
    print(f"done: {len(results) - len(bad)} ok, {len(bad)} failed {bad}")


if __name__ == "__main__":
    main()
