"""dnsplatter_torch's batch runner against the JAX package's
(tests/test_batch_run.py's cases on the port): command assembly, the slot
pool's bound on concurrency, blocking and stale reclaim, and the race
between two reclaimers that the JAX `_try_reclaim` loses."""

import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dnsplatter_torch.eval import batch_run as tbr
from dnsplatter_tpu.eval import batch_run as jbr


def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def test_command_assembly_matches_jax(tmp_path):
    kw = dict(dataparser="mushroom", depth_lambda=0.5, method="gneusfacto",
              max_iterations=7, extra_flags=["--device", "cpu"])
    got = tbr.ExperimentConfig(**kw).command(tmp_path / "data", "honka",
                                             tmp_path / "out")
    want = jbr.ExperimentConfig(**kw).command(tmp_path / "data", "honka",
                                              tmp_path / "out")
    assert got[:3] == [sys.executable, "-m", "dnsplatter_torch.cli"]
    assert want[2] == "dnsplatter_tpu.cli" and got[3:] == want[3:]
    assert got[-2:] == ["--device", "cpu"]
    assert tbr.DATASET_SCENES == jbr.DATASET_SCENES
    assert dataclasses_equal(tbr.ExperimentConfig(), jbr.ExperimentConfig())


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_device_slot_dispatch_bounds_concurrency(tmp_path, monkeypatch):
    """4 jobs over 2 slots: at no instant do more than 2 run, every job
    gets a pinned slot while it runs, all finish, the pool drains. The pool
    polls every 0.05 s rather than its default 5 s."""
    monkeypatch.setattr(tbr, "DeviceSlots",
                        functools.partial(tbr.DeviceSlots, poll_s=0.05))
    out_root = tmp_path / "out"
    script = tmp_path / "job.py"
    script.write_text(
        "import json, os, sys, time\n"
        "t0 = time.time(); time.sleep(0.3)\n"
        "json.dump({'t0': t0, 't1': time.time(),\n"
        "           'slot': os.environ.get('DNSPLATTER_DEVICE_SLOT'),\n"
        "           'cuda': os.environ.get('CUDA_VISIBLE_DEVICES')},\n"
        "          open(sys.argv[1], 'w'))\n")

    class FakeCfg:
        def command(self, data_root, scene, out_root):
            return [sys.executable, str(script),
                    str(out_root / scene / "span.json")]

    scenes = [f"s{i}" for i in range(4)]
    results = tbr.dispatch_jobs(FakeCfg(), tmp_path / "d", out_root, scenes,
                                jobs=4, device_slots=2)
    assert results == dict.fromkeys(scenes, 0)
    assert json.loads((out_root / "batch_results.json").read_text()) \
        == results
    spans = [json.load(open(out_root / s / "span.json")) for s in scenes]
    for s in spans:
        assert sum(o["t0"] < s["t1"] and o["t1"] > s["t0"]
                   for o in spans) <= 2, spans
        assert s["slot"] in {"0", "1"} and s["cuda"] == s["slot"]
    assert not list((out_root / ".slots").glob("*.lock"))


def test_slot_pool_blocks_until_release(tmp_path):
    slots = tbr.DeviceSlots(tmp_path, 1, poll_s=0.05)
    assert slots.acquire() == 0
    got = {}
    th = threading.Thread(target=lambda: got.setdefault("i",
                                                        slots.acquire()))
    t0 = time.time()
    th.start()
    time.sleep(0.2)
    assert "i" not in got  # still blocked
    slots.release(0)
    th.join(timeout=5)
    assert not th.is_alive() and got["i"] == 0
    assert time.time() - t0 >= 0.2
    slots.release(0)


@pytest.mark.parametrize("content,reclaimed", [
    ("dead", True), ("self", False), ("", False), ("junk", False)])
def test_reclaim_only_a_dead_owner(tmp_path, content, reclaimed):
    """A dead pid is reclaimed (and acquire takes the slot at once); a live,
    empty (created by acquire but not yet written) or unreadable one
    stays."""
    text = {"dead": str(_dead_pid()), "self": str(os.getpid())}.get(
        content, content)
    lock = tmp_path / "slot0.lock"
    lock.write_text(text)
    slots = tbr.DeviceSlots(tmp_path, 1, poll_s=0.05)
    assert slots._try_reclaim(0) is reclaimed
    assert lock.exists() is not reclaimed
    if reclaimed:
        lock.write_text(text)
        t0 = time.time()
        assert slots.acquire() == 0 and time.time() - t0 < 5.0
        assert lock.read_text() == str(os.getpid())


def _race(slots_cls, tmp_path, monkeypatch):
    """Reclaimer A reads the stale pid; at that moment reclaimer B (a
    thread, given a second to run) reclaims the slot and acquires it. Then
    A goes on. Returns whether B's live lock survived."""
    lock = tmp_path / "slot0.lock"
    lock.write_text(str(_dead_pid()))
    a = slots_cls(tmp_path, 1, poll_s=0.01)
    b = slots_cls(tmp_path, 1, poll_s=0.01)
    main = threading.current_thread()
    read_text = Path.read_text
    got, fired = [], []
    th = threading.Thread(target=lambda: got.append(b.acquire()))

    def racing_read(self, *args, **kw):
        out = read_text(self, *args, **kw)
        if (self.name == "slot0.lock" and not fired
                and threading.current_thread() is main):
            fired.append(True)
            th.start()
            th.join(timeout=1.0)
        return out

    monkeypatch.setattr(Path, "read_text", racing_read)
    a._try_reclaim(0)
    th.join(timeout=10)
    assert not th.is_alive() and got == [0]
    return lock.exists() and read_text(lock) == str(os.getpid())


def test_reclaim_race_keeps_the_live_lock(tmp_path, monkeypatch):
    assert _race(tbr.DeviceSlots, tmp_path, monkeypatch)


def test_reclaim_race_deletes_the_live_lock_in_the_jax_package(
        tmp_path, monkeypatch):
    """The same interleaving against the JAX `_try_reclaim`: it unlinks
    the lock B now holds (the fault the port's guard removes)."""
    assert not _race(jbr.DeviceSlots, tmp_path, monkeypatch)
