"""Time hand-written kernels against another version of their sources, on
the GPU, in turns, at the inputs of the main path.

    python -m dnsplatter_torch.scripts.ab_tile_kernels --baseline DIR \
        [--kernels expand_segments reduce_segments_bykey ...] \
        [--cumsum-tile LANES]

DIR holds an earlier design's sources of the kernels named (default: the
two tile kernels, `expand_segments` and `reduce_segments_bykey`; also
`cumsum_lanes_i32` and `reduce_segments`), for example a parent commit's
`dnsplatter_torch/csrc`, unpacked with `git archive`: the same C entries
as the current ones (`rasterize_cuda._ENTRIES` types both), or an earlier
entry of `BASELINE_ARGTYPES`, told apart by its parameter list (the
one-thread-per-id reduction by key takes no ids per CTA; the three-kernel
prefix sum takes a table of tile totals). DIR may as well hold a variant
of the current design, to time a choice (a tile or block size): a
look-back prefix sum with other tiles than the current one's names their
lanes with `--cumsum-tile`, which sizes its scratch. Both versions are
compiled with nvcc and the flags of `kernel_build`; each ptxas report
(registers, shared memory) and the resident CTAs per SM it allows are
printed. The current version is called through its wrappers (the
backward's time includes the tile order the wrapper sorts, the prefix
sum's the zeroing of its scratch), the baseline through the same
allocation and arguments.
Inputs are captured from chip_smoke.py's scenes: a served frame (camera 0)
at 100k and 1M Gaussians (the expansion and the forward), one training
step (after `--train-steps` steps of `Trainer.train` at the Trainer's
defaults) at 100k and 1M seeds (all four), a served frame of the 2^24
scene (the prefix sum's table) and a `segsum` step on the 100k state after
chip_smoke's 63 steps with refinement (the float32 slab of
`reduce_segments`). At each, every kernel is timed baseline, current,
current, baseline (chip_smoke's `device_ms`: device time per call from a
batch behind a spin kernel). The two versions' outputs are compared
(forward: bit-equal or not, pixels whose `last` differs, the largest
image difference; backward: chip_smoke's `compare_backward`; expansion
and prefix sum: bit-equal, the prefix sum to its plain version too;
reductions: `compare_reduce`, bit-equal or not, and two runs of the
current version bit-equal). Prints one JSON line per (scene, kernel).
Runs only on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

KERNELS = ("forward_tiles", "backward_tiles", "expand_segments",
           "reduce_segments_bykey", "cumsum_lanes_i32", "reduce_segments")
# the kernels of a default training step (the default set), and of a
# served frame
STEP_KERNELS = KERNELS[:4]
SERVE_KERNELS = ("forward_tiles", "expand_segments")
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Earlier C entries that the current ones replace: {kernel: argument types}.
BASELINE_ARGTYPES = {
    # one thread per id, no ids per CTA
    "reduce_segments_bykey": [_VP, _LL, _I, _I, _I, _VP, _LL, _VP],
    # three kernels: (x, out, totals, totals_per_row, rows, c, stream)
    "cumsum_lanes_i32": [_VP, _VP, _VP, _I, _I, _LL, _VP],
}
# The CUDA function of each kernel, as it appears in the mangled names.
ENTRY_NAMES = {"forward_tiles": "forward_tiles_kernel",
               "backward_tiles": "backward_tiles_kernel",
               "expand_segments": "expand_segments_kernel",
               "reduce_segments_bykey": "reduce_bykey_kernel",
               "cumsum_lanes_i32": "scan_tiles",
               "reduce_segments": "reduce_segments_kernel"}
# H100: per SM 65,536 registers (allocated 256 a warp), 2,048 threads,
# 32 CTAs, 228 KB of shared memory with 1 KB reserved per CTA.
SM_REGS, SM_THREADS, SM_CTAS = 65536, 2048, 32
SM_SMEM, CTA_SMEM_RESERVED = 233472, 1024


def parse_ptxas(log: str) -> dict:
    """{mangled entry: {"registers": r, "smem": bytes}} from `-Xptxas -v`
    output."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = {"registers": int(m.group(1)),
                          "smem": int(smem.group(1)) if smem else 0}
    return out


def resident_ctas(registers: int, smem: int, threads: int) -> int:
    """CTAs of one kernel that fit on one SM at once, from its ptxas
    figures: the least of the thread, CTA, register and shared-memory
    limits."""
    warps = -(-threads // 32)
    regs_per_warp = -(-registers * 32 // 256) * 256
    by_regs = (SM_REGS // regs_per_warp) // warps if regs_per_warp else \
        SM_CTAS
    by_smem = SM_SMEM // (smem + CTA_SMEM_RESERVED)
    return min(SM_THREADS // threads, SM_CTAS, by_regs, by_smem)


def _compile(src: Path, out: Path) -> str:
    from dnsplatter_torch.ops import kernel_build

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS,
           "-I", str(kernel_build.CSRC_DIR), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def c_entry_params(src: str, symbol: str) -> tuple:
    """The parameter types of C entry `symbol` in source text `src`, names
    dropped and spaces normalised: ("const void*", "long long", ...)."""
    m = re.search(rf"\b{symbol}\s*\(([^)]*)\)", src)
    if m is None:
        raise RuntimeError(f"no C entry {symbol} in the baseline source")
    types = []
    for param in m.group(1).split(","):
        words = param.replace("*", "* ").split()
        types.append(" ".join(words[:-1]).replace(" *", "*"))
    return tuple(types)



def _call_baseline(fn, name: str, a, cumsum_tile: int):
    """The baseline's C entry on the wrapper's outputs and arguments
    (`cumsum_tile`: lanes per tile of a baseline prefix sum with the
    current entry, which sizes its scratch)."""
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc

    if name == "expand_segments":
        vals, starts, out_len = a
        out = torch.empty((vals.shape[0], out_len), dtype=vals.dtype,
                          device=vals.device)
        rc._check_rc(fn(vals.data_ptr(), starts.data_ptr(), out.data_ptr(),
                        vals.shape[0], vals.shape[1], out_len, rc._stream()),
                     name)
        return out
    if name == "reduce_segments_bykey":
        slab, ru, n = a
        out = torch.empty((2 * ru + 2, n), device=slab.device)
        args = [slab.data_ptr(), slab.stride(0), slab.shape[1], ru, n,
                out.data_ptr(), out.stride(0)]
        if fn.argtypes == rc._ENTRIES[name][2]:  # chooses ids
            args.append(rc.bykey_ids_per_cta(
                n, rc._bykey_slots(slab.device, ru)))
        rc._check_rc(fn(*args, rc._stream()), name)
        return out
    if name == "reduce_segments":
        grads, starts, n = a
        gw = grads.shape[0]
        out = torch.empty((gw, n), device=grads.device)
        rc._check_rc(fn(grads.data_ptr(), grads.stride(0), grads.shape[1],
                        starts.data_ptr(), gw, n, out.data_ptr(),
                        out.stride(0), rc._stream()), name)
        return out
    if name == "cumsum_lanes_i32":
        (x,) = a
        if fn.argtypes == rc._ENTRIES[name][2]:
            return _call_cumsum_entry(fn, x, cumsum_tile)
        rows, c = x.shape
        out = torch.empty_like(x)
        tiles = -(-c // 2048)
        totals = torch.empty((rows, tiles), dtype=torch.int32,
                             device=x.device)
        rc._check_rc(fn(x.data_ptr(), out.data_ptr(), totals.data_ptr(),
                        tiles, rows, c, rc._stream()), name)
        return out
    payload, starts, counts = a[:3]
    dev = payload.device
    if name == "forward_tiles":
        n_tiles, f, tile, tiles_x = a[3:7]
        p = tile * tile
        out = torch.empty((n_tiles, f, p), device=dev)
        tf = torch.empty((n_tiles, 1, p), device=dev)
        la = torch.empty((n_tiles, 1, p), dtype=torch.int32, device=dev)
        rc._check_rc(fn(payload.data_ptr(), payload.stride(0),
                        starts.data_ptr(), counts.data_ptr(), n_tiles, f,
                        tile, tiles_x, out.data_ptr(), tf.data_ptr(),
                        la.data_ptr(), rc._stream()), name)
        return out, tf, la
    g_out, g_alpha, t_final, last, n_tiles, f, tile, tiles_x = a[3:11]
    slab = torch.zeros((8, payload.shape[1]), dtype=torch.int32, device=dev)
    order = rc.deepest_first(last, n_tiles)
    rc._check_rc(fn(payload.data_ptr(), payload.stride(0), starts.data_ptr(),
                    counts.data_ptr(), n_tiles, f, tile, tiles_x,
                    g_out.data_ptr(), g_alpha.data_ptr(), t_final.data_ptr(),
                    last.data_ptr(), order.data_ptr(), slab.data_ptr(),
                    slab.stride(0), 1, rc._stream()), name)
    return slab


def _call_cumsum_entry(fn, x, tile: int):
    """A prefix-sum C entry of the current signature, with the wrapper's
    allocation for tiles of `tile` lanes."""
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc

    rows, c = x.shape
    out = torch.empty_like(x)
    words = rc.cumsum_scratch_words(rows, c, x.data_ptr() % 16 == 0
                                    and c % 4 == 0, tile)
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    rc._check_rc(fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), words,
                    rows, c, rc._stream()), "cumsum_lanes_i32")
    return out


def _call_current(name: str, a):
    from dnsplatter_torch.ops import rasterize_cuda as rc

    if name == "expand_segments":
        return rc._expand_launch(*a, out_dtype=a[0].dtype)
    if name == "backward_tiles":
        return rc.backward_tiles(*a, pack_grads=True)
    return getattr(rc, name)(*a)


def _agreement(name: str, base, cur, a) -> dict:
    """How the two versions' outputs compare; raises where chip_smoke's
    checks would."""
    import torch

    import chip_smoke as cs
    from dnsplatter_torch.ops import rasterize_cuda as rc

    if name == "forward_tiles":
        return {"bit_equal": all(torch.equal(x, y) for x, y in zip(base, cur)),
                "last_differs": int((base[2] != cur[2]).sum()),
                "max_abs_diff": float((base[0] - cur[0]).abs().max())}
    if name == "backward_tiles":
        agree = cs.compare_backward(cur, base, a[8])
        agree.pop("row_max")
        return agree
    if name in ("expand_segments", "cumsum_lanes_i32"):
        if not torch.equal(base, cur):
            raise AssertionError(f"{name}: {int((base != cur).sum())} words "
                                 "differ between the versions")
        if name == "cumsum_lanes_i32" and not torch.equal(
                cur, rc.cumsum_lanes_i32_plain(*a)):
            raise AssertionError("cumsum_lanes_i32 differs from its plain "
                                 "version")
        return {"bit_equal": True}
    if not torch.equal(cur, _call_current(name, a)):
        raise AssertionError(f"{name}: two runs of the current version "
                             "differ")
    return {**cs.compare_reduce(cur, base, name),
            "bit_equal": torch.equal(base, cur), "runs_bit_equal": True}


# The mangled template arguments of the instance the main path runs, the
# first of each tuple that the ptxas report holds: the tile kernels at tile
# 16 and F = 7 (the backward packed, at four pixels a thread), the
# reduction by key at RU = 7 (in the id-block design its 512-id block, the
# 1M step's; the design with one thread per id has one instance per RU),
# `reduce_segments` at GW = 15 (the 100k segsum step); the
# expansion and the prefix sum's scan are no templates.
TAGS = {("baseline", "forward_tiles"): ("ILi7EE",),
        ("baseline", "backward_tiles"): ("ILi7ELb1ELi4EE",),
        ("baseline", "expand_segments"): ("E",),
        ("baseline", "reduce_segments_bykey"): ("ILi7ELi512EE", "ILi7EE"),
        ("current", "forward_tiles"): ("ILi7EE",),
        ("current", "backward_tiles"): ("ILi7ELb1ELi4EE",),
        ("current", "expand_segments"): ("E",),
        ("current", "reduce_segments_bykey"): ("ILi7ELi512EE",),
        ("baseline", "cumsum_lanes_i32"): ("E",),
        ("current", "cumsum_lanes_i32"): ("E",),
        ("baseline", "reduce_segments"): ("ILi15EE",),
        ("current", "reduce_segments"): ("ILi15EE",)}
# Threads per CTA of those instances, for the residency figure (the
# current designs'; a baseline of the same design has the same).
THREADS = {"forward_tiles": 256, "backward_tiles": 64,
           "expand_segments": 256, "reduce_segments_bykey": 128,
           "cumsum_lanes_i32": 256, "reduce_segments": 128}
REPS = {"forward_tiles": 50, "backward_tiles": 20, "expand_segments": 50,
        "reduce_segments_bykey": 20, "cumsum_lanes_i32": 20,
        "reduce_segments": 20}


def _report(name: str, log: str, threads: int, tags) -> dict:
    """The ptxas figures of the kernel instance the first of `tags` (a
    tuple of mangled template arguments, or one) that the report holds
    names."""
    figures = parse_ptxas(log)
    for tag in (tags,) if isinstance(tags, str) else tags:
        for entry, fig in figures.items():
            if f"{ENTRY_NAMES[name]}{tag}" in entry:
                return {**fig, "threads": threads,
                        "resident_ctas": resident_ctas(fig["registers"],
                                                       fig["smem"], threads)}
    raise RuntimeError(f"no {tags} entry of {name} in the ptxas report")


def capture(dev, train_steps: int, kernels):
    """[(scene, {kernel: args})] for the scenes the kernels named run on:
    a served frame's expansion and forward (100k, 1m), a training step's
    four kernels (100k, 1m), the 2^24 frame's prefix sum, the 100k segsum
    step's reduction."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import Trainer

    def spies(names):
        stack = contextlib.ExitStack()
        mocks = {k: stack.enter_context(mock.patch.object(
            rc, k, wraps=getattr(rc, k))) for k in names}
        return stack, mocks

    def served_frame(served, alive, cam, cfg, names):
        stack, mocks = spies(names)
        with torch.no_grad(), stack:
            get_outputs(served, alive, cam, ModelConfig(), cfg, sh_degree=3,
                        background=torch.zeros(3, device=dev))
        return {k: m.call_args.args for k, m in mocks.items()}

    out = []
    if set(kernels) & set(SERVE_KERNELS):
        for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
            _, served, alive, cams = cs.make_scene(n, shift, extent, seed,
                                                   dev)
            out.append((name, served_frame(
                served, alive, cams[0],
                eval_raster_config(cs.WIDTH, cs.HEIGHT, cap),
                SERVE_KERNELS)))
    if set(kernels) & set(STEP_KERNELS):
        for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
            inputs = cs.training_inputs(n, shift, extent, cap, seed, dev, {})
            with contextlib.redirect_stdout(sys.stderr):
                trainer = Trainer(inputs["data"], inputs["seeds"],
                                  model_cfg=inputs["model_cfg"])
                trainer.train(train_steps, log_every=1 << 30)
                stack, mocks = spies(STEP_KERNELS)
                with stack:
                    trainer.train(1, log_every=1 << 30)
            out.append((f"train_{name}",
                        {k: m.call_args.args for k, m in mocks.items()}))
            del trainer, inputs
            torch.cuda.empty_cache()
    if "cumsum_lanes_i32" in kernels:
        _, served, alive, cams, cfg = cs.make_big_scene(dev)
        out.append(("2p24", served_frame(served, alive, cams[0], cfg,
                                         ("cumsum_lanes_i32",))))
        del served, alive
        torch.cuda.empty_cache()
    if "reduce_segments" in kernels:
        name, n, shift, extent, cap = cs.SCENES[0]
        inputs = cs.training_inputs(n, shift, extent, cap, 0, dev,
                                    cs.REFINE_KW)
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(inputs["data"], inputs["seeds"],
                              model_cfg=inputs["model_cfg"])
            trainer.train(cs.TRAIN_WARMUP + cs.TRAIN_STEPS_100K,
                          log_every=1 << 30)
        rcfg = dataclasses.replace(trainer._raster_cfg(inputs["cams"][0]),
                                   sort_scheme="packed",
                                   grad_reduce="segsum")
        stack, mocks = spies(("reduce_segments",))
        with stack:
            cs.step_with(trainer, rcfg)
        out.append((f"train_{name}_segsum",
                    {k: m.call_args.args for k, m in mocks.items()}))
        del trainer, inputs
        torch.cuda.empty_cache()
    return out


def _size(name: str, a) -> dict:
    """The figures that say how big a call is."""
    if name == "expand_segments":
        return {"rows": int(a[0].shape[0]), "segments": int(a[0].shape[1]),
                "out_len": int(a[2]), "used": int(a[1][-1])}
    if name == "reduce_segments_bykey":
        return {"lanes": int(a[0].shape[1]), "ids": int(a[2]), "ru": a[1]}
    if name == "cumsum_lanes_i32":
        return {"rows": int(a[0].shape[0]), "lanes": int(a[0].shape[1])}
    if name == "reduce_segments":
        grads, starts, n = a
        return {"gw": int(grads.shape[0]), "slab_lanes": int(grads.shape[1]),
                "lanes": int(starts[-1] - starts[0]), "ids": n}
    return {"pairs": int(a[1][a[3 if name == "forward_tiles" else 7]])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=STEP_KERNELS)
    ap.add_argument("--train-steps", type=int, default=23)
    ap.add_argument("--cumsum-tile", type=int, default=None,
                    help="lanes per tile of a baseline look-back prefix "
                    "sum (its scratch holds a status word a tile; default "
                    "the current kernel's)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_tile_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dnsplatter_torch.ops import kernel_build
    from dnsplatter_torch.ops import rasterize_cuda as rc

    if args.cumsum_tile is None:
        args.cumsum_tile = rc.CUMSUM_TILE
    gpu = cs.gpu_name_and_power()
    print(gpu, flush=True)
    build = kernel_build.BUILD_DIR / "ab"
    fns, figures = {}, {}
    for version, root in (("baseline", args.baseline),
                          ("current", kernel_build.CSRC_DIR)):
        for name in args.kernels:
            lib_path = build / f"lib{name}-{version}.so"
            log = _compile(root / f"{name}.cu", lib_path)
            figures[(version, name)] = _report(name, log, THREADS[name],
                                               TAGS[(version, name)])
            if version == "baseline":
                _, sym, argtypes = rc._ENTRIES[name]
                params = c_entry_params((root / f"{name}.cu").read_text(),
                                        sym)
                if params != c_entry_params(
                        (kernel_build.CSRC_DIR / f"{name}.cu").read_text(),
                        sym):
                    argtypes = BASELINE_ARGTYPES[name]
                fn = getattr(ctypes.CDLL(str(lib_path)), sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
    for (version, name), fig in figures.items():
        print(json.dumps({"ptxas": name, "version": version, **fig}),
              flush=True)

    def call(version, name, a):
        if version == "current":
            return _call_current(name, a)
        return _call_baseline(fns[name], name, a, args.cumsum_tile)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scenes = capture(dev, args.train_steps, args.kernels)
    print(json.dumps({"capture_seconds": time.perf_counter() - t0}),
          flush=True)
    for scene, calls in scenes:
        for name in args.kernels:
            a = calls.get(name)
            if a is None:
                continue
            base = call("baseline", name, a)
            cur = call("current", name, a)
            torch.cuda.synchronize()
            agree = _agreement(name, base, cur, a)
            del base, cur
            times = {"baseline": [], "current": []}
            for version in ("baseline", "current", "current", "baseline"):
                times[version].append(cs.device_ms(
                    lambda v=version: call(v, name, a), REPS[name]))
            b_ms, c_ms = (min(times[v]) for v in ("baseline", "current"))
            print(json.dumps({
                "scene": scene, "kernel": name, "baseline_ms": times[
                    "baseline"], "current_ms": times["current"],
                "speedup": b_ms / c_ms, "agreement": agree,
                **_size(name, a), "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
