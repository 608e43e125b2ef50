"""Time hand-written kernels against another version of their sources, on
the GPU, in turns, at the inputs of the main path.

    python -m dnsplatter_torch.scripts.ab_tile_kernels --baseline DIR \
        [--kernels expand_segments reduce_segments_bykey]

DIR holds an earlier design's sources of the kernels named (default: the
two tile kernels, `expand_segments` and `reduce_segments_bykey`), for
example a parent commit's `dnsplatter_torch/csrc`, unpacked with `git
archive`: the same C entries as the current ones (`rasterize_cuda._ENTRIES`
types both), or, for `reduce_segments_bykey`, the entry of the design
with one thread per id, which takes no ids per CTA (told apart by its
parameter count). Both versions are compiled with nvcc and the flags of
`kernel_build`; each ptxas report (registers, shared memory) and the
resident CTAs per SM it allows are printed. The current version is called
through its wrappers (the backward's time includes the tile order the
wrapper sorts), the baseline through the same allocation and arguments.
Inputs are captured from chip_smoke.py's scenes: a served frame (camera 0)
at 100k and 1M Gaussians (the expansion and the forward), and one training
step (after `--train-steps` steps of `Trainer.train` at the Trainer's
defaults) at 100k and 1M seeds (all four). At each, every kernel is timed
baseline, current, current, baseline (chip_smoke's `device_ms`: device time
per call from a batch behind a spin kernel), and the two versions' outputs
are compared (forward: bit-equal or not, pixels whose `last` differs, the
largest image difference; backward: chip_smoke's `compare_backward`;
expansion: bit-equal; reduction: `compare_reduce` and bit-equal or not).
Prints one JSON line per (scene, kernel). Runs only on the card.
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
           "reduce_segments_bykey")
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Earlier C entries that the current ones extend: {kernel: argument types}.
BASELINE_ARGTYPES = {
    "reduce_segments_bykey": [_VP, _LL, _I, _I, _I, _VP, _LL, _VP],
}
# The CUDA function of each kernel, as it appears in the mangled names.
ENTRY_NAMES = {"forward_tiles": "forward_tiles_kernel",
               "backward_tiles": "backward_tiles_kernel",
               "expand_segments": "expand_segments_kernel",
               "reduce_segments_bykey": "reduce_bykey_kernel"}
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


def c_entry_arity(src: str, symbol: str) -> int:
    """The number of parameters of C entry `symbol` in source text `src`."""
    m = re.search(rf"\b{symbol}\s*\(([^)]*)\)", src)
    if m is None:
        raise RuntimeError(f"no C entry {symbol} in the baseline source")
    return len(m.group(1).split(","))


def _call_baseline(fn, name: str, a):
    """The baseline's C entry on the wrapper's outputs and arguments."""
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
        if len(fn.argtypes) == len(rc._ENTRIES[name][2]):  # chooses ids
            args.append(rc.bykey_ids_per_cta(
                n, rc._bykey_slots(slab.device, ru)))
        rc._check_rc(fn(*args, rc._stream()), name)
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

    if name == "forward_tiles":
        return {"bit_equal": all(torch.equal(x, y) for x, y in zip(base, cur)),
                "last_differs": int((base[2] != cur[2]).sum()),
                "max_abs_diff": float((base[0] - cur[0]).abs().max())}
    if name == "backward_tiles":
        agree = cs.compare_backward(cur, base, a[8])
        agree.pop("row_max")
        return agree
    if name == "expand_segments":
        if not torch.equal(base, cur):
            raise AssertionError(f"expand_segments: {int((base != cur).sum())}"
                                 " words differ between the versions")
        return {"bit_equal": True}
    return {**cs.compare_reduce(cur, base), "bit_equal": torch.equal(base,
                                                                      cur)}


# The mangled template arguments of the instance the main path runs, the
# first of each tuple that the ptxas report holds: the tile kernels at tile
# 16 and F = 7 (the backward packed, at four pixels a thread), the
# reduction at RU = 7 (in the id-block design its 512-id block, the 1M
# step's; the design with one thread per id has one instance per RU); the
# expansion is no template.
TAGS = {("baseline", "forward_tiles"): ("ILi7EE",),
        ("baseline", "backward_tiles"): ("ILi7ELb1ELi4EE",),
        ("baseline", "expand_segments"): ("E",),
        ("baseline", "reduce_segments_bykey"): ("ILi7ELi512EE", "ILi7EE"),
        ("current", "forward_tiles"): ("ILi7EE",),
        ("current", "backward_tiles"): ("ILi7ELb1ELi4EE",),
        ("current", "expand_segments"): ("E",),
        ("current", "reduce_segments_bykey"): ("ILi7ELi512EE",)}
# Threads per CTA of those instances, for the residency figure (the
# current designs'; a baseline of the same design has the same).
THREADS = {"forward_tiles": 256, "backward_tiles": 64,
           "expand_segments": 256, "reduce_segments_bykey": 128}
REPS = {"forward_tiles": 50, "backward_tiles": 20, "expand_segments": 50,
        "reduce_segments_bykey": 20}


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


def capture(dev, train_steps: int):
    """[(scene, {kernel: args})] for the four scenes: a served frame's
    expansion and forward, a training step's four kernels."""
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

    out = []
    for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
        _, served, alive, cams = cs.make_scene(n, shift, extent, seed, dev)
        cfg = eval_raster_config(cs.WIDTH, cs.HEIGHT, cap)
        stack, mocks = spies(("expand_segments", "forward_tiles"))
        with torch.no_grad(), stack:
            get_outputs(served, alive, cams[0], ModelConfig(), cfg,
                        sh_degree=3, background=torch.zeros(3, device=dev))
        out.append((name, {k: m.call_args.args for k, m in mocks.items()}))
    for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
        inputs = cs.training_inputs(n, shift, extent, cap, seed, dev, {})
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(inputs["data"], inputs["seeds"],
                              model_cfg=inputs["model_cfg"])
            trainer.train(train_steps, log_every=1 << 30)
            stack, mocks = spies(KERNELS)
            with stack:
                trainer.train(1, log_every=1 << 30)
        out.append((f"train_{name}",
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
    return {"pairs": int(a[1][a[3 if name == "forward_tiles" else 7]])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS)
    ap.add_argument("--train-steps", type=int, default=23)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_tile_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dnsplatter_torch.ops import kernel_build
    from dnsplatter_torch.ops import rasterize_cuda as rc

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
                arity = c_entry_arity((root / f"{name}.cu").read_text(), sym)
                if arity != len(argtypes):
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
        return _call_baseline(fns[name], name, a)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scenes = capture(dev, args.train_steps)
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
