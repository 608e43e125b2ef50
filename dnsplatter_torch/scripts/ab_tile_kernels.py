"""Time the two tile kernels against another version of their sources, on
the GPU, in turns, at the inputs of the main path.

    python -m dnsplatter_torch.scripts.ab_tile_kernels --baseline DIR

DIR holds an earlier design's `forward_tiles.cu` and `backward_tiles.cu`
(for example a parent commit's, unpacked with `git archive`): the same C
entries, but for the tile order the current `dns_backward_tiles` takes.
Both versions are compiled with nvcc and the flags of `kernel_build`; each
ptxas report (registers, shared memory) and the resident CTAs per SM it
allows are printed. The current version is called through its wrappers
(the backward's time includes the tile order the wrapper sorts), the
baseline through the same allocation and arguments. Inputs are captured from
chip_smoke.py's scenes: a served frame (camera 0) at 100k and 1M
Gaussians, and one training step (after `--train-steps` steps of
`Trainer.train` at the Trainer's defaults) at 100k and 1M seeds. At each,
every kernel is timed baseline, current, current, baseline (chip_smoke's
`device_ms`: device time per call from a batch behind a spin kernel), and
the two versions' outputs are compared (forward: bit-equal or not, pixels
whose `last` differs, the largest image difference; backward: chip_smoke's
`compare_backward`). Prints one JSON line per
(scene, kernel). Runs only on the card.
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

KERNELS = ("forward_tiles", "backward_tiles")
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BASELINE_ARGTYPES = {
    "forward_tiles": [_VP, _LL, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP,
                      _VP],
    "backward_tiles": [_VP, _LL, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP,
                       _VP, _VP, _LL, _I, _VP],
}
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


def _call_baseline(fn, name: str, a):
    """The baseline's C entry on the wrapper's outputs and arguments."""
    import torch

    from dnsplatter_torch.ops import rasterize_cuda as rc

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
    rc._check_rc(fn(payload.data_ptr(), payload.stride(0), starts.data_ptr(),
                    counts.data_ptr(), n_tiles, f, tile, tiles_x,
                    g_out.data_ptr(), g_alpha.data_ptr(), t_final.data_ptr(),
                    last.data_ptr(), slab.data_ptr(), slab.stride(0), 1,
                    rc._stream()), name)
    return slab


# The mangled template arguments of the instance the main path runs at
# tile 16: F = 7 (and, for the backward, packed; the current one at four
# pixels a thread).
TAGS = {("baseline", "forward_tiles"): "ILi7EE",
        ("baseline", "backward_tiles"): "ILi7ELb1EE",
        ("current", "forward_tiles"): "ILi7EE",
        ("current", "backward_tiles"): "ILi7ELb1ELi4EE"}


def _report(name: str, log: str, threads: int, tag: str) -> dict:
    """The ptxas figures of the kernel instance `tag` names."""
    for entry, fig in parse_ptxas(log).items():
        if f"{name}_kernel{tag}" in entry:
            return {**fig, "threads": threads,
                    "resident_ctas": resident_ctas(fig["registers"],
                                                   fig["smem"], threads)}
    raise RuntimeError(f"no {tag} entry of {name} in the ptxas report")


def capture(dev, train_steps: int):
    """[(scene, forward args, backward args or None)] for the four scenes."""
    import torch

    import chip_smoke as cs
    from dnsplatter_torch.eval.evaluator import eval_raster_config
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops import rasterize_cuda as rc
    from dnsplatter_torch.train.trainer import Trainer

    out = []
    for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
        _, served, alive, cams = cs.make_scene(n, shift, extent, seed, dev)
        cfg = eval_raster_config(cs.WIDTH, cs.HEIGHT, cap)
        with torch.no_grad(), mock.patch.object(
                rc, "forward_tiles", wraps=rc.forward_tiles) as fwd:
            get_outputs(served, alive, cams[0], ModelConfig(), cfg,
                        sh_degree=3, background=torch.zeros(3, device=dev))
        out.append((name, fwd.call_args.args, None))
    for seed, (name, n, shift, extent, cap) in enumerate(cs.SCENES):
        inputs = cs.training_inputs(n, shift, extent, cap, seed, dev, {})
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(inputs["data"], inputs["seeds"],
                              model_cfg=inputs["model_cfg"])
            trainer.train(train_steps, log_every=1 << 30)
            with mock.patch.object(rc, "forward_tiles",
                                   wraps=rc.forward_tiles) as fwd, \
                    mock.patch.object(rc, "backward_tiles",
                                      wraps=rc.backward_tiles) as bwd:
                trainer.train(1, log_every=1 << 30)
        out.append((f"train_{name}", fwd.call_args.args,
                    bwd.call_args.args))
        del trainer, inputs
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
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
    # threads per CTA at tile 16, for the residency figure
    threads = {("baseline", "forward_tiles"): 256,
               ("baseline", "backward_tiles"): 256,
               ("current", "forward_tiles"): 256,
               ("current", "backward_tiles"): 64}
    for version, root in (("baseline", args.baseline),
                          ("current", kernel_build.CSRC_DIR)):
        for name in KERNELS:
            lib_path = build / f"lib{name}-{version}.so"
            log = _compile(root / f"{name}.cu", lib_path)
            figures[(version, name)] = _report(name, log,
                                               threads[(version, name)],
                                               TAGS[(version, name)])
            if version == "baseline":
                fn = getattr(ctypes.CDLL(str(lib_path)), f"dns_{name}")
                fn.argtypes = BASELINE_ARGTYPES[name]
                fn.restype = ctypes.c_int
                fns[name] = fn
    for (version, name), fig in figures.items():
        print(json.dumps({"ptxas": name, "version": version, **fig}),
              flush=True)

    def call(version, name, a):
        if version == "current":
            if name == "forward_tiles":
                return rc.forward_tiles(*a)
            return rc.backward_tiles(*a, pack_grads=True)
        return _call_baseline(fns[name], name, a)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scenes = capture(dev, args.train_steps)
    print(json.dumps({"capture_seconds": time.perf_counter() - t0}),
          flush=True)
    for scene, fwd_args, bwd_args in scenes:
        for name, a in (("forward_tiles", fwd_args),
                        ("backward_tiles", bwd_args)):
            if a is None:
                continue
            base = call("baseline", name, a)
            cur = call("current", name, a)
            torch.cuda.synchronize()
            if name == "forward_tiles":
                agree = {"bit_equal": all(torch.equal(x, y)
                                          for x, y in zip(base, cur)),
                         "last_differs": int((base[2] != cur[2]).sum()),
                         "max_abs_diff": float((base[0] - cur[0]).abs().max())}
            else:
                agree = cs.compare_backward(cur, base, a[8])
                agree.pop("row_max")
            reps = 50 if name == "forward_tiles" else 20
            times = {"baseline": [], "current": []}
            for version in ("baseline", "current", "current", "baseline"):
                times[version].append(cs.device_ms(
                    lambda v=version: call(v, name, a), reps))
            b_ms, c_ms = (min(times[v]) for v in ("baseline", "current"))
            print(json.dumps({
                "scene": scene, "kernel": name, "baseline_ms": times[
                    "baseline"], "current_ms": times["current"],
                "speedup": b_ms / c_ms, "agreement": agree,
                "pairs": int(a[1][a[3 if name == "forward_tiles" else 7]]),
                "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
