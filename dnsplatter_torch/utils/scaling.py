"""Per-collective size accounting for the sharded train step (counterpart of
dnsplatter_tpu/utils/scaling.py).

Before a multi-device job, account one rank's step for the target world and
report (a) which collectives it issues and how many bytes each moves a
step, and (b) the bytes of one rank's arguments and, on the card, its
output and temporary memory: the two quantities that decide whether a
layout scales (collectives must stay O(screen payload), never
O(capacity x SH x Adam)).

The JAX package compiles the step ahead of time for a virtual mesh and
reads XLA's collectives from the HLO text. The port records one rank's
step in the accounting mode of `parallel/collectives.py`: the collectives
log what they would move for an `n_devices` world and return tensors of
the right shape without communicating. That mode is for this accounting
only, never for training. Usage (on the card; `--device cpu` runs without
one and gives no memory figures):

    python -m dnsplatter_torch.utils.scaling --devices 8 [--capacity N]
    python -m dnsplatter_torch.utils.scaling --step-ms 49.9 \
        --capacity 1253376 --width 1024 --height 576

Multi-device speed is projected, not measured: the fabric figures below are
the public specification of the H100 SXM5, labelled as such.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 public specification, not measurements: NVLink 4 moves
# 900 GB/s in both directions, 450 GB/s each way, to the other cards of a
# host (the Gaussian axis); a 400 Gb/s NDR InfiniBand NIC moves 50 GB/s
# between hosts (the dp axis). Overridable: the projection is a model.
NVLINK_GB_S = 450.0
NIC_GB_S = 50.0


def collective_breakdown(records: Sequence[dict]) -> Tuple[int, List[Dict]]:
    """(total output bytes, per-call rows with op, dtype, shape, bytes) of
    a collective log (`parallel.collectives.LOG`)."""
    rows = [{"op": r["op"], "dtype": r["dtype"], "shape": r["shape"],
             "bytes": r["bytes"]} for r in records]
    return sum(r["bytes"] for r in rows), rows


def scaling_report(n_devices: int, capacity: int = 65536,
                   width: int = 256, height: int = 160,
                   sh_degree: int = 3, strategy: str = "gspmd",
                   device=None) -> Dict:
    """Account rank 0's step of the `strategy` over an `n_devices`-rank
    Gaussian axis and return the accounting dict (also printable via
    `_main`). `device=None` runs the step on the card."""
    import numpy as np
    import torch

    from dnsplatter_torch import resolve_device
    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.models.gaussians import FIELDS, init_from_points
    from dnsplatter_torch.ops.rasterize import RasterizeConfig
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel.distributed import accounting_mesh
    from dnsplatter_torch.parallel.sharding import (
        make_sharded_train_step,
        shard_gaussian_state,
    )
    from dnsplatter_torch.parallel.tile_sharding import make_tile_train_step
    from dnsplatter_torch.train.optim import OptimConfig, init_adam
    from dnsplatter_torch.train.strategy import init_stats

    dev = resolve_device(device)
    mesh = accounting_mesh(gauss=n_devices)
    scene = make_synthetic_scene(seed=0, n_gaussians=128, n_cameras=1,
                                 width=width, height=height,
                                 pair_capacity=1 << 12, device=dev)
    cam, batch = scene.get(0)
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batch.items()}
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (min(capacity, 4096), 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (len(pts), 3)).astype(np.float32)
    params, alive, _ = init_from_points(rng, pts, cols, sh_degree=sh_degree,
                                        capacity=capacity, device=dev)
    adam = init_adam(params)
    trees = (params, adam.mu, adam.nu, adam.accum)
    state_bytes = sum(getattr(t, f).numel() * 4 for t in trees
                      for f in FIELDS)
    params_bytes = sum(getattr(params, f).numel() * 4 for f in FIELDS)
    shard = shard_gaussian_state(mesh, params, alive, adam,
                                 init_stats(capacity, dev))
    p, a, ad, st = shard
    arg_bytes = (sum(getattr(t, f).numel() * 4
                     for t in (p, ad.mu, ad.nu, ad.accum) for f in FIELDS)
                 + a.numel() * 4 + 3 * st.grad_sum.numel() * 4
                 + sum(v.numel() * 4 for v in batch.values())
                 + cam.c2w.numel() * 4)
    del params, alive, adam
    mc = ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                     use_normal_loss=True, sh_degree=sh_degree)
    rc = RasterizeConfig(width=width, height=height, tile_size=16,
                         chunk=32, tile_block=4, pair_capacity=1 << 12)
    make = (make_tile_train_step if strategy == "tile"
            else make_sharded_train_step)
    fn = make(mc, OptimConfig(), rc, sh_degree, mesh)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    C.LOG.clear()
    out = fn(p, a, ad, st, cam, batch, 0,
             generator=torch.Generator().manual_seed(1))
    records = list(C.LOG)
    C.LOG.clear()
    out_bytes = temp_bytes = None
    if on_card:
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        out_bytes = int(after - before)
        temp_bytes = int(torch.cuda.max_memory_allocated() - after)
    del out
    coll_bytes, rows = collective_breakdown(records)
    return {
        "devices": n_devices,
        "strategy": strategy,
        "capacity": capacity,
        "sh_degree": sh_degree,
        "global_state_bytes": int(state_bytes),
        "params_bytes": int(params_bytes),
        "collective_bytes_per_step": int(coll_bytes),
        "collective_fraction_of_state": (
            coll_bytes / state_bytes if state_bytes else 0.0),
        "per_device_argument_bytes": int(arg_bytes),
        "per_device_output_bytes": out_bytes,
        "per_device_temp_bytes": temp_bytes,
        "collectives": rows,
    }


def project_efficiency(step_ms_1chip: float, collective_bytes: int,
                       n_devices: int,
                       nvlink_gb_s: float = NVLINK_GB_S) -> float:
    """Projected per-device rays/s efficiency of the Gaussian-sharded step
    at n_devices: compute divides by n (the step is N-scale dominated),
    collectives ride NVLink serially in the worst case.
    efficiency = ideal_time / projected_time."""
    comm_ms = collective_bytes / (nvlink_gb_s * 1e9) * 1e3
    ideal = step_ms_1chip / n_devices
    return ideal / (ideal + comm_ms)


def project_dp_efficiency(step_ms_1chip: float, grad_bytes: int,
                          n_hosts: int, nic_gb_s: float = NIC_GB_S
                          ) -> float:
    """Projected rays/s efficiency of data-parallel training at n_hosts
    (the reference's DDP axis): each host renders its own frames, the
    gradients ring-allreduce over the NIC (2(h-1)/h x size), un-overlapped
    worst case."""
    if n_hosts <= 1:
        return 1.0
    ring = 2.0 * (n_hosts - 1) / n_hosts * grad_bytes
    comm_ms = ring / (nic_gb_s * 1e9) * 1e3
    return step_ms_1chip / (step_ms_1chip + comm_ms)


def scaling_statement(step_ms_1chip: float, capacity: int = 65536,
                      sh_degree: int = 3,
                      devices_list: Tuple[int, ...] = (2, 4, 8),
                      device=None, width: int = 256,
                      height: int = 160) -> Dict:
    """The auditable scaling prediction: account the sharded step per world
    size, take its collective bytes, and divide by the fabric figures and
    the measured single-device step time to project rays/s efficiency.
    `capacity`, `width` and `height` are those of the run that measured
    `step_ms_1chip`: the bytes scale with the capacity. One card is all
    the measurement has, so the claim is model-based and says so."""
    out: Dict = {
        "model": "compute/n + collectives/NVLink (serial, worst case); "
                 "dp: step + ring-allreduce(grads)/NIC",
        "fabric": "H100 SXM5 public specification (NVLink 4: 450 GB/s "
                  "each way; 400 Gb/s NDR NIC), not measured",
        "nvlink_gb_s": NVLINK_GB_S,
        "nic_gb_s": NIC_GB_S,
        "step_ms_1chip": step_ms_1chip,
        "capacity": capacity,
        "frame": [width, height],
    }
    grad_bytes: Optional[int] = None
    for d in devices_list:
        rep = scaling_report(d, capacity=capacity, width=width,
                             height=height, sh_degree=sh_degree,
                             device=device)
        eff = project_efficiency(step_ms_1chip,
                                 rep["collective_bytes_per_step"], d)
        out[f"projected_scaling_{d}x"] = round(eff, 4)
        out[f"collective_bytes_{d}x"] = rep["collective_bytes_per_step"]
        if grad_bytes is None:
            # dp averages the parameter-shaped gradients
            grad_bytes = rep["params_bytes"]
    for h in (2, 4):
        out[f"projected_dp_scaling_{h}hosts"] = round(
            project_dp_efficiency(step_ms_1chip, grad_bytes, h), 4)
    out["dp_grad_bytes"] = grad_bytes
    return out


def _main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--capacity", type=int, default=65536)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--strategy", choices=("gspmd", "tile"),
                   default="gspmd")
    p.add_argument("--device", default="cuda",
                   help="torch device for the accounted step (default: "
                        "the card; cpu gives no memory figures)")
    p.add_argument("--step-ms", type=float, default=None,
                   help="measured single-device step time; if given, emit "
                        "the projected-scaling statement over 2/4/8-rank "
                        "worlds instead of a single report")
    args = p.parse_args()
    if args.step_ms is not None:
        print(json.dumps(scaling_statement(
            args.step_ms, capacity=args.capacity,
            sh_degree=args.sh_degree, device=args.device, width=args.width,
            height=args.height), indent=2))
        return
    rep = scaling_report(args.devices, capacity=args.capacity,
                         width=args.width, height=args.height,
                         sh_degree=args.sh_degree, strategy=args.strategy,
                         device=args.device)
    rows = rep.pop("collectives")
    print(json.dumps(rep, indent=2))
    agg: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for r in rows:
        k = (r["op"], r["dtype"])
        n, b = agg.get(k, (0, 0))
        agg[k] = (n + 1, b + r["bytes"])
    print(f"{'collective':<20} {'dtype':<8} {'count':>5} {'bytes':>12}")
    for (op, dt), (n, b) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        print(f"{op:<20} {dt:<8} {n:>5} {b:>12}")


if __name__ == "__main__":
    _main()
