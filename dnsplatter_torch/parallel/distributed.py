"""Multi-process runtime: process bring-up, the hybrid dp x gauss mesh, the
data-parallel step (counterpart of dnsplatter_tpu/parallel/distributed.py).

The reference trains data-parallel with torch DDP, one replica a rank, each
rank on its own image, gradients all-reduced (dn_pipeline.py:122-128). The
JAX package runs one process per host over a global (dp, gauss) device
mesh. The port keeps PyTorch's idiom, one process per device, launched by
`torchrun` (`python -m torch.distributed.run`) or by the environment it
sets: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT.

* `init_distributed` is the one entry point, idempotent, and in a process
  launched without that environment the degenerate single process: rank 0
  of 1 and no process group, so every path above it (mesh, sharding,
  checkpoint gating) runs on one device too.
* `make_hybrid_mesh(dp)` lays the world out as (dp, gauss), rank
  r = d * gauss + g: a dp group per gauss coordinate, a gauss group per dp
  coordinate. The Gaussian state is sharded over gauss (rows
  [g C / G, (g + 1) C / G) on rank g) and replicated over dp.
* `make_dp_train_step`: each dp rank renders its own frame with the gspmd
  render of `parallel/sharding.py` over its gauss group (as one device
  when that group has one rank), the Gaussian gradients go through one
  `all_reduce_mean` over dp (one flat buffer, one call a step), the
  absgrad statistic through one sum, radii and visibility through one
  max, and every rank then takes the same Adam step.
* Checkpoints and writers are process-0-gated (`is_main_process`); reading
  the sharded state for them is a gather every rank enters
  (`host_local_value`, `collectives.gather_state`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.gaussians import FIELDS, GaussianParams
from dnsplatter_torch.parallel import collectives as C
from dnsplatter_torch.parallel.collectives import Axis
from dnsplatter_torch.train.optim import AdamState
from dnsplatter_torch.train.strategy import RefineStats

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DistContext:
    process_index: int
    process_count: int
    initialized: bool  # True iff this process joined a process group
    backend: Optional[str] = None
    local_rank: int = 0

    @property
    def is_main(self) -> bool:
        return self.process_index == 0


_CONTEXT: Optional[DistContext] = None


def _single_process_error(what: str) -> RuntimeError:
    return RuntimeError(
        f"--train.distributed true, but {what}; refusing to train "
        "un-distributed (launch with torchrun --nproc-per-node N, or set "
        + " / ".join(LAUNCH_ENV) + ")")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    require_multiprocess: bool = False,
    backend: Optional[str] = None,
    device=None,
) -> DistContext:
    """Join the process group (idempotent).

    A multi-process launch is asked for by the arguments
    (`coordinator_address` "host:port", `num_processes`, `process_id`) or
    by the launch environment. With neither this is the degenerate single
    process: no process group. The backend defaults to NCCL on `device`
    "cuda" (None) and gloo on the CPU; under NCCL each rank takes card
    LOCAL_RANK, and a world wider than the visible cards raises ValueError
    (NCCL refuses two ranks on one card). Gloo on the card, several ranks
    sharing it, is chosen only by `backend="gloo"`.

    `require_multiprocess=True` (the CLI's `--train.distributed true`)
    raises RuntimeError when there is no launch environment or the world
    has one process, instead of training single-process silently.
    """
    global _CONTEXT
    env = os.environ
    launched = "WORLD_SIZE" in env and "MASTER_PORT" in env
    if _CONTEXT is None:
        world = num_processes or int(env.get("WORLD_SIZE", "1"))
        want = (coordinator_address is not None or launched or world > 1
                or require_multiprocess)
        if not want:
            _CONTEXT = DistContext(0, 1, False)
        else:
            if coordinator_address is None and not launched:
                raise _single_process_error("no launch environment was "
                                            "found")
            _CONTEXT = _join(coordinator_address, world, process_id,
                             backend, resolve_device(device))
    if require_multiprocess and _CONTEXT.process_count == 1:
        raise _single_process_error("the world has a single process")
    return _CONTEXT


def _join(coordinator_address, world, process_id, backend, dev
          ) -> DistContext:
    env = os.environ
    rank = int(env.get("RANK", "0")) if process_id is None else process_id
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env['MASTER_PORT']}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl":
            local_world = int(env.get("LOCAL_WORLD_SIZE", world))
            if local_world > cards:
                raise ValueError(
                    f"NCCL takes one card a rank: {local_world} ranks on "
                    f"this host and {cards} visible cards (launch with "
                    f"torchrun --nproc-per-node {cards} or fewer, or pass "
                    "backend='gloo' to share a card)")
            torch.cuda.set_device(local_rank)
        else:
            torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}", world_size=world,
                            rank=rank)
    return DistContext(process_index=dist.get_rank(),
                       process_count=dist.get_world_size(), initialized=True,
                       backend=backend, local_rank=local_rank)


def shutdown_distributed() -> None:
    """Leave the process group, if any, and forget the context."""
    global _CONTEXT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT = None


def dist_context() -> DistContext:
    """The active context (the single process if never initialised)."""
    if _CONTEXT is not None:
        return _CONTEXT
    return DistContext(0, 1, False)


def is_main_process() -> bool:
    return dist_context().is_main


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, gauss) layout of the world, seen from one rank."""

    dp_axis: Axis
    gauss_axis: Axis

    @property
    def dp(self) -> int:
        return self.dp_axis.size

    @property
    def gauss(self) -> int:
        return self.gauss_axis.size

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "gauss": self.gauss}


def make_hybrid_mesh(dp: Optional[int] = None) -> Mesh:
    """The world as (dp, gauss). Default dp = the process count (every rank
    its own frame, no Gaussian sharding). Every rank must call it: it
    creates the process groups of both axes."""
    ctx = dist_context()
    world = ctx.process_count
    dp = max(world, 1) if dp is None else dp
    if dp < 1 or world % dp != 0:
        raise ValueError(f"{world} ranks are not divisible by dp={dp} "
                         "(launch a multiple of dp processes: torchrun "
                         "--nproc-per-node)")
    gauss = world // dp
    d, g = divmod(ctx.process_index, gauss)
    if not dist.is_initialized():
        return Mesh(Axis(), Axis())

    def groups(size, ranks):
        # An axis of one rank in a wider world moves nothing: no group, so
        # its collectives return their input. In a world of one both axes
        # keep their one-rank group, which runs every collective on the
        # backend (the world-1 checks of the steps against one device).
        if size == 1 and world > 1:
            return [None] * len(ranks)
        return [dist.new_group(r) for r in ranks]

    dp_groups = groups(dp, [[dd * gauss + gg for dd in range(dp)]
                            for gg in range(gauss)])
    gauss_groups = groups(gauss, [[dd * gauss + gg for gg in range(gauss)]
                                  for dd in range(dp)])
    return Mesh(Axis(dp, d, dp_groups[g]), Axis(gauss, g, gauss_groups[d]))


def accounting_mesh(dp: int = 1, gauss: int = 1) -> Mesh:
    """Rank 0 of a (dp, gauss) world that is not there: collectives record
    what they would move and do not communicate (see `collectives`). For
    `utils/scaling.py`'s accounting only, never for training."""
    return Mesh(Axis(dp, 0, accounting=True),
                Axis(gauss, 0, accounting=True))


def host_local_indices(n_frames: int, ctx: Optional[DistContext] = None,
                       dp: Optional[int] = None):
    """Frame indices this process serves (DDP-sampler style shard).

    With dp == process_count (default) this is the strided shard:
    process p of P owns frames p, p+P, p+2P, ... More generally a
    process owns the frames whose dp rank (frame % dp) falls in its
    contiguous rank block."""
    ctx = ctx or dist_context()
    dp = dp or max(ctx.process_count, 1)
    dpl = max(dp // max(ctx.process_count, 1), 1)
    return [f for f in range(n_frames)
            if (f % dp) // dpl == ctx.process_index]


def host_local_value(x: torch.Tensor, mesh: Optional[Mesh] = None
                     ) -> np.ndarray:
    """The full array of a Gaussian-sharded tensor on this host: its gauss
    shards gathered (every rank of the gauss group must enter), or `x`
    itself without a mesh."""
    if mesh is not None:
        x = C.gather_state([x], mesh.gauss_axis)[0]
    return x.detach().cpu().numpy()


def shard_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rank `axis.rank`'s rows of `t`, [g C / G, (g + 1) C / G)."""
    c = t.shape[0]
    if c % axis.size:
        raise ValueError(f"capacity {c} is not divisible by {axis.size} "
                         "Gaussian shards")
    n = c // axis.size
    return t[axis.rank * n:(axis.rank + 1) * n].clone()


def shard_state_hybrid(mesh: Mesh, params: GaussianParams,
                       alive: torch.Tensor, adam: AdamState,
                       stats: RefineStats):
    """This rank's shard of the full state (identical on every rank): the
    capacity axis split over gauss, replicated over dp."""
    ax = mesh.gauss_axis
    tree = lambda t: GaussianParams(**{  # noqa: E731
        f: shard_rows(getattr(t, f), ax) for f in FIELDS})
    return (tree(params), shard_rows(alive, ax),
            AdamState(mu=tree(adam.mu), nu=tree(adam.nu),
                      count=dict(adam.count), accum=tree(adam.accum)),
            RefineStats(*(shard_rows(s, ax) for s in dataclasses.astuple(
                stats))))


def gather_state_hybrid(mesh: Mesh, params: GaussianParams,
                        alive: torch.Tensor, adam: AdamState,
                        stats: RefineStats):
    """The inverse of `shard_state_hybrid`: the full state on every rank,
    in one gather over gauss that every rank enters."""
    trees = [params, adam.mu, adam.nu, adam.accum]
    flat = [getattr(t, f) for t in trees for f in FIELDS]
    flat += [alive] + list(dataclasses.astuple(stats))
    full = C.gather_state(flat, mesh.gauss_axis)
    k = len(FIELDS)
    tr = [GaussianParams(**dict(zip(FIELDS, full[i * k:(i + 1) * k])))
          for i in range(4)]
    rest = full[4 * k:]
    return (tr[0], rest[0],
            AdamState(mu=tr[1], nu=tr[2], count=dict(adam.count),
                      accum=tr[3]),
            RefineStats(*rest[1:]))


def stack_frames(mesh: Mesh, cams: Sequence, batches: Sequence,
                 device=None):
    """This rank's frame: (camera, batch of tensors on `device`) from the
    dp frames of a step (`len(cams) == mesh.dp`, indexed by this rank's dp
    coordinate) or from this rank's one local frame."""
    i = mesh.dp_axis.rank if len(cams) == mesh.dp and len(cams) > 1 else 0
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v, dtype=torch.float32, device=dev)
             for k, v in batches[i].items()}
    return cams[i], batch


def make_dp_train_step(model_cfg, optim_cfg, raster_cfg, sh_degree: int,
                       mesh: Mesh) -> Callable:
    """The hybrid data-parallel step: each dp rank's frame through the
    gspmd render over its gauss group, gradients averaged over dp, one Adam
    step on the averaged gradients, identical on every rank.

    step_fn(params, alive, adam, stats, camera, batch, step,
    backgrounds=None, generator=None, cam_state=None, frame_idx=None)
    -> (params, adam, stats, mean loss, this rank's loss dict). `params`
    .. `stats` are this rank's shard; `camera` / `batch` its dp frame;
    `frame_idx` the dp frames' indices, rank order. `backgrounds` (dp, 3):
    each dp rank's background; without them and with background_color
    "random", every rank draws all dp of them from `generator` (so the
    generators stay in step) and takes its own. With `cam_state` the pose
    optimizer takes every dp rank's frame index and tangent gradient,
    gathered; gradients of a repeated index add up. `adam` and `cam_state`
    are updated in place."""
    from dnsplatter_torch.models.dn_model import apply_binary_opacities
    from dnsplatter_torch.parallel.sharding import gspmd_outputs
    from dnsplatter_torch.train.optim import cam_opt_update
    from dnsplatter_torch.train.trainer import (
        apply_gradients,
        loss_and_grads,
        single_device_outputs,
    )

    dpa, ga = mesh.dp_axis, mesh.gauss_axis
    # Pure dp (one rank a Gaussian axis) renders as one device: a gather
    # over one rank would copy the payload and move nothing.
    outputs_fn = gspmd_outputs(ga) if ga.size > 1 else single_device_outputs

    def step_fn(params, alive, adam, stats, camera, batch, step,
                backgrounds=None, generator=None, cam_state=None,
                frame_idx=None):
        step = int(step)
        params = apply_binary_opacities(params, alive, model_cfg, step)
        dev = params.means.device
        if (backgrounds is None and model_cfg.background_color == "random"
                and generator is not None):
            backgrounds = torch.rand((dpa.size, 3), generator=generator,
                                     device=generator.device)
        bg = (None if backgrounds is None
              else torch.as_tensor(backgrounds)[dpa.rank].to(dev))
        frame_idx = list(frame_idx if frame_idx is not None
                         else range(dpa.size))
        adj = None
        if cam_state is not None:
            adj = (cam_state.adj[frame_idx[dpa.rank]].detach().clone()
                   .requires_grad_(True))
        loss, loss_dict, gparams, gabs, info = loss_and_grads(
            model_cfg, raster_cfg, sh_degree, params, alive, camera, batch,
            step, background=bg, generator=generator, cam_adj=adj,
            outputs_fn=outputs_fn)
        # The DDP average: one call for every gradient field and the loss;
        # the statistics combine as dp sequential steps would (absgrad
        # sums, screen radius and visibility max).
        grads = [getattr(gparams, f) for f in FIELDS] + [loss.reshape(1)]
        *grads, loss = C.unflatten(C.all_reduce_mean(C.flatten(grads), dpa),
                                   grads)
        gabs = C.all_reduce_sum(gabs, dpa)
        radii, valid = C.unflatten(C.all_reduce_max(
            C.flatten([info.radii, info.valid]), dpa),
            [info.radii, info.valid.to(torch.float32)])
        new_params, adam, stats = apply_gradients(
            optim_cfg, raster_cfg, params, alive, adam, stats,
            GaussianParams(**dict(zip(FIELDS, grads))), gabs, radii,
            valid > 0.5, step)
        if cam_state is not None:
            mine = torch.cat([torch.tensor([float(frame_idx[dpa.rank])],
                                           device=adj.grad.device),
                              adj.grad])[None]
            every = C.all_gather_rows(mine, dpa)
            cam_opt_update(optim_cfg, cam_state, every[:, 0].long(),
                           every[:, 1:], step)
        return new_params, adam, stats, loss.reshape(()), loss_dict

    return step_fn
