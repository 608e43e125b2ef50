"""Training loop: the step, the refinement cadence and checkpoints
(counterpart of dnsplatter_tpu/train/trainer.py).

The loop serves full images in sequence, takes one optimizer step per image
with the per-group Adam of `train/optim.py`, follows the SH-degree
schedule, and runs the refinement events (densify, cull, opacity reset,
capacity growth) between steps, where `step` is a Python int. The port
runs eagerly, so there is no compiled step per (shape, SH degree): the
step is a plain function, `train_step`.

Checkpoints are the JAX package's npz files, key for key (`params.*`,
`alive`, `step`, `adam.{mu,nu,count,accum}.*`, `cam_opt.*`, `cam_adj`), so
a run saved by either package resumes in the other.

`camera_optimizer_mode="SO3xR3"` optimizes a pose tangent per camera beside
the Gaussians (`models/camera_opt.py`, `train/optim.py:cam_opt_update`).
`steps_per_dispatch = k > 1` takes k steps between two looks at the
refinement cadence, the log and the SH schedule: the JAX package ran them
as one device dispatch; here they are k calls of the same step function.

With an `out_dir` the loop logs to `metrics.jsonl` and, with
`TrainConfig.tensorboard`, to a tfevents file under `out_dir/tb`
(`utils/writers.py`). With `TrainConfig.viewer` it serves the live viewer
(`utils/viewer.py`) on `viewer_port` (0: an ephemeral port): the log rows,
the eval images, and orbit renders of the current model on the viewer's
HTTP thread. Those read the state at a step boundary: the loop holds
`state_lock` over each step and its refinement, and the render copies the
parameters under it (refinement writes some in place).

Multi-device training runs one process a device under torch.distributed
(`parallel/`): `devices = N` shards the Gaussian state over the N ranks of
the world and steps by `parallel_strategy` ("gspmd": every rank renders the
whole frame from the gathered payload; "tile": every rank rasterizes a slab
of tile rows); `dp > 1` or `distributed` lays the world out as (dp, gauss)
and each dp rank trains on its own frame, the gradients averaged. Every
rank holds its shard; what reads the whole state (refinement, the log's
alive count, eval images, checkpoints, the viewer's orbit renders) gathers
it, every rank entering the gather, and only rank 0 writes. Refinement
runs on the gathered state, the same on every rank with the same draws,
and the state is sharded again after it.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dnsplatter_torch import resolve_device
from dnsplatter_torch.models.dn_model import (
    ModelConfig,
    apply_binary_opacities,
    compute_loss,
    get_outputs,
    sh_degree_to_use,
)
from dnsplatter_torch.models.gaussians import (
    FIELDS,
    GaussianParams,
    grow_capacity,
    init_from_points,
    init_random,
    params_from_numpy,
    params_to_numpy,
)
from dnsplatter_torch.ops.camera import Camera, look_at
from dnsplatter_torch.ops.projection import project_gaussians
from dnsplatter_torch.ops.rasterize import RasterizeConfig
from dnsplatter_torch.models.camera_opt import apply_adjustment
from dnsplatter_torch.train.optim import (
    AdamState,
    CamOptState,
    OptimConfig,
    adam_from_numpy,
    adam_step,
    adam_to_numpy,
    cam_opt_from_numpy,
    cam_opt_to_numpy,
    cam_opt_update,
    init_adam,
    init_cam_opt,
    pad_adam,
)
from dnsplatter_torch.train.strategy import (
    RefineStats,
    cull_only,
    densify_and_cull,
    init_stats,
    reset_opacity,
    update_stats,
)
from dnsplatter_torch.utils import profiling
from dnsplatter_torch.utils.writers import JsonlWriter, TensorboardWriter

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's fields and defaults. `chunk`, `tile_block` and
    `backend` are carried into the RasterizeConfig and not read by the
    kernels; `cache_batches_on_device` keeps each frame's batch on the
    card after its first upload."""

    max_iterations: int = 30000
    steps_per_eval_image: int = 500
    steps_per_save: int = 1_000_000  # end-of-run only, like the reference
    seed: int = 42
    pair_capacity: int = 1 << 21
    tile_size: int = 16
    chunk: int = 128
    tile_block: int = 32
    backend: str = "auto"
    # "depthq": tile + quantized depth in one uint32 key and no N-scale
    # depth pre-sort; differs from the exact schemes only by reorders of
    # depths closer than the quantization step. "auto" for the exact
    # packed schemes.
    sort_scheme: str = "depthq"
    # < 0 keeps the RasterizeConfig default (0.375)
    compact_frac: float = -1.0
    steps_per_dispatch: int = 1
    devices: int = 0
    distributed: bool = False
    dp: int = 1
    parallel_strategy: str = "gspmd"
    # Size pair_capacity from the data at startup: the largest raw
    # (gaussian, tile) pair count over sample frames times the margin,
    # rounded up to the chunk. Every sort, gather and slab in the
    # rasterizer scales with the capacity.
    auto_pair_capacity: bool = True
    auto_capacity_margin: float = 3.0
    # Gaussian-state capacity (0: capacity_margin x the seed count, rounded
    # to 4096). When a densify event fills >= 95% of it, the state is
    # re-padded to capacity_growth x; <= 1 disables growth (overflowing
    # children are then dropped).
    capacity: int = 0
    capacity_margin: float = 1.25
    capacity_growth: float = 1.5
    viewer: bool = False
    viewer_port: int = 7007
    tensorboard: bool = False
    cache_batches_on_device: bool = True


def _check_ported(model_cfg: ModelConfig, tc: TrainConfig) -> None:
    if model_cfg.camera_optimizer_mode not in ("off", "SO3xR3"):
        raise ValueError("camera_optimizer_mode "
                         f"{model_cfg.camera_optimizer_mode!r}: 'off' or "
                         "'SO3xR3'")
    k = tc.steps_per_dispatch
    if k > 1 and (model_cfg.refine_every % k
                  or model_cfg.sh_degree_interval % k):
        raise ValueError(f"steps_per_dispatch = {k} must divide "
                         f"refine_every ({model_cfg.refine_every}) and "
                         f"sh_degree_interval "
                         f"({model_cfg.sh_degree_interval})")
    if tc.parallel_strategy not in ("gspmd", "tile"):
        raise ValueError(f"parallel_strategy {tc.parallel_strategy!r}: "
                         "'gspmd' or 'tile'")


def single_device_outputs(params: GaussianParams, alive: torch.Tensor,
                          camera: Camera, model_cfg: ModelConfig,
                          raster_cfg: RasterizeConfig, sh_degree: int,
                          background, absgrad_sink, generator):
    """The frame's outputs on one device: (outputs, RenderInfo, the rows
    the loss reads (scales, opacities), their alive mask). The sharded
    strategies pass their own function of the same signature
    (`parallel/sharding.py`, `parallel/tile_sharding.py`)."""
    outputs, info = get_outputs(
        params, alive, camera, model_cfg, raster_cfg, sh_degree=sh_degree,
        background=background, absgrad_sink=absgrad_sink, training=True,
        generator=generator)
    return outputs, info, params, alive


def loss_and_grads(
    model_cfg: ModelConfig,
    raster_cfg: RasterizeConfig,
    sh_degree: int,
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    batch: Dict[str, torch.Tensor],
    step: int,
    background: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    pearson_corners=None,
    cam_adj: Optional[torch.Tensor] = None,
    outputs_fn=single_device_outputs,
):
    """The loss of one frame and its gradients: (loss, loss_dict, grads as
    GaussianParams, absgrad (C, 2), RenderInfo). With `cam_adj`, a (6,)
    pose tangent that requires grad, the frame is rendered from the
    adjusted camera and the tangent's gradient is left in `cam_adj.grad`.
    `outputs_fn` renders (see `single_device_outputs`); under a sharded one
    `params` / `alive` are this rank's rows and so are the gradients."""
    leaves = GaussianParams(**{
        f: getattr(params, f).detach().requires_grad_(True) for f in FIELDS})
    sink = torch.zeros_like(params.means[:, :2]).requires_grad_(True)
    if cam_adj is not None:
        camera = apply_adjustment(camera, cam_adj)
    with profiling.span("train.forward"):
        outputs, info, rows, rows_alive = outputs_fn(
            leaves, alive, camera, model_cfg, raster_cfg, sh_degree,
            background, sink, generator)
    with profiling.span("train.loss"):
        loss, loss_dict = compute_loss(outputs, batch, rows, rows_alive,
                                       camera, model_cfg, step,
                                       pearson_corners=pearson_corners,
                                       generator=generator)
    inputs = [getattr(leaves, f) for f in FIELDS] + [sink]
    if cam_adj is not None:
        inputs.append(cam_adj)
    with profiling.span("train.backward", grad=True):
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, inputs)]
    if cam_adj is not None:
        cam_adj.grad = grads.pop()
    gparams = GaussianParams(**dict(zip(FIELDS, grads[:-1])))
    loss_dict = {k: v.detach() for k, v in loss_dict.items()}
    return loss.detach(), loss_dict, gparams, grads[-1], info


def apply_gradients(optim_cfg: OptimConfig, raster_cfg: RasterizeConfig,
                    params: GaussianParams, alive: torch.Tensor,
                    adam: AdamState, stats: RefineStats,
                    gparams: GaussianParams, gabs: torch.Tensor,
                    radii: torch.Tensor, valid: torch.Tensor, step: int
                    ) -> Tuple[GaussianParams, AdamState, RefineStats]:
    """Dead capacity-padding slots frozen by `alive`, the Adam step (`adam`
    in place), the densification statistics."""
    gparams = GaussianParams(**{
        f: getattr(gparams, f) * alive.reshape(
            (-1,) + (1,) * (getattr(gparams, f).ndim - 1)) for f in FIELDS})
    new_params, adam = adam_step(optim_cfg, params, gparams, adam, step)
    max_size = float(max(raster_cfg.width, raster_cfg.height))
    return new_params, adam, update_stats(stats, gabs, radii, valid,
                                          max_size)


def train_step(
    model_cfg: ModelConfig,
    optim_cfg: OptimConfig,
    raster_cfg: RasterizeConfig,
    sh_degree: int,
    params: GaussianParams,
    alive: torch.Tensor,
    adam: AdamState,
    stats: RefineStats,
    camera: Camera,
    batch: Dict[str, torch.Tensor],
    step: int,
    background: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    pearson_corners=None,
    cam_state: Optional[CamOptState] = None,
    cam_i: int = 0,
    outputs_fn=single_device_outputs,
) -> Tuple[GaussianParams, AdamState, RefineStats, torch.Tensor,
           Dict[str, torch.Tensor]]:
    """One optimizer step on one frame: binary opacities, loss and
    gradients, dead slots frozen by `alive`, the Adam step, the
    densification statistics. `adam` is updated in place. Without a
    `background`, a random one is drawn from `generator` (see
    `get_outputs`); `pearson_corners` feed depth_loss_type "pearson". With
    `cam_state` (camera_optimizer_mode "SO3xR3") the frame is rendered from
    camera `cam_i`'s adjusted pose and the pose optimizer takes its step
    too, `cam_state` updated in place. `outputs_fn`: see `loss_and_grads`."""
    step = int(step)
    with profiling.span("train.step"):
        params = apply_binary_opacities(params, alive, model_cfg, step)
        adj = None
        if cam_state is not None:
            adj = cam_state.adj[cam_i].detach().clone().requires_grad_(True)
        loss, loss_dict, gparams, gabs, info = loss_and_grads(
            model_cfg, raster_cfg, sh_degree, params, alive, camera, batch,
            step, background=background, generator=generator,
            pearson_corners=pearson_corners, cam_adj=adj,
            outputs_fn=outputs_fn)
        with profiling.span("train.optim"):
            new_params, adam, stats = apply_gradients(
                optim_cfg, raster_cfg, params, alive, adam, stats, gparams,
                gabs, info.radii, info.valid, step)
            if cam_state is not None:
                cam_opt_update(optim_cfg, cam_state, cam_i, adj.grad, step)
    return new_params, adam, stats, loss, loss_dict


class Trainer:
    """Single-device trainer over a scene source: `len(data)` frames and
    `data.get(i) -> (Camera, dict of numpy arrays or tensors)`, served in
    sequence. `device=None` trains on the card."""

    def __init__(
        self,
        data,
        seed_points: Optional[Tuple[np.ndarray, ...]] = None,
        model_cfg: ModelConfig = ModelConfig(),
        optim_cfg: OptimConfig = OptimConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        out_dir: Optional[Path] = None,
        device=None,
    ):
        _check_ported(model_cfg, train_cfg)
        # Join the process group before any tensor is made: under NCCL it
        # picks this rank's card.
        self.dist = None
        if (train_cfg.distributed or train_cfg.dp > 1
                or train_cfg.devices > 1):
            from dnsplatter_torch.parallel import distributed as D

            self.dist = D.init_distributed(device=device)
        self.device = resolve_device(device)
        self.data = data
        self.model_cfg = model_cfg
        self.optim_cfg = optim_cfg
        self.train_cfg = train_cfg
        self.out_dir = Path(out_dir) if out_dir else None
        # Host draws (init, background colours, loss boxes) and device
        # draws (split children), both from the seed.
        self.rng = np.random.default_rng(train_cfg.seed)
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(train_cfg.seed)
        self.device_generator = torch.Generator(device=self.device)
        self.device_generator.manual_seed(train_cfg.seed)
        self._batch_cache: Dict[int, tuple] = {}
        self._ds_cache: Dict[tuple, tuple] = {}

        if seed_points is not None:
            pts = seed_points[0]
            cols = seed_points[1] if len(seed_points) > 1 else None
            nrms = seed_points[2] if len(seed_points) > 2 else None
            cap = train_cfg.capacity
            if not cap:
                n_seed = int(pts.shape[0])
                cap = max(4096, int(np.ceil(
                    train_cfg.capacity_margin * n_seed / 4096) * 4096))
            self.params, self.alive, _ = init_from_points(
                self.rng, pts, cols, nrms, sh_degree=model_cfg.sh_degree,
                capacity=cap, device=self.device)
        else:
            self.params, self.alive, _ = init_random(
                self.rng, num_points=model_cfg.num_random,
                extent=model_cfg.random_scale / 2.0,
                sh_degree=model_cfg.sh_degree, device=self.device)
        self.adam = init_adam(self.params)
        self.stats = init_stats(self.params.capacity, self.device)
        self.audited_pairs = 0  # largest raw pair count the audit saw
        if train_cfg.auto_pair_capacity:
            cap = self._audit_pair_capacity()
            if cap is not None:
                self.train_cfg = dataclasses.replace(train_cfg,
                                                     pair_capacity=cap)
                print(f"auto pair capacity: {cap}", flush=True)
        self.mesh = None
        self.dp = 1
        if train_cfg.distributed or train_cfg.dp > 1:
            from dnsplatter_torch.parallel.distributed import make_hybrid_mesh

            self.dp = (train_cfg.dp if train_cfg.dp > 1
                       else max(self.dist.process_count, 1))
            if train_cfg.devices and (train_cfg.devices
                                      != self.dist.process_count):
                raise ValueError(
                    f"--train.devices {train_cfg.devices} with "
                    f"{self.dist.process_count} processes: one process a "
                    "device (torchrun --nproc-per-node)")
            if model_cfg.num_downscales > 0:
                raise NotImplementedError(
                    "progressive downscaling is not wired into the dp "
                    "step (dn-splatter default num_downscales=0)")
            self.mesh = make_hybrid_mesh(dp=self.dp)
        elif train_cfg.devices > 1:
            from dnsplatter_torch.parallel.sharding import make_mesh

            self.mesh = make_mesh(train_cfg.devices)
        if self.mesh is not None:
            self._shard_state()
        self.step = 0
        self._history: list = []
        # Carried (all zeros) with the optimizer off too, so checkpoints
        # keep the JAX package's keys.
        self.cam_opt = init_cam_opt(len(data), self.device)
        self._writers = []
        if self.out_dir and self._is_main():
            self._writers.append(JsonlWriter(self.out_dir))
            if train_cfg.tensorboard:
                self._writers.append(TensorboardWriter(self.out_dir / "tb"))
        self.state_lock = threading.Lock()
        # Sharded, the viewer's thread asks the loop for the state: a
        # request is carried to every rank at a step boundary, the ranks
        # gather together, and rank 0 hands the copy over.
        self._view_request = threading.Event()
        self._view_ready = threading.Event()
        self._view_lock = threading.Lock()
        self._view_state = None
        self.viewer = None
        if train_cfg.viewer and self._is_main():
            from dnsplatter_torch.utils.viewer import Viewer

            self.viewer = Viewer(port=train_cfg.viewer_port)
            self.viewer.set_render_fn(self._orbit_render)
            print(f"viewer: http://127.0.0.1:{self.viewer.port}/", flush=True)

    # -- configuration ----------------------------------------------------

    @torch.no_grad()
    def _audit_pair_capacity(self) -> Optional[int]:
        """The largest raw (gaussian, tile) pair count over up to 8 sample
        frames times the margin, rounded up to the chunk (None if no frame
        shows a pair)."""
        tc = self.train_cfg
        n = len(self.data)
        if n == 0:
            return None
        idxs = sorted({(i * n) // min(8, n) for i in range(min(8, n))})
        p = self.params
        opac = torch.sigmoid(p.opacities)
        scales = torch.exp(p.scales)
        ts = float(tc.tile_size)
        worst = 0
        for i in idxs:
            cam, _ = self.data.get(i)
            proj = project_gaussians(
                p.means, p.quats, scales, cam.viewmat(), cam.fx, cam.fy,
                cam.cx, cam.cy, cam.width, cam.height, opacities=opac)
            r = proj.radii_xy
            m = proj.means2d
            tx = (torch.floor((m[:, 0] + r[:, 0]) / ts)
                  - torch.floor((m[:, 0] - r[:, 0]) / ts) + 1)
            ty = (torch.floor((m[:, 1] + r[:, 1]) / ts)
                  - torch.floor((m[:, 1] - r[:, 1]) / ts) + 1)
            ok = proj.valid & (self.alive > 0.5)
            cnt = torch.where(ok, tx * ty, 0.0).double().sum()
            worst = max(worst, int(cnt))
        self.audited_pairs = worst
        if worst <= 0:
            return None
        cap = int(worst * tc.auto_capacity_margin)
        if tc.devices > 1:
            # the tile-sharded renderer divides pair_capacity per slab
            # (parallel/tile_sharding.slab_config), and a dense slab can
            # hold most of a frame's pairs: size each for the whole frame
            cap *= tc.devices
        cap = max(cap, 1 << 16)
        return -(-cap // tc.chunk) * tc.chunk

    def _raster_cfg(self, camera: Camera,
                    pair_capacity: Optional[int] = None) -> RasterizeConfig:
        """The rasterizer's config for `camera`, at `pair_capacity` (default:
        the trainer's) rounded up to the chunk."""
        tc = self.train_cfg
        cap = tc.pair_capacity if pair_capacity is None else pair_capacity
        kw = {}
        if tc.compact_frac >= 0.0:
            kw["compact_frac"] = tc.compact_frac
        return RasterizeConfig(
            width=camera.width,
            height=camera.height,
            tile_size=tc.tile_size,
            chunk=tc.chunk,
            tile_block=tc.tile_block,
            pair_capacity=-(-cap // tc.chunk) * tc.chunk,
            backend="cuda" if tc.backend == "auto" else tc.backend,
            sort_scheme=tc.sort_scheme,
            **kw,
        )

    def orbit_camera(self, params: GaussianParams, alive: torch.Tensor,
                     az_deg: float, el_deg: float, radius: float,
                     scale: float = 1.0) -> Camera:
        """The viewer's orbit camera: frame 0's intrinsics at a 320-pixel
        width times `scale` (at most the frame's, at least 16 pixels),
        looking at the centroid of `params`' alive Gaussians from `radius`
        away at azimuth / elevation in degrees."""
        base = getattr(self, "_orbit_base", None)
        if base is None:
            base = self._orbit_base = self.data.get(0)[0]
        bw = max(base.width, 1)
        f = max(min(min(1.0, 320.0 / bw) * float(scale), 1.0), 16.0 / bw)
        small = base.rescaled(f)
        center = (torch.sum(params.means * alive[:, None], 0)
                  / torch.clamp(alive.sum(), min=1.0)).cpu().numpy()
        el, az = np.deg2rad(el_deg), np.deg2rad(az_deg)
        eye = center + np.float32(radius) * np.asarray(
            [np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)],
            np.float32)
        return Camera.create(small.fx, small.fy, small.cx, small.cy,
                             look_at(eye, center, device=self.device),
                             small.width, small.height, device=self.device)

    @torch.no_grad()
    def _orbit_render(self, az_deg: float, el_deg: float, radius: float,
                      scale: float = 1.0) -> Dict[str, np.ndarray]:
        """Viewer callback: render the current model from a user-driven
        orbit camera (`orbit_camera`) on the viewer's HTTP thread. The
        state is copied at a step boundary, under `state_lock`. Unlike the
        JAX package, which caps the render's pair list at 2^20, it renders
        at the trainer's audited pair capacity: a million Gaussians seen
        from an orbit can list more pairs than that, and an overflowing
        list drops Gaussians."""
        if self.mesh is not None:
            params, alive, pair_capacity = self._requested_state()
        else:
            with self.state_lock:
                params = GaussianParams(**{
                    f: getattr(self.params, f).clone() for f in FIELDS})
                alive = self.alive.clone()
                pair_capacity = self.train_cfg.pair_capacity
        cam = self.orbit_camera(params, alive, az_deg, el_deg, radius, scale)
        out, _ = get_outputs(
            params, alive, cam, self.model_cfg,
            self._raster_cfg(cam, pair_capacity),
            sh_degree=self.model_cfg.sh_degree, training=False,
            background=torch.zeros(3, device=self.device))
        return {k: out[k].cpu().numpy() for k in ("rgb", "depth", "normal")}

    def _requested_state(self, timeout: float = 120.0):
        """On the viewer's thread, sharded: the whole (params, alive) and
        the pair capacity, gathered by every rank at the next step
        boundary (`_serve_view`). This thread issues no collective."""
        with self._view_lock:
            self._view_ready.clear()
            self._view_request.set()
            if not self._view_ready.wait(timeout):
                raise TimeoutError("no step boundary came to gather the "
                                   "state for the viewer")
            return self._view_state

    def _serve_view(self) -> None:
        """At a step boundary, sharded, with the viewer on: one int all
        ranks of the Gaussian axis agree on says whether rank 0's viewer
        waits; if so they gather (params, alive) and rank 0 hands it over."""
        from dnsplatter_torch.parallel import collectives as C

        axis = self.mesh.gauss_axis
        flag = torch.tensor([float(self._view_request.is_set())],
                            device=self.device)
        if not profiling.host_read("view_flag", float,
                                   C.all_reduce_max(flag, axis)):
            return
        params, alive = self._full_params()
        if self.viewer is not None:
            # a copy: the loop may write the gathered tensors of one shard
            params = GaussianParams(**{f: getattr(params, f).clone()
                                       for f in FIELDS})
            self._view_state = (params, alive.clone(),
                                self.train_cfg.pair_capacity)
            self._view_request.clear()
            self._view_ready.set()

    # -- sharded state ----------------------------------------------------

    def _is_main(self) -> bool:
        """Checkpoints, writers and the viewer are rank 0's."""
        return self.dist is None or self.dist.is_main

    def _shard_state(self) -> None:
        """Keep this rank's rows of the (full, identical) state."""
        from dnsplatter_torch.parallel.distributed import shard_state_hybrid

        self.params, self.alive, self.adam, self.stats = shard_state_hybrid(
            self.mesh, self.params, self.alive, self.adam, self.stats)

    def _gather_state(self) -> None:
        """The full state on every rank (every rank must enter)."""
        from dnsplatter_torch.parallel.distributed import gather_state_hybrid

        self.params, self.alive, self.adam, self.stats = gather_state_hybrid(
            self.mesh, self.params, self.alive, self.adam, self.stats)

    def _full_params(self) -> Tuple[GaussianParams, torch.Tensor]:
        """The whole (params, alive): gathered when sharded (every rank
        must enter)."""
        if self.mesh is None:
            return self.params, self.alive
        from dnsplatter_torch.parallel.collectives import gather_state

        full = gather_state([getattr(self.params, f) for f in FIELDS]
                            + [self.alive], self.mesh.gauss_axis)
        return GaussianParams(**dict(zip(FIELDS, full))), full[-1]

    def _alive_count(self) -> int:
        """Alive Gaussians of the whole state (a sum over the Gaussian axis
        when sharded: every rank must enter)."""
        n = self.alive.sum().reshape(1)
        if self.mesh is not None:
            from dnsplatter_torch.parallel.collectives import all_reduce_sum

            n = all_reduce_sum(n, self.mesh.gauss_axis)
        return profiling.host_read("alive_count", int, n)

    # -- refinement -------------------------------------------------------

    def _refinement(self, camera: Camera) -> None:
        """Which refinement action fires after this step. Sharded, it runs
        on the gathered state, identical on every rank with the same
        draws, and the state is sharded again after it: O(state) bytes once
        every `refine_every` steps."""
        cfg = self.model_cfg
        step = self.step
        if step <= cfg.warmup_length or step % cfg.refine_every != 0:
            return
        with profiling.span("train.refine"):
            if self.mesh is not None:
                self._gather_state()
                try:
                    self._refine(camera)
                finally:
                    self._shard_state()
            else:
                self._refine(camera)

    def _refine(self, camera: Camera) -> None:
        cfg = self.model_cfg
        step = self.step
        reset_interval = cfg.reset_alpha_every * cfg.refine_every
        num_train = len(self.data)
        do_densify = (
            step < cfg.stop_split_at
            and step % reset_interval > num_train + cfg.refine_every)
        max_size = float(max(camera.width, camera.height))
        if do_densify:
            self.params, self.alive, self.adam, self.stats = densify_and_cull(
                cfg, self.params, self.alive, self.adam, self.stats, step,
                max_size, generator=self.device_generator)
            self._maybe_grow_capacity()
        elif (step >= cfg.stop_split_at
              and cfg.continue_cull_post_densification):
            self.params, self.alive, self.adam, self.stats = cull_only(
                cfg, self.params, self.alive, self.adam, self.stats, step)
        if (step < cfg.stop_split_at
                and step % reset_interval == cfg.refine_every):
            self.params, self.adam = reset_opacity(cfg, self.params,
                                                   self.adam)

    def _maybe_grow_capacity(self) -> bool:
        """Grow the Gaussian-state capacity after a densify event that
        comes within 5% of the ceiling. It runs right after
        `densify_and_cull`, where the statistics were just zeroed, so
        starting them anew at the new capacity is exact; new Adam slots
        have no history. Unlike the JAX package, the pair capacity is then
        audited again: a state that has room for more Gaussians would
        otherwise outgrow a pair list sized for the seed, and under depthq
        the overflow silently drops Gaussians in array order. Returns
        whether it grew."""
        tc = self.train_cfg
        if tc.capacity_growth <= 1.0:
            return False
        cap = self.params.capacity
        n_alive = profiling.host_read("alive_count", int, self.alive.sum())
        if n_alive < int(0.95 * cap):
            return False
        new_cap = int(np.ceil(cap * tc.capacity_growth / 4096) * 4096)
        self.params, self.alive = grow_capacity(self.params, self.alive,
                                                new_cap)
        self.adam = pad_adam(self.adam, new_cap - cap)
        self.stats = init_stats(new_cap, self.device)
        print(f"capacity grown: {cap} -> {new_cap} ({n_alive} alive)",
              flush=True)
        self._reaudit("after growth")
        return True

    def _reaudit(self, why: str) -> None:
        if not self.train_cfg.auto_pair_capacity:
            return
        cap = self._audit_pair_capacity()
        if cap is not None and cap != self.train_cfg.pair_capacity:
            self.train_cfg = dataclasses.replace(self.train_cfg,
                                                 pair_capacity=cap)
            print(f"auto pair capacity ({why}): {cap}", flush=True)

    # -- evaluation -------------------------------------------------------

    @torch.no_grad()
    def eval_image(self, index: int = 0, eval_data=None) -> Dict[str, float]:
        """Render one eval frame and compute quick metrics."""
        from dnsplatter_torch.eval import metrics as M

        with profiling.span("train.eval"):
            data = eval_data or self.data
            cam, batch = data.get(index % len(data))
            sh = sh_degree_to_use(self.step, self.model_cfg)
            params, alive = self._full_params()
            out, _ = get_outputs(
                params, alive, cam, self.model_cfg,
                self._raster_cfg(cam), sh_degree=sh, training=False,
                background=torch.zeros(3, device=self.device))
            if self.viewer is not None:
                self.viewer.update(images={
                    k: profiling.host_read("eval", out[k].cpu).numpy()
                    for k in ("rgb", "depth")})
            row = {f"rgb_{k}": v for k, v in M.rgb_metrics(
                out["rgb"], self._tensor(batch["image"])).items()}
            if "sensor_depth" in batch:
                row.update({f"depth_{k}": v for k, v in M.depth_metrics(
                    out["depth"],
                    self._tensor(batch["sensor_depth"])).items()})
            row["gaussian_count"] = profiling.host_read("eval", int,
                                                        alive.sum())
        return row

    # -- the loop ---------------------------------------------------------

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def _device_batch(self, idx: int, batch) -> Dict[str, torch.Tensor]:
        """Frame `idx`'s batch on the device, cached; dropped when the
        served batch's keys or shapes change (the downscale schedule)."""
        if not self.train_cfg.cache_batches_on_device:
            return {k: self._tensor(v) for k, v in batch.items()}
        sig = tuple(sorted((k, tuple(np.shape(v))) for k, v in batch.items()))
        hit = self._batch_cache.get(idx)
        if hit is not None and hit[0] == sig:
            return hit[1]
        dev = {k: self._tensor(v) for k, v in batch.items()}
        self._batch_cache[idx] = (sig, dev)
        return dev

    @property
    def cam_adj(self) -> torch.Tensor:
        """(n_cams, 6) current pose tangents."""
        return self.cam_opt.adj

    def train_one(self, cam: Camera, batch, cam_i, sh: Optional[int] = None
                  ) -> torch.Tensor:
        """One step on (cam, batch); returns the loss (a device scalar).
        `cam_i` keys the batch cache: the frame's index, or (index,
        downscale factor)."""
        if sh is None:
            sh = sh_degree_to_use(self.step, self.model_cfg)
        pose_opt = self.model_cfg.camera_optimizer_mode != "off"
        step_fn = functools.partial(train_step, self.model_cfg,
                                    self.optim_cfg, self._raster_cfg(cam),
                                    sh)
        with profiling.span("train.data"):
            batch = self._device_batch(cam_i, batch)
        if self.mesh is not None:
            from dnsplatter_torch.parallel import sharding, tile_sharding

            make = (tile_sharding.make_tile_train_step
                    if self.train_cfg.parallel_strategy == "tile"
                    else sharding.make_sharded_train_step)
            step_fn = make(self.model_cfg, self.optim_cfg,
                           self._raster_cfg(cam), sh, self.mesh)
        (self.params, self.adam, self.stats, loss, self.last_loss_dict
         ) = step_fn(
            self.params, self.alive, self.adam, self.stats, cam, batch,
            self.step, generator=self.generator,
            cam_state=self.cam_opt if pose_opt else None,
            cam_i=cam_i[0] if isinstance(cam_i, tuple) else cam_i)
        self.step += 1
        return loss

    def train(self, num_steps: Optional[int] = None, log_every: int = 100,
              eval_data=None):
        total = num_steps or self.train_cfg.max_iterations
        n = len(self.data)
        t0 = time.time()
        k_dispatch = max(1, self.train_cfg.steps_per_dispatch)
        if self.dp > 1:
            k_dispatch = 1  # the dp step already takes dp frames a step
        serve_view = self.mesh is not None and self.train_cfg.viewer
        target = self.step + total
        while self.step < target:
            d = self._downscale_factor()
            # k steps under one SH degree before the cadence is looked at
            # again (at full resolution only, as in the JAX package)
            k_now = min(k_dispatch, target - self.step) if d == 1 else 1
            sh = sh_degree_to_use(self.step, self.model_cfg)
            with self.state_lock:
                if self.dp > 1:
                    cam, loss = self._dispatch_dp(sh, n)
                else:
                    for _ in range(k_now):
                        cam_i = self.step % n
                        with profiling.span("train.data"):
                            cam, batch = self.data.get(cam_i)
                            if d > 1:
                                cam, batch = self._downscaled(cam_i, cam,
                                                              batch, d)
                                cam_i = (cam_i, d)
                        loss = self.train_one(cam, batch, cam_i, sh)
                self._refinement(cam)
                if serve_view:
                    self._serve_view()
            if self.step % log_every == 0 or self.step == target:
                with profiling.span("train.log"):
                    loss_v = profiling.host_read("loss", float, loss)
                    n_alive = self._alive_count()
                    dt = time.time() - t0
                    row = dict(step=self.step, loss=loss_v,
                               n_gaussians=n_alive, wall_s=round(dt, 2))
                    self._history.append(row)
                    for wtr in self._writers:
                        wtr.write_scalars(self.step, row)
                    if self.viewer is not None:
                        self.viewer.update(stats=row)
                    if self._is_main():
                        print(f"step {self.step:6d}  loss {loss_v:.4f}  "
                              f"gaussians {n_alive}  {dt:.1f}s", flush=True)
            spe = self.train_cfg.steps_per_eval_image
            if spe and self.step % spe == 0:
                m = self.eval_image(self.step // spe, eval_data)
                if self._is_main():
                    print(f"  eval @ {self.step}: psnr "
                          f"{m['rgb_psnr']:.2f} ssim {m['rgb_ssim']:.3f} "
                          f"gaussians {m['gaussian_count']}", flush=True)
                self._history.append(dict(step=self.step, **m))
                for wtr in self._writers:
                    wtr.write_scalars(self.step, m)
            sps = self.train_cfg.steps_per_save
            if self.out_dir and sps and self.step % sps == 0:
                self.save_checkpoint()
        if self.out_dir:
            self.save_checkpoint()
        return self._history

    def _dispatch_dp(self, sh: int, n: int):
        """One data-parallel step: dp rank r trains on frame
        (step * dp + r) % n, the gradients averaged over dp. Returns (this
        rank's camera, the mean loss)."""
        from dnsplatter_torch.parallel.distributed import make_dp_train_step

        dp = self.dp
        gidx = [(self.step * dp + r) % n for r in range(dp)]
        i = gidx[self.mesh.dp_axis.rank]
        with profiling.span("train.data"):
            cam, batch = self.data.get(i)
            batch = self._device_batch(i, batch)
        pose_opt = self.model_cfg.camera_optimizer_mode != "off"
        step_fn = make_dp_train_step(self.model_cfg, self.optim_cfg,
                                     self._raster_cfg(cam), sh, self.mesh)
        (self.params, self.adam, self.stats, loss, self.last_loss_dict
         ) = step_fn(self.params, self.alive, self.adam, self.stats, cam,
                     batch, self.step, generator=self.generator,
                     cam_state=self.cam_opt if pose_opt else None,
                     frame_idx=gidx)
        self.step += 1
        return cam, loss

    def _downscale_factor(self) -> int:
        """Progressive resolution (num_downscales / resolution_schedule;
        the DN-Splatter default is num_downscales = 0)."""
        cfg = self.model_cfg
        if cfg.num_downscales <= 0:
            return 1
        d = max(0, cfg.num_downscales - self.step // cfg.resolution_schedule)
        return 2 ** d

    def _downscaled(self, idx: int, cam: Camera, batch, d: int):
        key = (idx, d)
        if key in self._ds_cache:
            return self._ds_cache[key]
        from dnsplatter_torch.data.io import resize_image

        cam2 = cam.rescaled(1.0 / d)
        batch2 = {}
        for k, v in batch.items():
            v = np.asarray(v.cpu() if torch.is_tensor(v) else v)
            batch2[k] = resize_image(v if v.ndim == 3 else v[..., None],
                                     cam2.height, cam2.width,
                                     nearest=(k != "image"))
        self._ds_cache[key] = (cam2, batch2)
        return cam2, batch2

    # -- checkpoints (npz: the state is a flat dict of arrays) ------------

    def save_checkpoint(self, path: Optional[Path] = None) -> Path:
        """Write the state (the JAX package's npz keys) and config.json.
        Sharded, every rank must enter (the state is gathered) and rank 0
        alone writes; every rank returns the path."""
        path = Path(path) if path else (
            self.out_dir / f"ckpt_{self.step:06d}.npz")
        params, alive, adam = self.params, self.alive, self.adam
        if self.mesh is not None:
            from dnsplatter_torch.parallel.distributed import (
                gather_state_hybrid,
            )

            params, alive, adam, _ = gather_state_hybrid(
                self.mesh, params, alive, adam, self.stats)
        if not self._is_main():
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        flat = {f"params.{f}": a for f, a in params_to_numpy(params).items()}
        flat["alive"] = alive.cpu().numpy()
        flat["step"] = np.asarray(self.step)
        flat.update(cam_opt_to_numpy(self.cam_opt))
        flat.update(adam_to_numpy(adam))
        np.savez_compressed(path, **flat)
        meta = dataclasses.asdict(self.model_cfg)
        (path.parent / "config.json").write_text(json.dumps(meta, indent=2))
        return path

    def load_checkpoint(self, path: Path) -> None:
        with np.load(path) as z:
            self.params = params_from_numpy(
                {f: z[f"params.{f}"] for f in FIELDS}, device=self.device)
            self.alive = self._tensor(z["alive"])
            self.step = int(z["step"])
            self.adam = adam_from_numpy(
                {k: z[k] for k in z.files if k.startswith("adam.")},
                device=self.device)
            shape = tuple(self.cam_opt.adj.shape)
            if "cam_opt.adj" in z.files and z["cam_opt.adj"].shape == shape:
                self.cam_opt = cam_opt_from_numpy(
                    {k: z[k] for k in z.files if k.startswith("cam_opt.")},
                    device=self.device)
            elif "cam_adj" in z.files and z["cam_adj"].shape == shape:
                # older checkpoints stored only the tangents
                self.cam_opt.adj = self._tensor(z["cam_adj"])
        self.stats = init_stats(self.params.capacity, self.device)
        # A densified checkpoint can need a larger pair capacity than the
        # seed audit chose.
        self._reaudit("resume")
        if self.mesh is not None:
            self._shard_state()


def load_checkpoint_arrays(path: Path, device=None
                           ) -> Tuple[GaussianParams, torch.Tensor, int]:
    """(params, alive, step) from a checkpoint of either package, on
    `device` (None: the card): the loader for offline tools (evaluation,
    export)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        params = params_from_numpy({f: z[f"params.{f}"] for f in FIELDS},
                                   device=dev)
        alive = torch.as_tensor(np.asarray(z["alive"], np.float32),
                                device=dev)
        step = int(z["step"])
    return params, alive, step
