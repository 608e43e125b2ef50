"""dnsplatter_torch's multi-device training (`parallel/`, the Trainer's and
the CLI's multi-process modes, `utils/scaling.py`) against the port's
single-device path and the JAX package.

Real ranks: one 2-rank and one 4-rank gloo launch on localhost, each a
module-scoped fixture. The workers are this file run as a script under
the environment torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); each runs every case of its world in one process and saves
what it got, and the tests compare. The JAX side runs in the test process
on conftest's virtual CPU devices, fed the same numpy inputs.

    python tests/test_torch_parallel.py OUT_DIR [CAPTURE]   # one rank
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dnsplatter_torch.models.gaussians import FIELDS  # noqa: E402

# One process per core already runs the tests; intra-op threads only
# contend.
torch.set_num_threads(1)

W = H = 64
CAP = 256
SORTPACK = dict(rtol=2e-2, atol=2e-3)  # port (bf16-packed) vs JAX, scaled
# The train 1m step of PERF.md section 7 (chip_smoke.py phase 4 on an
# H100 80GB HBM3 at 700 W: 52-61 ms a step), the low end.
H100_STEP_MS_1M = 52.0


# -- shared inputs (built the same in the workers and the test process) ----


def _step_inputs(n_cams=2, camera_opt=False, sh=1, capacity=CAP, n_pts=200):
    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig
    from dnsplatter_torch.models.gaussians import init_from_points
    from dnsplatter_torch.ops.rasterize import RasterizeConfig

    scene = make_synthetic_scene(seed=0, n_gaussians=200, n_cameras=n_cams,
                                 width=W, height=H, pair_capacity=1 << 12,
                                 device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    params, alive, _ = init_from_points(np.random.default_rng(1), pts, cols,
                                        sh_degree=sh, capacity=capacity,
                                        device="cpu")
    mc = ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                     use_normal_loss=True, sh_degree=sh,
                     background_color="black",
                     camera_optimizer_mode="SO3xR3" if camera_opt else "off")
    rc = RasterizeConfig(width=W, height=H, tile_size=16, chunk=32,
                         tile_block=4, pair_capacity=1 << 13)
    return scene, params, alive, mc, rc


def _render_inputs():
    from dnsplatter_torch.data.synthetic import make_gt_gaussians, ring_cameras
    from dnsplatter_torch.ops.rasterize import RasterizeConfig

    params, alive = make_gt_gaussians(np.random.default_rng(0), 512,
                                      device="cpu")
    cam = ring_cameras(1, width=W, img_height=H, device="cpu")[0]
    cfg = RasterizeConfig(width=W, height=H, tile_size=16, chunk=32,
                          tile_block=2, pair_capacity=1 << 14)
    return params, alive, cam, cfg


def _trainer_inputs(n_cams):
    from dnsplatter_torch.data.synthetic import make_synthetic_scene
    from dnsplatter_torch.models.dn_model import ModelConfig

    scene = make_synthetic_scene(seed=0, n_gaussians=300, n_cameras=n_cams,
                                 width=W, height=H, pair_capacity=1 << 13,
                                 device="cpu")
    pts, cols = scene.seed_points(np.random.default_rng(1), noise=0.03)
    mc = ModelConfig(use_depth_loss=True, depth_lambda=0.2,
                     use_normal_loss=True, sh_degree=1, warmup_length=2,
                     refine_every=8, densify_grad_thresh=1e-6,
                     densify_size_thresh=1e-4)
    return scene, (pts, cols), mc


TRAIN_KW = dict(pair_capacity=1 << 13, chunk=32, tile_block=4, seed=5,
                steps_per_eval_image=0)


def _batch(scene, i):
    cam, b = scene.get(i)
    return cam, {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def _np_params(p):
    return {f: getattr(p, f).detach().cpu().numpy() for f in FIELDS}


def _state_bytes(params, adam) -> int:
    return sum(getattr(t, f).numel() * 4 for t in
               (params, adam.mu, adam.nu, adam.accum) for f in FIELDS)


# -- the worker side ---------------------------------------------------------


def _fresh_state(mesh, params, alive, shard=None):
    from dnsplatter_torch.parallel import distributed as D
    from dnsplatter_torch.train.optim import init_adam
    from dnsplatter_torch.train.strategy import init_stats

    return (shard or D.shard_state_hybrid)(
        mesh, params, alive, init_adam(params),
        init_stats(params.capacity, "cpu"))


def _full(mesh, shard_params, stats):
    from dnsplatter_torch.parallel import distributed as D

    return ({f: D.host_local_value(getattr(shard_params, f), mesh)
             for f in FIELDS},
            {k: D.host_local_value(getattr(stats, k), mesh)
             for k in ("grad_sum", "vis_count", "max_2d")})


def _w_tile_render(out_dir, capture):
    from dnsplatter_torch.parallel import sharding as S
    from dnsplatter_torch.parallel import tile_sharding as T
    from dnsplatter_torch.parallel.distributed import shard_rows

    mesh = S.make_mesh()
    params, alive, cam, cfg = _render_inputs()
    ax = mesh.gauss_axis
    leaves = {f: shard_rows(getattr(params, f), ax).requires_grad_(True)
              for f in FIELDS}
    p = dataclasses.replace(params, **leaves)
    img, alpha = T.tile_sharded_render(p, shard_rows(alive, ax), cam, cfg,
                                       mesh, sh_degree=1)
    loss = torch.sum(img ** 2) + torch.sum(alpha)
    grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS],
                                allow_unused=True)
    return {"img": img.detach().numpy(), "alpha": alpha.detach().numpy(),
            "grads": {f: (np.zeros(tuple(leaves[f].shape), np.float32)
                          if g is None else g.numpy())
                      for f, g in zip(FIELDS, grads)}}


def _w_step(kind, mesh=None, sh=1, capacity=CAP, n_pts=200):
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import sharding as S
    from dnsplatter_torch.parallel import tile_sharding as T
    from dnsplatter_torch.train.optim import OptimConfig

    mesh = mesh or S.make_mesh()
    scene, params, alive, mc, rc = _step_inputs(sh=sh, capacity=capacity,
                                                n_pts=n_pts)
    p, a, adam, stats = _fresh_state(mesh, params, alive,
                                     S.shard_gaussian_state)
    cam, batch = _batch(scene, 0)
    make = (T.make_tile_train_step if kind == "tile"
            else S.make_sharded_train_step)
    fn = make(mc, OptimConfig(), rc, sh, mesh)
    arg_bytes = (sum(getattr(t, f).numel() * 4 for t in
                     (p, adam.mu, adam.nu, adam.accum) for f in FIELDS)
                 + a.numel() * 4 + 3 * stats.grad_sum.numel() * 4
                 + sum(v.numel() * 4 for v in batch.values())
                 + cam.c2w.numel() * 4)
    C.LOG.clear()
    new_p, _, new_stats, loss, _ = fn(p, a, adam, stats, cam, batch, 0)
    log = list(C.LOG)
    full_p, full_s = _full(mesh, new_p, new_stats)
    return {"params": full_p, "stats": full_s, "loss": float(loss),
            "log": log, "arg_bytes": arg_bytes}


def _w_dp_step(dp):
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import distributed as D
    from dnsplatter_torch.train.optim import OptimConfig, init_cam_opt

    scene, params, alive, mc, rc = _step_inputs(camera_opt=True)
    mesh = D.make_hybrid_mesh(dp=dp)
    p, a, adam, stats = _fresh_state(mesh, params, alive)
    frames = list(range(dp))
    # this rank's frame only: host-local loading
    local = D.host_local_indices(dp, D.DistContext(mesh.dp_axis.rank, dp,
                                                   True))
    cams, batches = zip(*[scene.get(i) for i in local])
    cam, batch = D.stack_frames(mesh, cams, batches, "cpu")
    cam_state = init_cam_opt(len(scene), "cpu")
    fn = D.make_dp_train_step(mc, OptimConfig(), rc, 1, mesh)
    C.LOG.clear()
    new_p, _, new_stats, loss, _ = fn(p, a, adam, stats, cam, batch, 0,
                                      cam_state=cam_state, frame_idx=frames)
    log = list(C.LOG)
    full_p, full_s = _full(mesh, new_p, new_stats)
    return {"params": full_p, "stats": full_s, "loss": float(loss),
            "cam_accum": cam_state.accum.numpy(), "local": local,
            "log": log, "mesh": mesh.shape}


def _w_trainer(out_dir, rank, **train_kw):
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    scene, seeds, mc = _trainer_inputs(4 if train_kw.get("dp") else 2)
    rdir = Path(out_dir) / f"trainer_{'dp' if train_kw.get('dp') else 'gs'}" \
        f"_rank{rank}"
    tr = Trainer(scene, seeds, model_cfg=mc,
                 train_cfg=TrainConfig(**TRAIN_KW, **train_kw), out_dir=rdir,
                 device="cpu")
    n0 = tr._alive_count()
    init_ckpt = tr.save_checkpoint(rdir / "ckpt_init.npz")
    steps, every = (18, 6) if train_kw.get("dp") else (20, 20)
    hist = tr.train(num_steps=steps, log_every=every)
    return {"n0": n0, "alive": tr._alive_count(), "mesh": tr.mesh.shape,
            "losses": [h["loss"] for h in hist if "loss" in h],
            "shard_rows": tr.params.capacity, "init_ckpt": str(init_ckpt),
            "files": sorted(x.name for x in rdir.glob("*"))
            if rdir.exists() else [],
            "finite": bool(all(torch.isfinite(getattr(tr.params, f)).all()
                               for f in FIELDS))}


def _w_cli(out_dir, rank, capture):
    from dnsplatter_torch import cli as tcli

    run = Path(out_dir) / f"cli_rank{rank}"
    t = tcli.cmd_train([
        "dn-splatter", "mushroom", "--data", str(capture), "--output-dir",
        str(run), "--max-iterations", "4", "--device", "cpu",
        "--parser.num-init-points", "512", "--model.sh-degree", "1",
        "--train.chunk", "32", "--train.tile-block", "2",
        "--train.steps-per-eval-image", "0", "--train.dp", "2"])
    return {"step": t.step, "dp": t.dp,
            "files": sorted(x.name for x in run.glob("ckpt_*.npz"))
            if run.exists() else []}


def _worker(out_dir: Path, capture) -> None:
    from dnsplatter_torch.parallel import distributed as D

    ctx = D.init_distributed(device="cpu")  # from the launch environment
    r = ctx.process_index
    res = {"rank": r, "world": ctx.process_count, "is_main": ctx.is_main,
           "backend": ctx.backend}
    try:
        if ctx.process_count == 2:
            res["tile_render"] = _w_tile_render(out_dir, capture)
            res["gspmd_step"] = _w_step("gspmd")
            res["tile_step"] = _w_step("tile")
            res["dp_step"] = _w_dp_step(2)
            res["trainer_gspmd"] = _w_trainer(out_dir, r, devices=2)
            res["trainer_dp"] = _w_trainer(out_dir, r, dp=2,
                                           auto_pair_capacity=False)
            res["cli"] = _w_cli(out_dir, r, capture)
        else:
            res["hybrid_step"] = _w_dp_step(2)
            # 1-D over four ranks at SH 3: the layout's byte bounds
            res["gspmd_sh3"] = _w_step("gspmd", sh=3, capacity=8192,
                                       n_pts=4096)
    except Exception:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, out_dir / f"rank{r}.pt")
    D.shutdown_distributed()


# -- the launches -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, out_dir: Path, capture=None, timeout=400):
    out_dir.mkdir(parents=True, exist_ok=True)
    port = str(_free_port())
    procs, logs = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        log = open(out_dir / f"rank{r}.log", "w")
        logs.append(log)
        args = [sys.executable, __file__, str(out_dir)]
        if capture is not None:
            args.append(str(capture))
        procs.append(subprocess.Popen(args, env=env, cwd=REPO, stdout=log,
                                      stderr=subprocess.STDOUT))
    # One rank failing before a collective leaves the others waiting: bound
    # the whole launch and always reap every worker.
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline
                                            - time.monotonic())))
    except subprocess.TimeoutExpired:
        codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    tails = "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:]
                      for r in range(world))
    assert codes == [0] * world, f"exit codes {codes}:\n{tails}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    from test_torch_cli import _write_capture

    root = tmp_path_factory.mktemp("parallel2")
    capture = root / "capture"
    capture.mkdir()
    _write_capture(capture)
    return _launch(2, root / "out", capture)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _launch(4, tmp_path_factory.mktemp("parallel4"))


# -- JAX helpers --------------------------------------------------------------


def _jax_params(np_params):
    import jax.numpy as jnp

    from dnsplatter_tpu.models.gaussians import GaussianParams as JParams

    return JParams(**{f: jnp.asarray(v) for f, v in np_params.items()})


def _jax_cam(cam):
    from dnsplatter_tpu.ops.camera import Camera as JCamera

    return JCamera.create(float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), cam.c2w.numpy(), cam.width,
                          cam.height)


def _jax_cfg(rc):
    from dnsplatter_tpu.ops.rasterize import RasterizeConfig as JRC

    return JRC(width=rc.width, height=rc.height, tile_size=rc.tile_size,
               chunk=rc.chunk, tile_block=rc.tile_block,
               pair_capacity=rc.pair_capacity)


def _jax_model_cfg(mc):
    from dnsplatter_tpu.models.dn_model import ModelConfig as JMC

    return JMC(**dataclasses.asdict(mc))


def _jax_mesh_state(mesh, np_params, alive):
    import jax
    import jax.numpy as jnp

    from dnsplatter_tpu.train.optim import init_adam
    from dnsplatter_tpu.train.strategy import init_stats

    gs = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        "gauss"))
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    put = lambda t: jax.device_put(  # noqa: E731
        t, gs if getattr(t, "ndim", 0) >= 1 else rep)
    p = _jax_params(np_params)
    return (jax.tree.map(put, p), put(jnp.asarray(alive)),
            jax.tree.map(put, init_adam(p)),
            jax.tree.map(put, init_stats(np_params["means"].shape[0])))


@pytest.fixture(scope="module")
def jax_tile_render():
    """The JAX package's tile_sharded_render on two virtual devices of the
    render inputs, and jax.grad of sum(img^2) + sum(alpha) through it: one
    jitted compile (op by op, the shard_map compiles for a minute)."""
    import jax
    import jax.numpy as jnp

    from dnsplatter_tpu.parallel.sharding import make_mesh
    from dnsplatter_tpu.parallel.tile_sharding import tile_sharded_render

    params, alive, cam, cfg = _render_inputs()
    mesh = make_mesh(jax.devices()[:2])
    jp, ja, _, _ = _jax_mesh_state(mesh, _np_params(params), alive.numpy())
    jcam, jcfg = _jax_cam(cam), _jax_cfg(cfg)

    def loss(p):
        img, alpha = tile_sharded_render(p, ja, jcam, jcfg, mesh,
                                         sh_degree=1)
        return jnp.sum(img ** 2) + jnp.sum(alpha), (img, alpha)

    (_, (img, alpha)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jp)
    return (np.asarray(img), np.asarray(alpha),
            {f: np.asarray(getattr(grads, f)) for f in FIELDS})


def _scaled_close(got, want, rtol, atol, msg=""):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, rtol=rtol,
                               atol=atol, err_msg=msg)


# -- port references (single device, this process) --------------------------


def _single_step(sh=1, capacity=CAP, n_pts=200):
    from dnsplatter_torch.train.optim import OptimConfig, init_adam
    from dnsplatter_torch.train.strategy import init_stats
    from dnsplatter_torch.train.trainer import train_step

    scene, params, alive, mc, rc = _step_inputs(sh=sh, capacity=capacity,
                                                n_pts=n_pts)
    cam, batch = _batch(scene, 0)
    adam = init_adam(params)
    new_p, _, stats, loss, _ = train_step(mc, OptimConfig(), rc, sh, params,
                                          alive, adam,
                                          init_stats(capacity, "cpu"), cam,
                                          batch, 0)
    return {"params": _np_params(new_p), "loss": float(loss),
            "stats": {k: getattr(stats, k).numpy()
                      for k in ("grad_sum", "vis_count", "max_2d")},
            "state_bytes": _state_bytes(params, adam)}


def _frame_average_step():
    """One Adam step on the mean of frames 0 and 1's gradients, the
    statistics combined as two sequential steps, the pose gradients added
    to their cameras: the DDP semantics, on one device."""
    from dnsplatter_torch.models.gaussians import GaussianParams
    from dnsplatter_torch.train.optim import (
        OptimConfig,
        cam_opt_update,
        init_adam,
        init_cam_opt,
    )
    from dnsplatter_torch.train.strategy import init_stats
    from dnsplatter_torch.train.trainer import apply_gradients, loss_and_grads

    scene, params, alive, mc, rc = _step_inputs(camera_opt=True)
    outs, gadj = [], []
    for i in (0, 1):
        cam, batch = _batch(scene, i)
        adj = torch.zeros(6, requires_grad=True)
        outs.append(loss_and_grads(mc, rc, 1, params, alive, cam, batch, 0,
                                   cam_adj=adj))
        gadj.append(adj.grad)
    g = GaussianParams(**{f: (getattr(outs[0][2], f)
                              + getattr(outs[1][2], f)) / 2.0
                          for f in FIELDS})
    new_p, _, stats = apply_gradients(
        OptimConfig(), rc, params, alive, init_adam(params),
        init_stats(CAP, "cpu"), g, outs[0][3] + outs[1][3],
        torch.maximum(outs[0][4].radii, outs[1][4].radii),
        outs[0][4].valid | outs[1][4].valid, 0)
    cams = init_cam_opt(len(scene), "cpu")
    cam_opt_update(OptimConfig(), cams, torch.tensor([0, 1]),
                   torch.stack(gadj), 0)
    return {"params": _np_params(new_p),
            "loss": float((outs[0][0] + outs[1][0]) / 2.0),
            "stats": {k: getattr(stats, k).numpy()
                      for k in ("grad_sum", "vis_count", "max_2d")},
            "cam_accum": cams.accum.numpy()}


def _assert_step_close(got, want, params_rtol=5e-4, params_atol=2e-6):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f], want["params"][f],
                                   rtol=params_rtol, atol=params_atol,
                                   err_msg=f)
    np.testing.assert_array_equal(got["stats"]["vis_count"],
                                  want["stats"]["vis_count"])
    np.testing.assert_allclose(got["stats"]["max_2d"],
                               want["stats"]["max_2d"], rtol=1e-6)
    np.testing.assert_allclose(got["stats"]["grad_sum"],
                               want["stats"]["grad_sum"], rtol=5e-4,
                               atol=1e-7)


# -- the tests ----------------------------------------------------------------


def test_degenerate_context_and_host_local_indices():
    """The single process: no process group, rank 0 of 1, every frame its
    own; the strided shard of a 3-process world (JAX test_parallel.py:
    130-142); a mesh without a world and its identity collectives."""
    from dnsplatter_torch.parallel import collectives as C
    from dnsplatter_torch.parallel import distributed as D

    ctx = D.init_distributed()
    assert ctx.process_count == 1 and ctx.process_index == 0
    assert ctx.is_main and D.is_main_process() and not ctx.initialized
    assert D.init_distributed() is ctx
    assert D.host_local_indices(7) == list(range(7))
    fake = D.DistContext(process_index=1, process_count=3, initialized=True)
    assert D.host_local_indices(8, fake) == [1, 4, 7]
    mesh = D.make_hybrid_mesh()
    assert mesh.shape == {"dp": 1, "gauss": 1}
    x = torch.arange(6.0).reshape(3, 2)
    assert C.all_gather_rows(x, mesh.gauss_axis) is x
    assert C.all_reduce_mean(x, mesh.dp_axis) is x
    with pytest.raises(ValueError, match="divisible by dp=2"):
        D.make_hybrid_mesh(dp=2)
    with pytest.raises(ValueError, match="not divisible by 3"):
        D.shard_rows(torch.zeros(4), C.Axis(3, 0))


@pytest.mark.parametrize("cfg_kw,n", [
    (dict(width=64, height=64, chunk=32, pair_capacity=1 << 14), 2),
    (dict(width=1024, height=576, chunk=128, pair_capacity=19_554_816), 4),
    (dict(width=100, height=70, chunk=64, pair_capacity=5000), 3),
    (dict(width=48, height=40, tile_size=8, chunk=16,
          pair_capacity=1 << 12), 8),
])
def test_slab_config_matches_jax(cfg_kw, n):
    from dnsplatter_torch.ops.rasterize import RasterizeConfig
    from dnsplatter_torch.parallel.tile_sharding import slab_config
    from dnsplatter_tpu.ops.rasterize import RasterizeConfig as JRC
    from dnsplatter_tpu.parallel.tile_sharding import slab_config as jslab

    tcfg, th = slab_config(RasterizeConfig(**cfg_kw), n)
    jcfg, jh = jslab(JRC(**cfg_kw), n)
    assert th == jh
    assert (tcfg.width, tcfg.height, tcfg.pair_capacity, tcfg.chunk) == (
        jcfg.width, jcfg.height, jcfg.pair_capacity, jcfg.chunk)


def test_tile_sharded_render_matches_single_and_jax(runs2, jax_tile_render):
    """Two ranks' slabs assembled: the raw composite of the single-device
    render (rtol 1e-4 / atol 1e-5, as JAX test_parallel.py:55) and of the
    JAX package's tile_sharded_render on two virtual devices; one slab's
    `tile_sharded_outputs` equal to `get_outputs`."""
    from dnsplatter_torch.models.dn_model import ModelConfig, get_outputs
    from dnsplatter_torch.ops.render import render
    from dnsplatter_torch.parallel.distributed import make_hybrid_mesh
    from dnsplatter_torch.parallel.tile_sharding import tile_sharded_outputs

    params, alive, cam, cfg = _render_inputs()
    got = runs2[0]["tile_render"]
    np.testing.assert_array_equal(got["img"], runs2[1]["tile_render"]["img"])
    with torch.no_grad():
        out, _ = render(params, alive, cam, cfg, sh_degree_to_use=1)
    np.testing.assert_allclose(got["img"][..., :3], out.rgb.numpy(),
                               rtol=1e-4, atol=1e-5)
    jimg, jalpha, _ = jax_tile_render
    np.testing.assert_allclose(got["img"], jimg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["alpha"], jalpha, rtol=1e-4, atol=1e-5)
    # the outputs dict on the single process's mesh is get_outputs'
    mc = ModelConfig(sh_degree=1)
    with torch.no_grad():
        want, _ = get_outputs(params, alive, cam, mc, cfg, sh_degree=1,
                              training=False)
        outs, info = tile_sharded_outputs(params, alive, cam, mc, cfg,
                                          make_hybrid_mesh(), sh_degree=1,
                                          training=False)
    for k in want:
        torch.testing.assert_close(outs[k], want[k], rtol=0, atol=0,
                                   msg=k)
    assert info.radii.shape == (512,)


def test_tile_sharded_gradients_match_single_and_jax(runs2, jax_tile_render):
    """d(sum img^2 + sum alpha): each rank's rows of the gradient, summed
    over the two slabs, against one device (the same bf16-packed per-pair
    gradients, summed in another grouping: rtol 1e-4 / atol 1e-6 of each
    field's scale) and against jax.grad through the JAX tile render. There
    the port's bf16-packed per-pair gradients meet XLA's float32 ones at
    the sortpack tolerance but for a few cancelling sums (2 of 1,536 mean
    coordinates, 4e-3 of the scale, on one device as on two), so the test
    holds that share and that the two ranks lie exactly as far from JAX
    as one device does."""
    from dnsplatter_torch.parallel.distributed import make_hybrid_mesh
    from dnsplatter_torch.parallel.tile_sharding import tile_sharded_render

    params, alive, cam, cfg = _render_inputs()
    got = {f: np.concatenate([r["tile_render"]["grads"][f] for r in runs2])
           for f in FIELDS}
    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in FIELDS}
    # the single process's mesh: one slab, the ordinary render
    img, alpha = tile_sharded_render(dataclasses.replace(params, **leaves),
                                     alive, cam, cfg, make_hybrid_mesh(),
                                     sh_degree=1)
    loss = torch.sum(img ** 2) + torch.sum(alpha)
    grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS],
                                allow_unused=True)
    want = {f: (np.zeros(tuple(leaves[f].shape), np.float32) if g is None
                else g.numpy()) for f, g in zip(FIELDS, grads)}
    assert np.abs(got["means"]).sum() > 0
    _, _, jgrads = jax_tile_render
    for f in FIELDS:
        _scaled_close(got[f], want[f], 1e-4, 1e-6, f)
        jg = jgrads[f]
        scale = max(float(np.abs(jg).max()), 1e-12)
        e_two = np.abs(got[f] - jg) / scale
        e_one = np.abs(want[f] - jg) / scale
        np.testing.assert_allclose(e_two, e_one, rtol=0, atol=1e-5,
                                   err_msg=f)
        miss = e_one > SORTPACK["atol"] + SORTPACK["rtol"] * np.abs(jg) / scale
        assert miss.mean() <= 2e-3 and e_one.max() < 1e-2, (f, e_one.max())


def test_gspmd_step_matches_single_device(runs2, runs4):
    """The gspmd step on two ranks, and on four at SH 3 / capacity 8192
    (JAX test_parallel.py:275-330's scene), against one device: loss,
    updated parameters, statistics. At four ranks the step's collectives
    move under state / 8 (one gather of 24 float32 a Gaussian, nothing of
    the SH-bearing state) and a rank's arguments are under state / 2."""
    want = _single_step()
    for r in runs2:
        _assert_step_close(r["gspmd_step"], want)
        assert [x["op"] for x in r["gspmd_step"]["log"]] == ["all_gather"]
    want3 = _single_step(sh=3, capacity=8192, n_pts=4096)
    state = want3["state_bytes"]
    for r in runs4:
        got = r["gspmd_sh3"]
        _assert_step_close(got, want3)
        coll = sum(x["bytes"] for x in got["log"])
        assert coll == 8192 * 24 * 4
        assert coll < state / 8, (coll, state, got["log"])
        assert got["arg_bytes"] < state / 2, (got["arg_bytes"], state)


def test_tile_step_matches_single_device_and_jax(runs2):
    """The tile step on two ranks against one device (JAX test_parallel.py
    :333's tolerances) and against the JAX package's make_tile_train_step
    on two virtual devices (loss, visibility, screen radii, the absgrad
    statistic at the sortpack tolerance)."""
    import jax
    import jax.numpy as jnp

    from dnsplatter_tpu.parallel.sharding import make_mesh
    from dnsplatter_tpu.parallel.tile_sharding import make_tile_train_step
    from dnsplatter_tpu.train.optim import OptimConfig as JOC
    from dnsplatter_tpu.train.optim import init_cam_opt

    got = runs2[0]["tile_step"]
    _assert_step_close(got, _single_step())
    for f in FIELDS:
        np.testing.assert_array_equal(got["params"][f],
                                      runs2[1]["tile_step"]["params"][f])
    scene, params, alive, mc, rc = _step_inputs()
    cam, batch = scene.get(0)
    mesh = make_mesh(jax.devices()[:2])
    jp, ja, jadam, jstats = _jax_mesh_state(mesh, _np_params(params),
                                            alive.numpy())
    fn = make_tile_train_step(_jax_model_cfg(mc), JOC(), _jax_cfg(rc), 1,
                              mesh)
    _, _, js, jloss, _, _ = fn(
        jp, ja, jadam, jstats, _jax_cam(cam),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32), jax.random.PRNGKey(3), init_cam_opt(1),
        jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(got["stats"]["vis_count"],
                                  np.asarray(js.vis_count))
    np.testing.assert_allclose(got["stats"]["max_2d"],
                               np.asarray(js.max_2d), rtol=1e-5)
    _scaled_close(got["stats"]["grad_sum"], np.asarray(js.grad_sum),
                  **SORTPACK)


def test_dp_step_matches_frame_average_and_jax(runs2):
    """dp 2 with the pose optimizer (SO3xR3), each rank loading only its
    own frame: both ranks agree, and match one Adam step on the average of
    the two frames' gradients (loss rtol 1e-6, parameters rtol 2e-4 / atol
    1e-6 as JAX test_parallel.py:144) with the pose gradients added to
    their cameras; and the JAX package's make_dp_train_step on a (dp 2,
    gauss 2) mesh of virtual devices (loss, statistics, pose gradients at
    the sortpack tolerance)."""
    import jax
    import jax.numpy as jnp

    from dnsplatter_tpu.parallel import distributed as JD
    from dnsplatter_tpu.train.optim import OptimConfig as JOC
    from dnsplatter_tpu.train.optim import init_cam_opt

    a, b = (r["dp_step"] for r in runs2)
    assert a["local"] == [0] and b["local"] == [1]
    assert a["loss"] == b["loss"]
    for f in FIELDS:
        np.testing.assert_array_equal(a["params"][f], b["params"][f])
    np.testing.assert_array_equal(a["cam_accum"], b["cam_accum"])
    want = _frame_average_step()
    np.testing.assert_allclose(a["loss"], want["loss"], rtol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(a["params"][f], want["params"][f],
                                   rtol=2e-4, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(a["stats"]["grad_sum"],
                               want["stats"]["grad_sum"], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(a["cam_accum"], want["cam_accum"], rtol=1e-5,
                               atol=1e-7)
    assert np.abs(a["cam_accum"]).sum() > 0  # pose gradients landed
    # pure dp renders as one device: every collective is on the dp axis,
    # the only gather the poses' (frame index + 6 tangent floats a rank)
    assert {r["axis_size"] for r in a["log"]} == {2}
    assert [r["shape"] for r in a["log"]
            if r["op"] == "all_gather"] == ["2,7"]

    scene, params, alive, mc, rc = _step_inputs(camera_opt=True)
    mesh = JD.make_hybrid_mesh(dp=2, devices=jax.devices()[:4])
    jp, ja, jadam, jstats = JD.shard_state_hybrid(
        mesh, *_jax_mesh_state(mesh, _np_params(params), alive.numpy()))
    cams, batches = zip(*[scene.get(i) for i in range(2)])
    cam_g, batch_g = JD.stack_frames(mesh, [_jax_cam(c) for c in cams],
                                     batches)
    keys = jax.device_put(jax.random.split(jax.random.PRNGKey(7), 2),
                          jax.sharding.NamedSharding(
                              mesh, jax.sharding.PartitionSpec("dp")))
    fn = JD.make_dp_train_step(_jax_model_cfg(mc), JOC(), _jax_cfg(rc), 1,
                               mesh)
    _, _, js, jloss, jcam = fn(jp, ja, jadam, jstats, cam_g, batch_g,
                               jnp.asarray(0, jnp.int32), keys,
                               init_cam_opt(2),
                               jnp.arange(2, dtype=jnp.int32))
    np.testing.assert_allclose(a["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(a["stats"]["vis_count"],
                                  np.asarray(js.vis_count))
    _scaled_close(a["stats"]["grad_sum"], np.asarray(js.grad_sum),
                  **SORTPACK)
    _scaled_close(a["cam_accum"], np.asarray(jcam.accum), **SORTPACK)


def test_sharded_trainer_through_refinement(runs2, tmp_path):
    """Trainer(devices=2) through a densify event (JAX test_parallel.py:84):
    the alive count moved and equals the single-process Trainer's, the loss
    within rtol 5e-2; only rank 0 writes, and its checkpoints are the
    single-process one's key for key (at step 0 bit-equal)."""
    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    scene, seeds, mc = _trainer_inputs(2)
    single = Trainer(scene, seeds, model_cfg=mc,
                     train_cfg=TrainConfig(**TRAIN_KW), out_dir=tmp_path,
                     device="cpu")
    ck0 = single.save_checkpoint(tmp_path / "ckpt_init.npz")
    hist = single.train(num_steps=20, log_every=20)
    a, b = (r["trainer_gspmd"] for r in runs2)
    assert a["mesh"] == {"dp": 1, "gauss": 2}
    assert a["shard_rows"] * 2 == single.params.capacity
    assert a["finite"] and np.isfinite(a["losses"]).all()
    assert a["n0"] == int(single.alive.sum()) or a["alive"] != a["n0"]
    assert a["alive"] != a["n0"], "the densify event changed nothing"
    assert a["alive"] == b["alive"] == int(single.alive.sum())
    np.testing.assert_allclose(a["losses"][-1], hist[-1]["loss"], rtol=5e-2)
    assert b["files"] == []
    assert a["files"] == sorted(["ckpt_init.npz", "ckpt_000020.npz",
                                 "config.json", "metrics.jsonl"])
    with np.load(a["init_ckpt"]) as z0, np.load(ck0) as w0:
        assert sorted(z0.files) == sorted(w0.files)
        for k in w0.files:
            np.testing.assert_array_equal(z0[k], w0[k], err_msg=k)
    final = Path(a["init_ckpt"]).parent / "ckpt_000020.npz"
    with np.load(final) as z, np.load(tmp_path / "ckpt_000020.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        for k in w.files:
            assert z[k].shape == w[k].shape and z[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(z["alive"], w["alive"])
        assert int(z["step"]) == 20


def test_trainer_dp_mode(runs2):
    """Trainer(dp=2) through a densify event (JAX test_parallel.py:233):
    finite, falling loss, the alive count changed, both ranks agree."""
    a, b = (r["trainer_dp"] for r in runs2)
    assert a["mesh"] == {"dp": 2, "gauss": 1}
    assert a["finite"] and np.isfinite(a["losses"]).all()
    assert a["losses"][-1] < a["losses"][0]
    assert a["alive"] != a["n0"]
    assert a["losses"] == b["losses"] and a["alive"] == b["alive"]
    assert b["files"] == [] and "ckpt_000018.npz" in a["files"]


def test_hybrid_step_matches_two_frame_average(runs4):
    """Four ranks as dp 2 x gauss 2 with the pose optimizer, each rank its
    own frame: every rank agrees, and the step equals one device's
    two-frame average (JAX test_distributed_multiprocess.py:66, rtol
    2e-5)."""
    want = _frame_average_step()
    got = [r["hybrid_step"] for r in runs4]
    assert got[0]["mesh"] == {"dp": 2, "gauss": 2}
    assert [g["local"] for g in got] == [[0], [0], [1], [1]]
    for g in got:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=2e-5,
                                   atol=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(g["params"][f], want["params"][f],
                                       rtol=2e-4, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(g["cam_accum"], want["cam_accum"],
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_array_equal(g["params"]["means"],
                                      got[0]["params"]["means"])


def test_viewer_orbit_render_waits_for_a_step_boundary():
    """Sharded (here the one-rank mesh of `distributed` alone), the
    viewer's thread issues no collective: its orbit render waits for the
    loop to gather the state at the next step boundary, then renders the
    copy on its own thread."""
    import threading

    from dnsplatter_torch.train.trainer import TrainConfig, Trainer

    scene, seeds, mc = _trainer_inputs(2)
    tr = Trainer(scene, seeds, model_cfg=mc,
                 train_cfg=TrainConfig(**TRAIN_KW, distributed=True,
                                       viewer=True, viewer_port=0),
                 device="cpu")
    try:
        assert tr.mesh is not None
        got = {}
        th = threading.Thread(target=lambda: got.update(
            tr._orbit_render(30.0, 10.0, 3.0, 0.5)), daemon=True)
        th.start()
        for _ in range(500):
            if tr._view_request.is_set():
                break
            time.sleep(0.01)
        assert tr._view_request.is_set() and not got
        tr.train(num_steps=2, log_every=2)
        th.join(timeout=60)
        assert not th.is_alive()
        assert got["rgb"].shape[-1] == 3 and np.isfinite(got["rgb"]).all()
        assert got["rgb"].shape[:2] == got["depth"].shape[:2]
    finally:
        tr.viewer.close()


def test_cli_train_dp_on_two_processes(runs2):
    """`cli train --train.dp 2 --device cpu` on a MuSHRoom capture in each
    rank of the launch: both finish at step 4, rank 0 alone writes the
    checkpoint."""
    a, b = (r["cli"] for r in runs2)
    assert a["step"] == b["step"] == 4 and a["dp"] == b["dp"] == 2
    assert a["files"] == ["ckpt_000004.npz"] and b["files"] == []
    assert runs2[0]["is_main"] and not runs2[1]["is_main"]
    assert runs2[0]["backend"] == "gloo"


def test_import_is_backend_free():
    """Importing the port's entry modules initialises neither
    torch.distributed nor CUDA (JAX test_distributed_multiprocess.py:31):
    the process group must be joinable after `import dnsplatter_torch.cli`."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "import dnsplatter_torch.cli\n"
        "import dnsplatter_torch.parallel.distributed\n"
        "import dnsplatter_torch.train.trainer\n"
        "import dnsplatter_torch.eval.evaluator\n"
        "import dnsplatter_torch.mesh.exporters\n"
        "import dnsplatter_torch.baselines.fields\n"
        "sys.exit(1 if dist.is_initialized() or torch.cuda.is_initialized()"
        " else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_distributed_without_launch_raises(monkeypatch, tmp_path):
    """`--train.distributed true` with no launch environment raises before
    any data is read, instead of training single-process."""
    from dnsplatter_torch import cli as tcli
    from dnsplatter_torch.parallel import distributed as D

    for k in D.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(D, "_CONTEXT", None)
    with pytest.raises(RuntimeError, match="no launch environment"):
        tcli.cmd_train(["dn-splatter", "mushroom", "--data",
                        str(tmp_path / "missing"), "--device", "cpu",
                        "--train.distributed", "true"])
    # the degenerate context of an earlier call does not satisfy it either
    D.init_distributed()
    with pytest.raises(RuntimeError, match="single process"):
        D.init_distributed(require_multiprocess=True)


def test_scaling_report_and_statement():
    """utils/scaling.py (JAX test_parallel.py:394-429): one rank's step of
    an 8-rank world, accounted. The collectives carry the screen payload
    only: the same bytes at SH 1 and SH 3, under state / 8 at SH 3 (at SH 1
    the state is 416 bytes a Gaussian against the 96 gathered, so the
    JAX bound of 1/8 does not apply to it). The projection at the train
    1m step time of PERF.md (the card's figure, H100 80GB HBM3 at 700 W)
    over NVLink and a 400 Gb/s NIC keeps 8 ranks and 2 hosts above 80%."""
    from dnsplatter_torch.utils import scaling as S

    rep3 = S.scaling_report(8, capacity=4096, sh_degree=3, width=64,
                            height=64, device="cpu")
    rep1 = S.scaling_report(8, capacity=4096, sh_degree=1, width=64,
                            height=64, device="cpu")
    for rep in (rep1, rep3):
        assert rep["devices"] == 8
        assert rep["global_state_bytes"] > 0
        assert rep["params_bytes"] < rep["global_state_bytes"]
        assert rep["per_device_argument_bytes"] < rep["global_state_bytes"]
        assert rep["per_device_output_bytes"] is None  # CPU: not measured
        assert isinstance(rep["collectives"], list)
    assert rep1["collective_bytes_per_step"] == \
        rep3["collective_bytes_per_step"] == 4096 * 24 * 4
    assert rep3["collective_fraction_of_state"] < 0.125
    tile = S.scaling_report(2, capacity=4096, sh_degree=1, width=64,
                            height=64, strategy="tile", device="cpu")
    assert {r["op"] for r in tile["collectives"]} == {"all_gather",
                                                      "reduce_scatter"}

    assert S.project_efficiency(100.0, 0, 8) == 1.0
    assert S.project_dp_efficiency(100.0, 0, 2) == 1.0
    assert S.project_efficiency(100.0, 10**9, 8) < 0.9
    stmt = S.scaling_statement(H100_STEP_MS_1M, capacity=4096, sh_degree=1,
                               devices_list=(8,), device="cpu")
    assert stmt["nvlink_gb_s"] == 450.0 and stmt["nic_gb_s"] == 50.0
    assert 0.0 < stmt["projected_scaling_8x"] <= 1.0
    assert stmt["projected_scaling_8x"] >= 0.8, stmt
    assert stmt["projected_dp_scaling_2hosts"] >= 0.8, stmt
    assert stmt["dp_grad_bytes"] > 0


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), Path(sys.argv[2]) if len(sys.argv) > 2
            else None)
