"""Command-line interface: train / eval / export / render (counterpart of
dnsplatter_tpu/cli.py).

The reference registers into nerfstudio's CLI (`ns-train dn-splatter
<dataparser> --data ...`, `ns-eval`, `gs-mesh <mode>`); the same surface
lives here, with the JAX package's flags:

    python -m dnsplatter_torch.cli train dn-splatter mushroom \
        --data <dir> --output-dir runs/exp --model.use-depth-loss true
    python -m dnsplatter_torch.cli eval --checkpoint runs/exp/ckpt_030000.npz \
        --dataparser mushroom --data <dir> --pair-capacity 6000000
    python -m dnsplatter_torch.cli export tsdf --checkpoint ... --data ...
    python -m dnsplatter_torch.cli render --checkpoint ... --data ... \
        --output-dir renders --pair-capacity 6000000

Every command runs on the card; `--device cpu` (the counterpart of the
JAX package's JAX_PLATFORMS=cpu) runs it on the CPU. `export` and `render`
take `--pair-capacity` as `eval` does: the renders' pair-list capacity, which a
scene of a million Gaussians at 1024x576 outgrows at the default 2^21.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import sys
from pathlib import Path

from dnsplatter_torch.baselines.runner import BASELINE_METHODS
from dnsplatter_torch.configs import (
    METHOD_PRESETS,
    add_dataclass_args,
    build_dataclass,
    model_config_for_method,
)
from dnsplatter_torch.models.dn_model import ModelConfig
from dnsplatter_torch.train.optim import OptimConfig
from dnsplatter_torch.train.trainer import TrainConfig, Trainer

EXPORT_MODES = ("tsdf", "o3dtsdf", "dn", "gaussians", "sugar-coarse",
                "marching", "isofusion")


def _parser_config_cls(name: str):
    """(parse function, its *ParserConfig dataclass or None)."""
    from dnsplatter_torch.data.parsers import get_parser

    parse = get_parser(name)
    # the parse function's own annotation first; else the *ParserConfig
    # dataclass defined in its module (imported configs must not win)
    first = next(iter(inspect.signature(parse).parameters.values()), None)
    if first is not None and dataclasses.is_dataclass(first.annotation):
        return parse, first.annotation
    mod = sys.modules[parse.__module__]
    for obj in vars(mod).values():
        if (isinstance(obj, type) and dataclasses.is_dataclass(obj)
                and obj.__name__.endswith("ParserConfig")
                and obj.__module__ == parse.__module__):
            return parse, obj
    return parse, None


def _add_parser_args(p, argv):
    """Two-stage parse: resolve the dataparser from argv, then expose its
    config's fields as `--parser.x` flags. Returns the config class (or
    None)."""
    pre, _ = p.parse_known_args(argv)
    try:
        _, cfg_cls = _parser_config_cls(pre.dataparser)
    except Exception:
        return None
    if cfg_cls is not None:
        add_dataclass_args(p, cfg_cls, "parser")
    return cfg_cls


def _add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")


def _load_dataset(args, parser_cls, split: str):
    """The dataset of `args.dataparser` over `args.data`, with the
    `--parser.*` flags, on `args.device` where the parser takes one."""
    parse, cfg_cls = _parser_config_cls(args.dataparser)
    cfg = (build_dataclass(parser_cls, args, "parser",
                           parser_cls(data=args.data))
           if parser_cls else (cfg_cls(data=args.data) if cfg_cls else None))
    if "device" in inspect.signature(parse).parameters:
        return parse(cfg, split, device=args.device)
    return parse(cfg, split)


def cmd_train(argv):
    from dnsplatter_torch.configs import load_method_plugins

    load_method_plugins()  # installed third-party methods join the choices
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("method", choices=sorted(METHOD_PRESETS)
                   + sorted(BASELINE_METHODS))
    p.add_argument("dataparser")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=Path("runs/default"))
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--resume", type=Path, default=None,
                   help="checkpoint .npz to resume from (continues to "
                        "max-iterations total steps)")
    _add_device_arg(p)
    add_dataclass_args(p, ModelConfig, "model")
    add_dataclass_args(p, TrainConfig, "train")
    add_dataclass_args(p, OptimConfig, "optim")
    parser_cls = _add_parser_args(p, argv)
    args = p.parse_args(argv)

    if args.method in BASELINE_METHODS:
        # The reference's gnerfacto / gdepthfacto / gneusfacto method
        # specifications train through the ray-batch runner instead of the
        # splatter Trainer.
        from dnsplatter_torch.baselines.runner import train_baseline

        data = _load_dataset(args, parser_cls, "train")
        train_cfg = build_dataclass(TrainConfig, args, "train", TrainConfig())
        steps = (args.max_iterations if args.max_iterations is not None
                 else train_cfg.max_iterations)
        return train_baseline(args.method, data, num_steps=steps,
                              out_dir=args.output_dir, seed=train_cfg.seed,
                              device=args.device)
    model_cfg = build_dataclass(ModelConfig, args, "model",
                                model_config_for_method(args.method))
    train_cfg = build_dataclass(TrainConfig, args, "train", TrainConfig())
    optim_cfg = build_dataclass(OptimConfig, args, "optim", OptimConfig())
    if args.max_iterations is not None:
        train_cfg = dataclasses.replace(train_cfg,
                                        max_iterations=args.max_iterations)
    ctx = None
    if train_cfg.distributed or train_cfg.dp > 1 or train_cfg.devices > 1:
        # Join the process group before any dataset loading or audit: under
        # NCCL it picks this rank's card (one process a device, launched by
        # torchrun). Idempotent: the Trainer finds this context.
        from dnsplatter_torch.parallel import distributed as D

        ctx = D.init_distributed(require_multiprocess=train_cfg.distributed,
                                 device=args.device)
    data = _load_dataset(args, parser_cls, "train")
    trainer = Trainer(
        data=data,
        seed_points=data.seed() if hasattr(data, "seed") else None,
        model_cfg=model_cfg, optim_cfg=optim_cfg, train_cfg=train_cfg,
        out_dir=args.output_dir, device=args.device)
    if args.resume:
        trainer.load_checkpoint(args.resume)
        print(f"resumed {args.resume} at step {trainer.step}", flush=True)
        trainer.train(num_steps=max(0, train_cfg.max_iterations
                                    - trainer.step))
    else:
        trainer.train()
    path = trainer.save_checkpoint()  # every rank enters; rank 0 writes
    if ctx is None or ctx.is_main:
        print(f"checkpoint: {path}")
    return trainer


def cmd_eval(argv):
    p = argparse.ArgumentParser(prog="eval")
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--method", default="dn-splatter")
    p.add_argument("--dataparser", default="normal-nerfstudio")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--save-renders", action="store_true")
    p.add_argument("--lpips-weights", type=Path, default=None)
    p.add_argument("--pair-capacity", type=int, default=1 << 21,
                   help="intersection-list capacity for eval renders")
    _add_device_arg(p)
    parser_cls = _add_parser_args(p, argv)
    args = p.parse_args(argv)

    from dnsplatter_torch.eval.evaluator import evaluate
    from dnsplatter_torch.train.trainer import load_checkpoint_arrays

    params, alive, _ = load_checkpoint_arrays(args.checkpoint,
                                              device=args.device)
    data = _load_dataset(args, parser_cls, args.split)
    lpips_fn = None
    if args.lpips_weights:
        from dnsplatter_torch.eval.metrics import lpips_from_npz

        lpips_fn = lpips_from_npz(args.lpips_weights)
    metrics = evaluate(
        params, alive, data,
        model_cfg=model_config_for_method(args.method),
        pair_capacity=args.pair_capacity, lpips_fn=lpips_fn,
        output_dir=args.output_dir, save_renders=args.save_renders,
        device=args.device)
    print(json.dumps(metrics, indent=2))
    return metrics


def cmd_export(argv):
    p = argparse.ArgumentParser(prog="export")
    p.add_argument("mode", choices=EXPORT_MODES)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--method", default="dn-splatter")
    p.add_argument("--dataparser", default="normal-nerfstudio")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=Path("exports"))
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--resolution", type=int, default=256)
    # Poisson grid for dn / gaussians (reference: Open3D depth 9, ~512^3
    # adaptive). Above 192 the CG solver runs (a float32 dense grid).
    p.add_argument("--poisson-resolution", type=int, default=192)
    p.add_argument("--pair-capacity", type=int, default=1 << 21,
                   help="intersection-list capacity for the renders")
    _add_device_arg(p)
    parser_cls = _add_parser_args(p, argv)
    args = p.parse_args(argv)

    from dnsplatter_torch.mesh import exporters as E
    from dnsplatter_torch.train.trainer import load_checkpoint_arrays

    params, alive, _ = load_checkpoint_arrays(args.checkpoint,
                                              device=args.device)
    data = _load_dataset(args, parser_cls, "train")
    model_cfg = model_config_for_method(args.method)
    cap = dict(pair_capacity=args.pair_capacity)

    if args.mode in ("tsdf", "o3dtsdf"):
        # o3dtsdf adds Open3DTSDFFusion's connected-component cleanup;
        # plain tsdf (the vdbfusion role) does not
        cfg = E.TSDFExportConfig(voxel_size=args.voxel_size,
                                 cleanup_clusters=args.mode == "o3dtsdf")
        out = E.export_tsdf(params, alive, data, args.output_dir, model_cfg,
                            cfg, **cap)
    elif args.mode == "dn":
        out = E.export_dn(params, alive, data, args.output_dir, model_cfg,
                          poisson_resolution=args.poisson_resolution, **cap)
    elif args.mode == "gaussians":
        out = E.export_gaussians(params, alive, data, args.output_dir,
                                 poisson_resolution=args.poisson_resolution)
    elif args.mode == "sugar-coarse":
        out = E.export_sugar_coarse(params, alive, data, args.output_dir,
                                    model_cfg, **cap)
    elif args.mode == "isofusion":
        out = E.export_isofusion(params, alive, data, args.output_dir,
                                 model_cfg, voxel_size=args.voxel_size,
                                 **cap)
    else:
        out = E.export_marching(params, alive, data, args.output_dir,
                                resolution=args.resolution)
    print(f"exported: {out}")
    return out


def cmd_render(argv):
    """Dump rgb/depth/normal renders of a checkpoint over a split
    (scripts/render_model.py, the reference's render_model role)."""
    from dnsplatter_torch.scripts import render_model

    return render_model.main(argv)


def gs_mesh_main():
    """`gs-mesh <mode> --checkpoint ... --data ...`: the reference's
    mesh-export entry point as a command of its own."""
    cmd_export(sys.argv[1:])


def main():
    cmds = {"train": cmd_train, "eval": cmd_eval, "export": cmd_export,
            "render": cmd_render}
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        print(f"usage: python -m dnsplatter_torch.cli {{{'|'.join(cmds)}}} "
              "...")
        sys.exit(2)
    cmds[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    main()
