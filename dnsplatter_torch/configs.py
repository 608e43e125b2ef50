"""Method presets and the dataclass <-> command-line bridge (counterpart of
dnsplatter_tpu/configs.py).

The presets are the reference's three methods: `dn-splatter`, `ags-mesh`
and `dn-splatter-big` (cull_alpha_thresh 0.005, no culling after
densification). Every dataclass field becomes a `--section.field-name
value` flag, so a command line written for the JAX package's CLI works
here too.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Any, Dict, Type

from dnsplatter_torch.models.dn_model import ModelConfig

METHOD_PRESETS: Dict[str, Dict[str, Any]] = {
    "dn-splatter": dict(regularization_strategy="dn-splatter"),
    "ags-mesh": dict(regularization_strategy="ags-mesh"),
    "dn-splatter-big": dict(
        regularization_strategy="dn-splatter",
        cull_alpha_thresh=0.005,
        continue_cull_post_densification=False,
    ),
}


def load_method_plugins() -> None:
    """Merge the method presets registered under the
    `dnsplatter_torch.methods` entry-point group into METHOD_PRESETS. An
    entry point resolves to a dict of ModelConfig field overrides, or a
    zero-argument callable returning one. Built-in names always win."""
    from dnsplatter_torch.utils.plugins import METHODS_GROUP, load_group

    def to_preset(obj) -> Dict[str, Any]:
        preset = obj() if callable(obj) else obj
        if not isinstance(preset, dict):
            raise TypeError("method plugin must resolve to a dict of "
                            "ModelConfig overrides, got "
                            f"{type(preset).__name__}")
        unknown = set(preset) - {f.name for f in
                                 dataclasses.fields(ModelConfig)}
        if unknown:
            raise ValueError(f"unknown ModelConfig fields: {sorted(unknown)}")
        return dict(preset)

    load_group(METHODS_GROUP, METHOD_PRESETS, transform=to_preset)


def model_config_for_method(method: str, **overrides) -> ModelConfig:
    if method not in METHOD_PRESETS:
        load_method_plugins()
    preset = dict(METHOD_PRESETS[method])
    preset.update(overrides)
    return ModelConfig(**preset)


def _parse_value(text: str, typ) -> Any:
    if typ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    if typ is Path:
        return Path(text)
    if typ is str or not callable(typ):
        return text
    try:
        return typ(text)
    except (TypeError, ValueError):
        # integers written as floats ("1e5", "2.0") are a common habit
        if typ is int:
            f = float(text)  # raises if not numeric at all
            if f != int(f):
                raise ValueError(f"expected an integer, got {text!r}")
            return int(f)
        raise ValueError(
            f"could not parse {text!r} as {getattr(typ, '__name__', typ)}")


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type,
                       prefix: str) -> None:
    for f in dataclasses.fields(cls):
        name = f"--{prefix}.{f.name.replace('_', '-')}"
        parser.add_argument(name, dest=f"{prefix}__{f.name}", default=None,
                            metavar=str(f.type))


def build_dataclass(cls: Type, args: argparse.Namespace, prefix: str,
                    base: Any = None) -> Any:
    kwargs = dataclasses.asdict(base) if base is not None else {}
    for f in dataclasses.fields(cls):
        v = getattr(args, f"{prefix}__{f.name}", None)
        if v is not None:
            typ = f.type if isinstance(f.type, type) else type(
                f.default if f.default is not dataclasses.MISSING else "")
            kwargs[f.name] = _parse_value(v, typ)
    return cls(**kwargs)
