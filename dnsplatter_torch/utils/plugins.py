"""Entry-point plugin discovery for methods and dataparsers (counterpart of
dnsplatter_tpu/utils/plugins.py).

Third-party packages extend the port under its own groups:

    [project.entry-points."dnsplatter_torch.methods"]
    my-method = "my_pkg.presets:MY_PRESET"      # dict of ModelConfig overrides

    [project.entry-points."dnsplatter_torch.dataparsers"]
    my-format = "my_pkg.parser:parse"           # parse(cfg, split, device)

and `python -m dnsplatter_torch.cli train my-method my-format --data ...`
picks them up. Built-in names always win: a plugin cannot take over a
registered method or parser name.
"""

from __future__ import annotations

import importlib.metadata as _md
import warnings
from typing import Callable, Dict, List, Optional

METHODS_GROUP = "dnsplatter_torch.methods"
DATAPARSERS_GROUP = "dnsplatter_torch.dataparsers"

# Names that load_group itself put into a registry, keyed by registry id: a
# second discovery pass must not take an already-loaded plugin for a
# built-in and warn that it "shadows a built-in".
_plugin_loaded: Dict[int, set] = {}


def iter_entry_points(group: str) -> List:
    """All installed entry points in `group`."""
    try:
        return list(_md.entry_points(group=group))
    except TypeError:  # the dict-returning API before Python 3.10
        return list(_md.entry_points().get(group, []))


def load_group(group: str, registry: Dict[str, object],
               transform: Optional[Callable[[object], object]] = None
               ) -> None:
    """Merge the entry points of `group` into `registry` in place.

    Existing (built-in) names are never overridden. A plugin that fails to
    import or validate is skipped with a warning instead of breaking the CLI
    for every other method.
    """
    loaded = _plugin_loaded.setdefault(id(registry), set())
    loaded.intersection_update(registry)  # drop names removed since
    for ep in iter_entry_points(group):
        if ep.name in registry:
            if ep.name not in loaded:  # a genuine built-in collision
                warnings.warn(f"plugin {ep.name!r} in {group} shadows a "
                              "built-in name; ignored")
            continue
        try:
            obj = ep.load()
            registry[ep.name] = transform(obj) if transform else obj
            loaded.add(ep.name)
        except Exception as exc:  # a plugin's bug must not kill the CLI
            warnings.warn(f"failed to load plugin {ep.name!r} ({group}): "
                          f"{exc}")
