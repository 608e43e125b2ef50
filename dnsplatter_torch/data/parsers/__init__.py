"""Dataparsers, one module per dataset format (counterpart of
dnsplatter_tpu/data/parsers): normal-nerfstudio, mushroom, scannetpp,
replica, nrgbd, coolermap and gsdf.

Each parser is `parse(cfg, split="train", device=None) -> SceneDataset`,
with `device` (None: the card) for the dataset's cameras and any seed-cloud
work. Third-party parsers from an entry-point group need utils/plugins.py,
which is not ported yet.
"""

from typing import Callable, Dict

PARSERS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        PARSERS[name] = fn
        return fn

    return deco


def get_parser(name: str):
    # imported for their registration
    from dnsplatter_torch.data.parsers import (  # noqa: F401
        coolermap, gsdf, mushroom, normal_nerfstudio, nrgbd, replica,
        scannetpp)

    if name not in PARSERS:
        raise KeyError(
            f"unknown dataparser {name!r}; have {sorted(PARSERS)} (parsers "
            "from the entry-point group need utils/plugins.py, not ported "
            "yet: ROADMAP.md queue A item 8)")
    return PARSERS[name]
