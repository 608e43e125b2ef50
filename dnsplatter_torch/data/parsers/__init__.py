"""Dataparsers, one module per dataset format (counterpart of
dnsplatter_tpu/data/parsers): normal-nerfstudio, mushroom, scannetpp,
replica, nrgbd, coolermap and gsdf.

Each parser is `parse(cfg, split="train", device=None) -> SceneDataset`,
with `device` (None: the card) for the dataset's cameras and any seed-cloud
work. A name outside the seven is looked up in the
`dnsplatter_torch.dataparsers` entry-point group (utils/plugins.py).
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
        from dnsplatter_torch.utils.plugins import (DATAPARSERS_GROUP,
                                                    load_group)

        load_group(DATAPARSERS_GROUP, PARSERS)
    if name not in PARSERS:
        raise KeyError(f"unknown dataparser {name!r}; have {sorted(PARSERS)}")
    return PARSERS[name]
