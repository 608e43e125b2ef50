"""Export VGG16-LPIPS weights to the npz layout `eval.metrics.LPIPS` loads
(counterpart of dnsplatter_tpu/scripts/export_lpips_weights.py; both
packages read the file).

Run offline on a machine with torchvision and `lpips` installed:

    python -m dnsplatter_torch.scripts.export_lpips_weights --out lpips_vgg.npz

then pass `--lpips-weights lpips_vgg.npz` to `cli eval`, or put the file
where `eval.metrics` looks for it. Layout: conv{i}_w (HWIO float32),
conv{i}_b, lin{j} (C,) linear-head weights of the five feature taps.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=Path, default=Path("lpips_vgg.npz"))
    args = p.parse_args(argv)

    try:
        import lpips  # type: ignore
        import torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"needs `lpips` + torchvision installed ({e}); run offline"
        )

    net = lpips.LPIPS(net="vgg")
    out = {}
    conv_i = 0
    for layer in net.net.slice1 + net.net.slice2 + net.net.slice3 + \
            net.net.slice4 + net.net.slice5:
        if layer.__class__.__name__ == "Conv2d":
            w = layer.weight.detach().numpy()  # OIHW
            out[f"conv{conv_i}_w"] = np.transpose(w, (2, 3, 1, 0))  # HWIO
            out[f"conv{conv_i}_b"] = layer.bias.detach().numpy()
            conv_i += 1
    for j, lin in enumerate(net.lins):
        out[f"lin{j}"] = (
            lin.model[1].weight.detach().numpy().reshape(-1)
        )
    np.savez(args.out, **out)
    print(f"wrote {args.out} ({conv_i} convs, {len(net.lins)} heads)")


if __name__ == "__main__":
    main()
