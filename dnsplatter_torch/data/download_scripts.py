"""Benchmark dataset downloaders (counterpart of
dnsplatter_tpu/data/download_scripts.py): MuSHRoom rooms, Replica,
Neural-RGBD, DTU and the Omnidata checkpoint, through `wget`, `unzip` and
`tar`. They need network access.

    python -m dnsplatter_torch.data.download_scripts mushroom --room honka
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

DATASETS = {
    "mushroom": {
        "url": "https://zenodo.org/records/10154395/files/{room}.zip",
        "rooms": ["coffee_room", "honka", "kokko", "sauna", "activity",
                  "classroom", "vr_room", "koivu"],
    },
    "replica": {
        "url": "https://cvg-data.inf.ethz.ch/nice-slam/data/Replica.zip",
    },
    "nrgbd": {
        "url": "http://kaldir.vc.in.tum.de/neural_rgbd/neural_rgbd_data.zip",
    },
    "dtu": {
        "url": (
            "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/"
            "data/DTU.tar"
        ),
    },
    "omnidata": {
        "url": (
            "https://datasets.epfl.ch/taskonomy/omnidata_dpt_normal_v2.ckpt"
        ),
    },
}


def download(name: str, out_dir: Path, room: str = "") -> None:
    spec = DATASETS[name]
    out_dir.mkdir(parents=True, exist_ok=True)
    url = spec["url"].format(room=room) if room else spec["url"]
    target = out_dir / Path(url).name
    print(f"downloading {url} -> {target}")
    subprocess.run(["wget", "-c", "-O", str(target), url], check=True)
    if target.suffix == ".zip":
        subprocess.run(["unzip", "-o", str(target), "-d", str(out_dir)],
                       check=True)
    elif target.suffix == ".tar":
        subprocess.run(["tar", "xf", str(target), "-C", str(out_dir)],
                       check=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=sorted(DATASETS))
    p.add_argument("--output-dir", type=Path, default=Path("datasets"))
    p.add_argument("--room", default="")
    args = p.parse_args(argv)
    if args.dataset == "mushroom" and not args.room:
        for room in DATASETS["mushroom"]["rooms"]:
            download("mushroom", args.output_dir / "mushroom", room)
    else:
        download(args.dataset, args.output_dir / args.dataset, args.room)


if __name__ == "__main__":
    main()
