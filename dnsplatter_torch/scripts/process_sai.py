"""SpectacularAI capture ingestion, a wrapper of `sai-cli` (counterpart of
dnsplatter_tpu/scripts/process_sai.py): converts iPhone / Android RGB-D
captures into a transforms.json dataset with depth frames, then sorts the
frames by file path for the sequential datamanager.

    python -m dnsplatter_torch.scripts.process_sai --input IN --output OUT
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path


def process(input_dir: Path, output_dir: Path, fps: int = 10,
            internal: str = "") -> Path:
    if shutil.which("sai-cli") is None:
        raise SystemExit(
            "sai-cli not found; install the spectacularAI sdk "
            "(external offline tool, like the reference's process_sai.py)"
        )
    cmd = ["sai-cli", "process", str(input_dir), str(output_dir),
           "--format", "nerfstudio", "--fps", str(fps)]
    if internal:
        cmd += ["--internal", internal]
    subprocess.run(cmd, check=True)
    tf = output_dir / "transforms.json"
    if tf.exists():
        meta = json.loads(tf.read_text())
        # keep frames sorted by file path for the sequential datamanager
        meta["frames"] = sorted(meta["frames"], key=lambda f: f["file_path"])
        tf.write_text(json.dumps(meta, indent=2))
    return tf


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)
    print(f"wrote {process(args.input, args.output, args.fps)}")


if __name__ == "__main__":
    main()
