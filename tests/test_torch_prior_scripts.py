"""dnsplatter_torch's prior-generation scripts against the JAX package's,
on the CPU, over tiny folders written here, with the narrow DPT-Hybrid of
the parity tests (`dpt.SMALL_CONFIG`) and npz weights written here:
`normals_from_pretrain` with the omnidata network and its HD patch merge
(the DSINE and ZoeDepth scripts are held in the files of their networks,
which compile the JAX graphs once), and every script's exit without
weights. Both packages' scripts default to the published configuration;
the test points both at the narrow one.

Tolerances: normal PNGs within 1/255 (the networks agree to 1e-4 and the
8-bit rounding may flip).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dnsplatter_torch.data import io as tio
from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import dpt as TDPT
from dnsplatter_torch.scripts import depth_from_pretrain as TDP
from dnsplatter_torch.scripts import normals_from_pretrain as TNP
from dnsplatter_tpu.priors import dpt as JDPT
from dnsplatter_tpu.scripts import normals_from_pretrain as JNP

torch.set_num_threads(1)
DPT_CFG = dataclasses.replace(TDPT.SMALL_CONFIG, out_channels=3)


def _folder(root, sizes, seed):
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        y, x = np.mgrid[0:h, 0:w] / max(h, w)
        img = np.stack([np.sin(6 * x + i), np.cos(5 * y), x * y], -1)
        img = 0.5 + 0.4 * img + rng.normal(0, 0.03, img.shape)
        tio.write_image(root / "images" / f"frame_{i}.png", img)
    return root


def _npz(tmp_path, model, seed, name):
    arrays = C.random_arrays(model, seed)
    np.savez(tmp_path / name, **arrays)
    return tmp_path / name


def _same_pngs(a_dir, b_dir, n):
    names = sorted(p.name for p in a_dir.glob("*.png"))
    assert names == sorted(p.name for p in b_dir.glob("*.png"))
    assert len(names) == n
    for name in names:
        got, want = tio.read_image(a_dir / name), tio.read_image(b_dir / name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1 / 255 + 1e-6)
    return names


@pytest.fixture
def small_dpt(monkeypatch):
    jcfg = JDPT.DPTHybridConfig(**dataclasses.asdict(DPT_CFG))
    monkeypatch.setattr(TDPT, "DPTHybridConfig", lambda **kw: DPT_CFG)
    monkeypatch.setattr(JDPT, "DPTHybridConfig", lambda **kw: jcfg)


@pytest.mark.parametrize("hd", [False, True], ids=["omnidata", "hd"])
def test_normals_from_pretrain_omnidata_matches_jax(tmp_path, small_dpt, hd):
    """384x384 omnidata inference, and the HD route over an image larger
    than the 384 patch (four patches merged)."""
    sizes = [(400, 420)] if hd else [(40, 56), (48, 40)]
    root = _folder(tmp_path / "capture", sizes, 0)
    npz = _npz(tmp_path, TDPT.DPTHybrid(DPT_CFG), 1, "omnidata.npz")
    flags = ["--hd"] if hd else []
    n = TNP.main(["--data", str(root), "--ckpt", str(npz), "--device", "cpu",
                  "--output-dir", str(tmp_path / "t"), *flags])
    assert n == len(sizes)
    run = JNP.run_monocular_normals_hd if hd else JNP.run_monocular_normals
    run(root / "images", tmp_path / "j", npz)
    _same_pngs(tmp_path / "t", tmp_path / "j", len(sizes))


def test_scripts_without_weights_name_the_converter(tmp_path):
    root = _folder(tmp_path / "capture", [(16, 16)], 6)
    with pytest.raises(SystemExit, match="priors.convert --dpt"):
        TNP.main(["--data", str(root), "--device", "cpu"])
    with pytest.raises(SystemExit, match="priors.convert"):
        TNP.main(["--data", str(root), "--device", "cpu", "--model-type",
                  "dsine", "--ckpt", str(tmp_path / "dsine.pt")])
    with pytest.raises(SystemExit, match="priors.convert --zoe"):
        TDP.main(["--data", str(root), "--device", "cpu"])
