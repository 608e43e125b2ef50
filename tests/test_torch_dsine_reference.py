"""The port's DSINE against the benchmark's plain reference
(`benchmark/references/dsine_b5.py`), on the CPU, with the same
`common.random_arrays` weights; the spans and counters of
`predict_normals`; the benchmark's `prior.*` readers. No JAX.

Tolerances: the five B5 taps and the decoder's three outputs rtol 1e-4 /
atol 1e-5, the float32 rounding of convolutions whose terms both sides sum
alike, with BatchNorm, GroupNorm and the weight standardisation computed
in another order (folded against unfolded, by group statistics, by
`torch.var`), which moves a value by a few ulps a layer; every normal map
(unit vectors) 1e-4 absolute, the refinement's other routes (Rodrigues'
formula against a quaternion matrix, `cosine_similarity`, unfold) adding
ulps that the five iterations carry, measured at most 2.4e-5 here.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import dsine as TD
from dnsplatter_torch.utils import profiling

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96
NARROW = dict(nf=64, feature_dim=16, hidden_dim=16, head_hidden=32,
              nrn_hidden=16)
STAGE = dict(rtol=1e-4, atol=1e-5)
MAP = dict(rtol=0, atol=1e-4)
K = np.array([[80.0, 0, 47.5], [0, 80.0, 31.5], [0, 0, 1]], np.float32)


@pytest.fixture
def harness_cells(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    from harness import cells

    return cells


@pytest.fixture(scope="module")
def ref():
    """The reference, imported with `benchmark/` on the path as the
    harness has it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT / "benchmark"))
        from references import dsine_b5

    return dsine_b5


def _model(widths, seed):
    """The port's DSINE with `random_arrays` weights, and the arrays."""
    with torch.device("meta"):
        model = TD.DSINE(**widths)
    arrays = C.random_arrays(model, seed)
    model = model.to_empty(device="cpu").eval()
    C.params_from_numpy(model, arrays)
    return model, arrays


@pytest.fixture(scope="module")
def narrow():
    return _model(NARROW, 5)


def _port_stages(model, img):
    """{"taps", "decoder", "maps"} of one port forward, read by hooks."""
    seen = {}
    hooks = [model.encoder.register_forward_hook(
                 lambda m, a, out: seen.setdefault("taps", out)),
             model.decoder.register_forward_hook(
                 lambda m, a, out: seen.setdefault("decoder", out))]
    try:
        with torch.inference_mode():
            seen["maps"] = TD.dsine_forward(model, img,
                                            torch.as_tensor(K[None]))
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.fixture(scope="module")
def narrow_stages(narrow, ref):
    model, arrays = narrow
    img = torch.as_tensor(np.random.default_rng(4).normal(
        size=(1, 3, H, W)).astype(np.float32))
    with torch.no_grad():
        want = ref.forward(arrays, img, K)
    return _port_stages(model, img), want


CASES = ([("taps", i) for i in range(5)]
         + [("decoder", i) for i in range(3)]
         + [("maps", i) for i in range(TD.NUM_ITER + 1)])


@pytest.mark.parametrize("stage,i", CASES,
                         ids=[f"{s}{i}" for s, i in CASES])
def test_port_matches_the_reference_by_stage(narrow_stages, stage, i):
    got, want = narrow_stages
    tol = MAP if stage == "maps" else STAGE
    np.testing.assert_allclose(got[stage][i].numpy(),
                               want[stage][i].numpy(), **tol)


def test_published_widths_last_map(ref):
    model, arrays = _model({}, 7)
    img = torch.as_tensor(np.random.default_rng(8).normal(
        size=(1, 3, H, W)).astype(np.float32))
    got = _port_stages(model, img)["maps"][-1]
    with torch.no_grad():
        want = ref.forward(arrays, img, K)["maps"][-1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MAP)


@pytest.mark.parametrize("with_k", [True, False])
def test_predict_normals_matches_predict(narrow, ref, with_k):
    """A 70x100 frame: padded to 96x128, centred, and cropped back."""
    model, arrays = narrow
    rgb = np.random.default_rng(6).integers(0, 256, (70, 100, 3)).astype(
        np.uint8)
    k = (np.array([[60.0, 0, 49.0], [0, 61.0, 34.5], [0, 0, 1]], np.float32)
         if with_k else None)
    got = TD.predict_normals(model, rgb, K=k)
    want = ref.predict(arrays, rgb, K=k)
    assert got.shape == want.shape == (70, 100, 3)
    np.testing.assert_allclose(got, want, **MAP)


def test_predict_normals_records_its_spans(narrow):
    model, _ = narrow
    rgb = np.zeros((70, 100, 3), np.uint8)
    with profiling.recording():
        TD.predict_normals(model, rgb)
    rec = profiling.record()
    spans = rec["spans"]
    names = ("prior.frame", "prior.prepare", "prior.encoder",
             "prior.decoder", "prior.refine", "prior.readback")
    assert set(names) <= set(spans)
    assert spans["prior.frame"]["parent"] is None
    for name in names[1:]:
        assert spans[name]["parent"] == "prior.frame", name
        assert spans[name]["n"] == (TD.NUM_ITER if name == "prior.refine"
                                    else 1)
    assert rec["counters"]["prior.frames"] == 1
    assert rec["counters"]["prior.pixels"] == 96 * 128
    assert rec["counters"]["prior.refine_iters"] == TD.NUM_ITER
    # off, nothing is recorded
    TD.predict_normals(model, rgb)
    assert profiling.record()["spans"]["prior.frame"]["n"] == 1


RECORD = {
    "spans": {
        "prior.frame": {"n": 20, "host_ms": 1200.0, "stream_ms": 1000.0,
                        "parent": None},
        "prior.prepare": {"n": 20, "host_ms": 160.0, "stream_ms": 30.0,
                          "parent": "prior.frame"},
        "prior.encoder": {"n": 20, "host_ms": 300.0, "stream_ms": 400.0,
                          "parent": "prior.frame"},
        "prior.decoder": {"n": 20, "host_ms": 100.0, "stream_ms": 300.0,
                          "parent": "prior.frame"},
        "prior.refine": {"n": 100, "host_ms": 200.0, "stream_ms": 180.0,
                         "parent": "prior.frame"},
    },
    "counters": {"prior.frames": 20, "prior.refine_iters": 100},
}
CTX = {"units": 20, "flops": 446.8e9, "untraced_unit_s": 0.05,
       "trace": {"busy_s": 0.8, "window_s": 1.25, "kernels": 40000}}
PRIOR_METRICS = {
    "prior.encoder_stream_ms": 20.0, "prior.decoder_stream_ms": 15.0,
    "prior.refine_stream_ms": 9.0, "prior.prepare_ms": 8.0,
    "prior.frame_mfu": 100 * 446.8e9 / (0.05 * 67e12),
    "prior.idle_share": 36.0, "prior.kernels_per_frame": 2000.0,
}


@pytest.mark.parametrize("metric", sorted(PRIOR_METRICS))
def test_prior_reader(metric, harness_cells, monkeypatch):
    bench = harness_cells.load_benchmark()
    entry = [m for m in bench["per_layer"] if m["name"] == metric]
    assert len(entry) == 1 and entry[0]["workloads"] == ["dsine_b5.infer"]
    read = harness_cells.reader(metric)
    monkeypatch.setattr(profiling, "record", lambda: RECORD)
    assert read(CTX) == pytest.approx(PRIOR_METRICS[metric])
    # nothing recorded, no profiled stretch: no number
    monkeypatch.setattr(profiling, "record",
                        lambda: {"spans": {}, "counters": {}})
    assert read({"units": 20, "trace": None}) is None


def test_reference_loads_no_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'benchmark')!r})\n"
            "import references.dsine_b5\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "dnsplatter_torch", "dnsplatter_tpu"}


def test_reference_restates_the_published_b5(ref):
    """The reference's B5, derived from geffnet's base definition and the
    B5 multipliers, has the port's stage widths and repeats, and the
    configuration states them."""
    from dnsplatter_torch.priors import efficientnet as TE

    got = [(b, k, s, e, c, r) for b, r, k, s, e, c in ref.b5_stages()]
    assert got == [tuple(st) for st in TE.B5_STAGES]
    cfg = json.loads((ROOT / "benchmark" / "configs" / "dsine_b5.json")
                     .read_text())
    assert [tuple(st) for st in cfg["encoder"]["stages"]] == got
    assert cfg["widths"] == ref.PUBLISHED
