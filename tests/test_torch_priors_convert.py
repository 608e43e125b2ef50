"""dnsplatter_torch's checkpoint converters against the JAX package's, on
synthetic state dicts made from the port modules' own keys: DSINE's
(names kept, num_batches_tracked dropped), a MiDaS / omnidata DPT-Hybrid
(`pretrained.*` / `scratch.*`, fused qkv) and an isl-org ZoeD_N
(`core.core.*`, fused qkv weight, q_bias / v_bias). Keys and arrays must be
equal, and must be the module's keys, so that the converted arrays load
strictly. Then the weight routes of the prior networks: npz, a checkpoint
converted in-process, and a missing file.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from dnsplatter_torch.priors import common as C
from dnsplatter_torch.priors import convert as TC
from dnsplatter_torch.priors import dpt as TDPT
from dnsplatter_torch.priors import dsine as TD
from dnsplatter_torch.priors import zoedepth as TZ
from dnsplatter_tpu.priors import convert as JC

torch.set_num_threads(1)
DSINE_SMALL = dict(nf=64, feature_dim=16, hidden_dim=16, head_hidden=32,
                   nrn_hidden=16)
BLOCK = {
    "layernorm_before.weight": "norm1.weight",
    "layernorm_before.bias": "norm1.bias",
    "layernorm_after.weight": "norm2.weight",
    "layernorm_after.bias": "norm2.bias",
    "attention.output.dense.weight": "attn.proj.weight",
    "attention.output.dense.bias": "attn.proj.bias",
    "intermediate.dense.weight": "mlp.fc1.weight",
    "intermediate.dense.bias": "mlp.fc1.bias",
    "output.dense.weight": "mlp.fc2.weight",
    "output.dense.bias": "mlp.fc2.bias",
}


def _neck_to_midas(k: str):
    """HF neck / head names -> MiDaS `pretrained.act_postprocess*` /
    `scratch.*` names (None where the key is not a neck key)."""
    m = re.match(r"neck\.reassemble_stage\.(readout_projects|layers)\.(\d)\."
                 r"(0|projection|resize)\.(weight|bias)", k)
    if m:
        sub = {"0": "0.project.0", "projection": "3", "resize": "4"}[
            m.group(3)]
        return f"pretrained.act_postprocess{int(m.group(2)) + 1}.{sub}." \
            f"{m.group(4)}"
    m = re.match(r"neck\.convs\.(\d)\.weight", k)
    if m:
        return f"scratch.layer{int(m.group(1)) + 1}_rn.weight"
    m = re.match(r"neck\.fusion_stage\.layers\.(\d)\.(.+)", k)
    if m:
        rest = (m.group(2).replace("projection", "out_conv")
                .replace("residual_layer", "resConfUnit")
                .replace("convolution", "conv"))
        return f"scratch.refinenet{4 - int(m.group(1))}.{rest}"
    return None


def to_midas(arrays):
    """A port DPT state dict renamed to omnidata's (MiDaS) names."""
    out, qkv = {}, {}
    for k, v in arrays.items():
        m = re.match(r"dpt\.encoder\.layer\.(\d+)\.attention\.attention\."
                     r"(query|key|value)\.(weight|bias)", k)
        if m:
            qkv.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = v
            continue
        m = re.match(r"dpt\.encoder\.layer\.(\d+)\.(.+)", k)
        bit = "dpt.embeddings.backbone.bit."
        if m:
            name = f"pretrained.model.blocks.{m.group(1)}.{BLOCK[m.group(2)]}"
        elif k.startswith(bit + "embedder."):
            name = ("pretrained.model.patch_embed.backbone.stem."
                    + k[len(bit + "embedder."):].replace("convolution",
                                                         "conv"))
        elif k.startswith(bit + "encoder.stages."):
            name = ("pretrained.model.patch_embed.backbone.stages."
                    + k[len(bit + "encoder.stages."):].replace(".layers.",
                                                               ".blocks."))
        elif k.startswith("dpt.embeddings.projection."):
            name = "pretrained.model.patch_embed.proj." + k.rsplit(".", 1)[1]
        elif k == "dpt.embeddings.cls_token":
            name = "pretrained.model.cls_token"
        elif k == "dpt.embeddings.position_embeddings":
            name = "pretrained.model.pos_embed"
        elif k.startswith("dpt.layernorm."):
            name = "pretrained.model.norm." + k.rsplit(".", 1)[1]
        elif k.startswith("head.head."):
            name = "scratch.output_conv." + k[len("head.head."):]
        else:
            name = _neck_to_midas(k)
        assert name is not None, k
        out[name] = v
    for (i, leaf), parts in qkv.items():
        out[f"pretrained.model.blocks.{i}.attn.qkv.{leaf}"] = np.concatenate(
            [parts["query"], parts["key"], parts["value"]], axis=0)
    return out


def to_islorg(arrays):
    """A port ZoeDepth state dict renamed to the isl-org ZoeD_N names."""
    out, qkv = {}, {}
    pre = "core.core.pretrained.model."
    for k, v in arrays.items():
        m = re.match(r"backbone\.encoder\.layer\.(\d+)\.(.+)", k)
        if m:
            i, rest = m.groups()
            q = re.match(r"attention\.attention\.(query|key|value)\.weight",
                         rest)
            if q:
                qkv.setdefault(i, {})[q.group(1)] = v
                continue
            table = dict(BLOCK, lambda_1="gamma_1", lambda_2="gamma_2")
            table["attention.attention.relative_position_bias."
                  "relative_position_bias_table"] = \
                "attn.relative_position_bias_table"
            table["attention.attention.query.bias"] = "attn.q_bias"
            table["attention.attention.value.bias"] = "attn.v_bias"
            name = f"{pre}blocks.{i}.{table[rest]}"
        elif k == "backbone.embeddings.cls_token":
            name = pre + "cls_token"
        elif k.startswith("backbone.embeddings.patch_embeddings.projection."):
            name = pre + "patch_embed.proj." + k.rsplit(".", 1)[1]
        elif k.startswith("relative_head.conv"):
            n, leaf = re.match(r"relative_head\.conv(\d)\.(\w+)", k).groups()
            name = f"core.core.scratch.output_conv.{(int(n) - 1) * 2}.{leaf}"
        elif k.startswith("metric_head."):
            name = k[len("metric_head."):]
            name = re.sub(r"^(seed_bin_regressor|seed_projector|"
                          r"projectors\.\d|attractors\.\d)\.conv(\d)",
                          lambda mm: f"{mm.group(1)}._net."
                          f"{(int(mm.group(2)) - 1) * 2}", name)
        else:
            neck = _neck_to_midas(k)
            assert neck is not None, k
            name = "core.core." + neck
        out[name] = v
    for i, parts in qkv.items():
        out[f"{pre}blocks.{i}.attn.qkv.weight"] = np.concatenate(
            [parts["query"], parts["key"], parts["value"]], axis=0)
    return out


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_dsine_state_dict_conversion_matches_jax():
    model = TD.DSINE(**DSINE_SMALL)
    arrays = C.random_arrays(model, 0)
    state = {k: torch.as_tensor(v) for k, v in arrays.items()}
    state["encoder.original_model.bn1.num_batches_tracked"] = torch.tensor(3)
    state["decoder.conv2.bias"] = state["decoder.conv2.bias"].double()
    got = TC.convert_state_dict(state)
    _same(got, JC.convert_state_dict(state))
    _same(got, arrays)


@pytest.mark.parametrize("cfg", [TDPT.SMALL_CONFIG,
                                 dataclasses.replace(TDPT.SMALL_CONFIG,
                                                     out_channels=3)])
def test_dpt_midas_conversion_matches_jax(cfg):
    arrays = C.random_arrays(TDPT.DPTHybrid(cfg), 1)
    midas = to_midas(arrays)
    got = TC.convert_dpt_state_dict(midas)
    _same(got, JC.convert_dpt_state_dict(midas))
    _same(got, arrays)
    # already HF-named dicts pass through
    _same(TC.convert_dpt_state_dict(arrays), arrays)


def test_zoedepth_islorg_conversion_matches_jax():
    model = TZ.ZoeDepth(TZ.SMALL_CONFIG)
    arrays = C.random_arrays(model, 2)
    islorg = to_islorg(arrays)
    got = TC.convert_zoedepth_state_dict(islorg)
    _same(got, JC.convert_zoedepth_state_dict(islorg))
    _same(got, arrays)
    # HF-named dicts lose their relative_position_index buffers
    hf = dict(arrays)
    hf["backbone.encoder.layer.0.attention.attention.relative_position_bias"
       ".relative_position_index"] = np.zeros((37, 37), np.int64)
    _same(TC.convert_zoedepth_state_dict(hf),
          JC.convert_zoedepth_state_dict(hf))
    _same(TC.convert_zoedepth_state_dict(hf), arrays)
    with pytest.raises(ValueError, match="missing"):
        TC.convert_zoedepth_state_dict({"core.core.pretrained.model."
                                        "cls_token": arrays[
                                            "backbone.embeddings.cls_token"]})


@pytest.mark.parametrize("which", ["dpt", "zoedepth"])
def test_published_names_cover_every_key(which):
    """At the published widths (modules on the meta device: keys and
    shapes only), every key of the port module survives the rename to the
    published checkpoint's names and back."""
    with torch.device("meta"):
        model = (TDPT.DPTHybrid(TDPT.DPTHybridConfig(out_channels=3))
                 if which == "dpt" else TZ.ZoeDepth())
    keys = {k: np.zeros((3,) if "query" in k or "key" in k or "value" in k
                        else (1,), np.float32)
            for k in model.state_dict()}
    renamed = to_midas(keys) if which == "dpt" else to_islorg(keys)
    back = (TC.convert_dpt_state_dict(renamed) if which == "dpt"
            else TC.convert_zoedepth_state_dict(renamed))
    assert sorted(back) == sorted(keys)


def test_weight_routes(tmp_path):
    model = TDPT.DPTHybrid(TDPT.SMALL_CONFIG)
    arrays = C.random_arrays(model, 3)
    np.savez(tmp_path / "dpt.npz", **arrays)
    torch.save({"state_dict": {"model." + k: torch.as_tensor(v)
                               for k, v in to_midas(arrays).items()}},
               tmp_path / "omnidata.ckpt")
    for path in (tmp_path / "dpt.npz", tmp_path / "omnidata.ckpt"):
        loaded = TDPT.load_model(path, cfg=TDPT.SMALL_CONFIG, device="cpu")
        _same(C.state_arrays(loaded), arrays)
        assert not loaded.training
    with pytest.raises(SystemExit, match="priors.convert --dpt"):
        TDPT.load_model(tmp_path / "missing.ckpt", device="cpu")
    with pytest.raises(SystemExit, match="--zoe"):
        TZ.load_model(tmp_path / "zoe.npz", device="cpu")
    # a key that one side lacks fails loudly
    del arrays["head.head.0.bias"]
    with pytest.raises(RuntimeError, match="head.head.0.bias"):
        C.params_from_numpy(TDPT.DPTHybrid(TDPT.SMALL_CONFIG), arrays)
    # the converter's command line on the omnidata checkpoint
    TC.main(["--dpt", str(tmp_path / "omnidata.ckpt"),
             str(tmp_path / "out.npz")])
    with np.load(tmp_path / "out.npz") as data:
        _same({k: data[k] for k in data.files},
              C.random_arrays(model, 3))


def test_seeded_weights_repeat_across_builds():
    a = C.state_arrays(TDPT.load_model(cfg=TDPT.SMALL_CONFIG, device="cpu",
                                       seed=7))
    b = C.state_arrays(TDPT.load_model(cfg=TDPT.SMALL_CONFIG, device="cpu",
                                       seed=7))
    c = C.state_arrays(TDPT.load_model(cfg=TDPT.SMALL_CONFIG, device="cpu",
                                       seed=8))
    _same(a, b)
    assert not np.array_equal(a["head.head.0.weight"],
                              c["head.head.0.weight"])
