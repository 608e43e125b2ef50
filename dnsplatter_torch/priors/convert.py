"""Convert the published torch checkpoints of the prior networks to the
flat {key: float32 array} format of the JAX package's npz files
(counterpart of dnsplatter_tpu/priors/convert.py):

    python -m dnsplatter_torch.priors.convert dsine.pt dsine.npz
    python -m dnsplatter_torch.priors.convert --dpt \
        omnidata_dpt_normal_v2.ckpt omnidata.npz
    python -m dnsplatter_torch.priors.convert --zoe ZoeD_M12_N.pt zoe.npz

DSINE's `state_dict["model"]` keeps its names and torch layouts; the
omnidata / MiDaS DPT-Hybrid and the isl-org ZoeD_N names map onto the
HF-transformers names the networks use, with timm's fused qkv weights split
into thirds. The `load_*_checkpoint` functions do the same in-process, so
the prior scripts take a `.ckpt` / `.pt` path as well as an npz. A
checkpoint is unpickled with `weights_only=True`: tensors and plain
containers only.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict

import numpy as np


def convert_state_dict(state_dict) -> dict:
    """Tensors -> float32 numpy arrays (float64 / float16 cast), dropping
    BatchNorm's num_batches_tracked."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else v)
        if arr.dtype == np.float64 or arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        out[k] = arr
    return out


def _torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def load_dsine_checkpoint(path) -> Dict[str, np.ndarray]:
    """dsine.pt (`{"model": state_dict}` or a bare state dict) -> arrays."""
    ckpt = _torch_load(path)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_state_dict(state)


def load_dpt_checkpoint(path) -> Dict[str, np.ndarray]:
    """omnidata_dpt_normal_v2.ckpt (lightning: `state_dict` with a `model.`
    prefix, stripped as the reference loader does) -> HF-named arrays."""
    ckpt = _torch_load(path)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    state = {(k[6:] if k.startswith("model.") else k): v
             for k, v in state.items()}
    return convert_dpt_state_dict(state)


def load_zoedepth_checkpoint(path) -> Dict[str, np.ndarray]:
    """ZoeD_M12_N.pt (the torch.hub isl-org/ZoeDepth ZoeD_N weights) ->
    HF-named arrays."""
    ckpt = _torch_load(path)
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_zoedepth_state_dict(state)


def _write(arrays: Dict[str, np.ndarray], npz_path) -> int:
    np.savez_compressed(npz_path, **arrays)
    return len(arrays)


def convert_checkpoint(pt_path, npz_path) -> int:
    return _write(load_dsine_checkpoint(pt_path), npz_path)


def convert_dpt_checkpoint(pt_path, npz_path) -> int:
    return _write(load_dpt_checkpoint(pt_path), npz_path)


def convert_zoedepth_checkpoint(pt_path, npz_path) -> int:
    return _write(load_zoedepth_checkpoint(pt_path), npz_path)


# DPT-Hybrid (omnidata_dpt_normal_v2.ckpt / MiDaS dpt_hybrid) names


def _midas_to_hf_key(k: str):
    """Map one isl-org/DPT (MiDaS/omnidata) state-dict key to the
    HF-transformers naming priors/dpt.py consumes. Returns None for
    buffers the network does not use; 'QKV' keys are handled by the
    caller (they split into three)."""
    # BiT backbone (timm resnetv2 inside patch_embed)
    m = re.match(r"pretrained\.model\.patch_embed\.backbone\.stem\.(conv|norm)\.(.+)", k)
    if m:
        part = "convolution" if m.group(1) == "conv" else "norm"
        return f"dpt.embeddings.backbone.bit.embedder.{part}.{m.group(2)}"
    m = re.match(
        r"pretrained\.model\.patch_embed\.backbone\.stages\.(\d+)\.blocks"
        r"\.(\d+)\.(.+)", k)
    if m:
        return (f"dpt.embeddings.backbone.bit.encoder.stages.{m.group(1)}"
                f".layers.{m.group(2)}.{m.group(3)}")
    # ViT embeddings
    if k == "pretrained.model.cls_token":
        return "dpt.embeddings.cls_token"
    if k == "pretrained.model.pos_embed":
        return "dpt.embeddings.position_embeddings"
    m = re.match(r"pretrained\.model\.patch_embed\.proj\.(.+)", k)
    if m:
        return f"dpt.embeddings.projection.{m.group(1)}"
    # ViT blocks
    m = re.match(r"pretrained\.model\.blocks\.(\d+)\.(.+)", k)
    if m:
        i, rest = m.group(1), m.group(2)
        pre = f"dpt.encoder.layer.{i}"
        table = {
            "norm1.weight": "layernorm_before.weight",
            "norm1.bias": "layernorm_before.bias",
            "norm2.weight": "layernorm_after.weight",
            "norm2.bias": "layernorm_after.bias",
            "attn.proj.weight": "attention.output.dense.weight",
            "attn.proj.bias": "attention.output.dense.bias",
            "mlp.fc1.weight": "intermediate.dense.weight",
            "mlp.fc1.bias": "intermediate.dense.bias",
            "mlp.fc2.weight": "output.dense.weight",
            "mlp.fc2.bias": "output.dense.bias",
        }
        if rest in table:
            return f"{pre}.{table[rest]}"
        if rest.startswith("attn.qkv."):
            return ("QKV", i, rest.split(".")[-1])
        return None
    if k in ("pretrained.model.norm.weight", "pretrained.model.norm.bias"):
        return "dpt.layernorm." + k.split(".")[-1]
    # hybrid reassembly (act_postprocess 3/4 -> neck stages 2/3)
    m = re.match(r"pretrained\.act_postprocess(\d)\.(\d+)(?:\.project\.0)?\.(weight|bias)", k)
    if m:
        stage = int(m.group(1)) - 1  # 3 -> 2, 4 -> 3
        sub = int(m.group(2))
        leaf = m.group(3)
        if stage < 2:
            return None  # stages 1/2 are identity in hybrid
        if sub == 0:
            return f"neck.reassemble_stage.readout_projects.{stage}.0.{leaf}"
        if sub == 3:
            return f"neck.reassemble_stage.layers.{stage}.projection.{leaf}"
        if sub == 4:
            return f"neck.reassemble_stage.layers.{stage}.resize.{leaf}"
        return None
    # scratch: rn convs, refinenets (reversed order), output head
    m = re.match(r"scratch\.layer(\d)_rn\.weight", k)
    if m:
        return f"neck.convs.{int(m.group(1)) - 1}.weight"
    m = re.match(r"scratch\.refinenet(\d)\.(.+)", k)
    if m:
        layer = 4 - int(m.group(1))  # refinenet4 runs first (deepest)
        rest = m.group(2)
        rest = rest.replace("out_conv", "projection")
        rest = rest.replace("resConfUnit1", "residual_layer1")
        rest = rest.replace("resConfUnit2", "residual_layer2")
        rest = rest.replace("conv1", "convolution1").replace(
            "conv2", "convolution2")
        return f"neck.fusion_stage.layers.{layer}.{rest}"
    m = re.match(r"scratch\.output_conv\.(\d+)\.(weight|bias)", k)
    if m:
        return f"head.head.{m.group(1)}.{m.group(2)}"
    return None


def convert_dpt_state_dict(state_dict) -> dict:
    """omnidata/MiDaS DPT-hybrid (or HF transformers DPT) state dict ->
    flat HF-named float32 arrays for priors/dpt.py. Fused qkv weights
    split into query/key/value thirds."""
    arrays = convert_state_dict(state_dict)
    if any(k.startswith(("dpt.", "neck.", "head.")) for k in arrays):
        return arrays  # already HF naming
    out = {}
    for k, v in arrays.items():
        tgt = _midas_to_hf_key(k)
        if tgt is None:
            continue
        if isinstance(tgt, tuple):  # fused qkv
            _, i, leaf = tgt
            q, kk, vv = np.split(v, 3, axis=0)
            pre = f"dpt.encoder.layer.{i}.attention.attention"
            out[f"{pre}.query.{leaf}"] = q
            out[f"{pre}.key.{leaf}"] = kk
            out[f"{pre}.value.{leaf}"] = vv
        else:
            out[tgt] = v
    return out


# ZoeDepth-NYU (isl-org ZoeD_N) names


def _islorg_to_hf_key(k: str):
    """Map one isl-org/ZoeDepth (ZoeD_N) state-dict key to the
    HF-transformers naming priors/zoedepth.py consumes. Returns None
    for buffers/keys the network does not use; fused 'QKV' weights
    are handled by the caller (they split into three)."""
    if k == "core.core.pretrained.model.cls_token":
        return "backbone.embeddings.cls_token"
    m = re.match(r"core\.core\.pretrained\.model\.patch_embed\.proj\.(.+)", k)
    if m:
        return ("backbone.embeddings.patch_embeddings.projection."
                + m.group(1))
    m = re.match(r"core\.core\.pretrained\.model\.blocks\.(\d+)\.(.+)", k)
    if m:
        i, rest = m.group(1), m.group(2)
        pre = f"backbone.encoder.layer.{i}"
        table = {
            "norm1.weight": "layernorm_before.weight",
            "norm1.bias": "layernorm_before.bias",
            "norm2.weight": "layernorm_after.weight",
            "norm2.bias": "layernorm_after.bias",
            "attn.proj.weight": "attention.output.dense.weight",
            "attn.proj.bias": "attention.output.dense.bias",
            "mlp.fc1.weight": "intermediate.dense.weight",
            "mlp.fc1.bias": "intermediate.dense.bias",
            "mlp.fc2.weight": "output.dense.weight",
            "mlp.fc2.bias": "output.dense.bias",
            "gamma_1": "lambda_1",
            "gamma_2": "lambda_2",
            "attn.relative_position_bias_table":
                "attention.attention.relative_position_bias."
                "relative_position_bias_table",
            "attn.q_bias": "attention.attention.query.bias",
            "attn.v_bias": "attention.attention.value.bias",
        }
        if rest in table:
            return f"{pre}.{table[rest]}"
        if rest == "attn.qkv.weight":
            return ("QKV", i)
        return None  # relative_position_index / k_bias buffers
    m = re.match(
        r"core\.core\.pretrained\.act_postprocess(\d)"
        r"\.(\d+)(?:\.project\.0)?\.(weight|bias)", k)
    if m:
        stage = int(m.group(1)) - 1
        sub = int(m.group(2))
        leaf = m.group(3)
        if sub == 0:
            return f"neck.reassemble_stage.readout_projects.{stage}.0.{leaf}"
        if sub == 3:
            return f"neck.reassemble_stage.layers.{stage}.projection.{leaf}"
        if sub == 4:
            return f"neck.reassemble_stage.layers.{stage}.resize.{leaf}"
        return None
    m = re.match(r"core\.core\.scratch\.layer(\d)_rn\.weight", k)
    if m:
        return f"neck.convs.{int(m.group(1)) - 1}.weight"
    m = re.match(r"core\.core\.scratch\.refinenet(\d)\.(.+)", k)
    if m:
        layer = 4 - int(m.group(1))
        rest = m.group(2)
        rest = rest.replace("out_conv", "projection")
        rest = rest.replace("resConfUnit1", "residual_layer1")
        rest = rest.replace("resConfUnit2", "residual_layer2")
        rest = rest.replace("conv1", "convolution1").replace(
            "conv2", "convolution2")
        return f"neck.fusion_stage.layers.{layer}.{rest}"
    m = re.match(r"core\.core\.scratch\.output_conv\.(\d+)\.(weight|bias)", k)
    if m:
        return f"relative_head.conv{int(m.group(1)) // 2 + 1}.{m.group(2)}"
    m = re.match(r"conv2\.(weight|bias)", k)
    if m:
        return f"metric_head.conv2.{m.group(1)}"
    m = re.match(
        r"(seed_bin_regressor|seed_projector)\._net\.(\d)\.(weight|bias)", k)
    if m:
        return (f"metric_head.{m.group(1)}.conv{int(m.group(2)) // 2 + 1}"
                f".{m.group(3)}")
    m = re.match(
        r"(projectors|attractors)\.(\d)\._net\.(\d)\.(weight|bias)", k)
    if m:
        return (f"metric_head.{m.group(1)}.{m.group(2)}"
                f".conv{int(m.group(3)) // 2 + 1}.{m.group(4)}")
    m = re.match(
        r"conditional_log_binomial\.mlp\.(\d)\.(weight|bias)", k)
    if m:
        return f"metric_head.conditional_log_binomial.mlp.{m.group(1)}.{m.group(2)}"
    return None


def convert_zoedepth_state_dict(state_dict) -> dict:
    """isl-org ZoeD_N (or HF transformers ZoeDepth) state dict -> flat
    HF-named float32 arrays for priors/zoedepth.py. timm's fused qkv
    weight splits into query/key/value thirds (key carries no bias)."""
    arrays = convert_state_dict(state_dict)
    if any(k.startswith(("backbone.", "neck.", "metric_head."))
           for k in arrays):
        return {k: v for k, v in arrays.items()
                if not k.endswith("relative_position_index")}
    out = {}
    for k, v in arrays.items():
        tgt = _islorg_to_hf_key(k)
        if tgt is None:
            continue
        if isinstance(tgt, tuple):  # fused qkv weight
            _, i = tgt
            q, kk, vv = np.split(v, 3, axis=0)
            pre = f"backbone.encoder.layer.{i}.attention.attention"
            out[f"{pre}.query.weight"] = q
            out[f"{pre}.key.weight"] = kk
            out[f"{pre}.value.weight"] = vv
        else:
            out[tgt] = v
    # loud completeness check: a naming drift must not silently produce
    # a truncated network
    required = ["backbone.embeddings.cls_token",
                "backbone.encoder.layer.0.attention.attention.query.weight",
                "neck.convs.0.weight",
                "neck.fusion_stage.layers.3.projection.weight",
                "relative_head.conv3.weight",
                "metric_head.conv2.weight",
                "metric_head.seed_bin_regressor.conv1.weight",
                "metric_head.attractors.3.conv2.weight",
                "metric_head.conditional_log_binomial.mlp.2.weight"]
    missing = [r for r in required if r not in out]
    if missing:
        raise ValueError(f"ZoeDepth conversion incomplete; missing {missing}"
                         " — checkpoint naming not recognized")
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    convert = convert_checkpoint
    if argv and argv[0] in ("--dpt", "--zoe"):
        convert = (convert_dpt_checkpoint if argv[0] == "--dpt"
                   else convert_zoedepth_checkpoint)
        argv = argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    n = convert(Path(argv[0]), Path(argv[1]))
    print(f"wrote {argv[1]}: {n} tensors")


if __name__ == "__main__":
    main()
