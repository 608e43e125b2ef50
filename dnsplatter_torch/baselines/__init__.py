"""Baseline NeRF models for benchmark comparisons (counterpart of
dnsplatter_tpu/baselines/): g_nerfacto (RGB), g_depthnerfacto (RGB-D) and
g_neusfacto (NeuS SDF with RGB + D + N supervision), the nerfstudio models
the reference evaluates DN-Splatter against, as ray marchers over a
multiresolution hash field in plain PyTorch ops.
"""
