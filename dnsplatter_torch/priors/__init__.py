"""Monocular-prior networks as nn.Modules (counterpart of
dnsplatter_tpu/priors/): the tf_efficientnet_b5_ap encoder and DSINE
(`efficientnet`, `dsine`), Omnidata's DPT-Hybrid (`dpt`), ZoeDepth-NYU
(`zoedepth`), and the checkpoint converters (`convert`).

Each network's `state_dict()` keys and shapes are the parameter keys of the
JAX package's functions, so a converted npz loads with
`load_state_dict(strict=True)` (`common.params_from_numpy`).
"""
