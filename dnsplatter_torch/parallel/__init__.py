"""Multi-device training on torch.distributed (counterpart of
dnsplatter_tpu/parallel): explicit collectives, process bring-up and the
dp / Gaussian-sharded / tile-sharded train steps."""
