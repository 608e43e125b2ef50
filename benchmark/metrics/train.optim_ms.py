"""Device time of the kernels inside `adam_step` and `update_stats` per
step."""


def read(ctx):
    sp = ctx["trace"]["span_device_s"]
    if "adam_step" not in sp:
        return None
    return 1e3 * (sp["adam_step"] + sp.get("update_stats", 0.0)) / ctx["units"]
