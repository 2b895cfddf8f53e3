"""The whole training step's share of the card's dense bf16 peak: model
operations (``costs.step_flops``) of the untraced window over its
seconds. One reader for every cell: ``mfu.<kind>`` falls back to it."""


def read(ctx):
    if ctx.peak is None:
        return None
    w = ctx.window
    return 100.0 * w["flops_per_step"] * w["steps"] / w["seconds"] / \
        ctx.peak["bf16_dense_flops_per_s"]
