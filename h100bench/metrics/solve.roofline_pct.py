"""Share of the roofline of decode + solve (K3, ``ops/decode_solve.py``):
least time for the windows the window decoded, over the device time of K3's
kernels."""

KERNELS = ("decode_delta_kernel", "solve_product_kernel", "split_product_kernel",
           "solve_sum_kernel")
N_TRIS, N_FREE = 9976, 1261  # the template's (h100bench/frozen.py)


def read(ctx):
    from h100bench.metrics_ctx import summed

    c = ctx.counts
    if not c.get("ticks") or not c.get("windows"):
        return None
    out = ctx.hp["model"]["output"]
    ks, kr = int(out["layers_scale"][-1][2]), int(out["layers_rotat"][-1][2])
    flops, nbytes = summed(ctx.costs.decode_solve, c["windows"], c["ticks"], ks, kr, N_TRIS,
                           N_FREE)
    return ctx.share(flops, nbytes, KERNELS)
