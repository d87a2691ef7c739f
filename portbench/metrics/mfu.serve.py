"""Percent of the card's peak in the configured precision that the
window's requests reach: the least operations of each request's map
(``counts.dense_map_flops``) over the requests' summed time."""

from portbench import counts


def read(ctx):
    w = ctx.window
    if ctx.trace is None or ctx.peaks is None or not w["ok"]:
        return None
    peak = ctx.peaks["flops_per_s"][ctx.cell.config["precision"]]
    flops = w["ok"] * counts.dense_map_flops(ctx.cell.params)
    return 100.0 * flops / sum(w["latencies"]) / peak
