"""Percent of the card's peak in the configured precision that the
window's requests reach on a DBDA map: the least operations of each
request's map (``counts_dbda.map_flops``: the per-pixel spectral work
once a covered pixel, the rest once a patch) over the requests' summed
time."""

from portbench import counts_dbda


def read(ctx):
    w = ctx.window
    if ctx.trace is None or ctx.peaks is None or not w["ok"]:
        return None
    peak = ctx.peaks["flops_per_s"][ctx.cell.config["precision"]]
    flops = w["ok"] * counts_dbda.map_flops(ctx.cell.params)
    return 100.0 * flops / sum(w["latencies"]) / peak
