"""Percent of the card's peak in the configured precision that the
steps completed in the traced window reach: their operations
(``counts.cmlpl_step_flops`` or ``counts.supervised_step_flops``, as the
driver counts them) over the window, over the published peak."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    peak = ctx.peaks["flops_per_s"][ctx.cell.config["precision"]]
    return 100.0 * ctx.window["flops"] / ctx.trace.window_s / peak
