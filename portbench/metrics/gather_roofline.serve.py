"""Percent of its roofline that kernel 1 (``gather_patches_f32``) reaches
in the traced window's maps: the least time of a map's gathers
(``counts.map_gather_bytes`` over the card's HBM bandwidth), times the
maps its launches make up, over the launches' summed device time."""

from portbench import counts

KERNEL = "patch_gather"


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    launches, seconds = t.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    p = ctx.cell.params
    maps = launches / counts.map_tiles(p)
    least = maps * counts.map_gather_bytes(p) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / seconds
