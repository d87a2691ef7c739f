"""What the drivers share: the scene and splits of a seed, the program's
prepared scene, and the training state's checks."""

from __future__ import annotations

import contextlib

import numpy as np

from portbench import compare, scenes
from portbench.reference import prep as ref_prep


def scene(stream, p: dict, device):
    """(cube (rows, cols, bands) f32 numpy, flat int64 ground truth) of a
    synthetic scene of the configuration's geometry, made on ``device``."""
    cube, gt = scenes.make_scene(stream, p["rows"], p["cols"], p["bands"],
                                 p["classes"], device)
    return cube.cpu().numpy(), gt.reshape(-1).cpu().numpy()


def prepared(p: dict, cube: np.ndarray, gt: np.ndarray, n_pc: int,
             device):
    """The program's prepared scene of ``cube`` (its host prep and
    upload)."""
    from cmlpl_tpu_torch.data.prep import prepare_scene
    return prepare_scene(p["dataset_id"], cube=cube,
                         gt=gt.reshape(cube.shape[:2]),
                         patch_size=p["patch_size"], n_pc=n_pc,
                         device=device)


def reference_scene(cube: np.ndarray, n_pc: int, patch_size: int, device):
    """The plain reference's (padded PCA cube, spectra) of ``cube``."""
    return ref_prep.prepare(cube, n_pc, patch_size, device)


def training_checks(losses_prog, losses_ref, grads_prog: dict,
                    grads_ref: dict, change_prog: dict,
                    change_ref: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``change_gap`` and
    ``change_gap_median`` (:mod:`portbench.compare`) of one seed; a
    cell's limits name the ones it compares."""
    leaves = compare.kept_leaves(grads_ref)
    grad, grad_leaf = compare.norm_gap(grads_prog, grads_ref, leaves)
    chg, chg_leaf = compare.norm_gap(change_prog, change_ref, leaves)
    return {"loss_gap": compare.loss_gap(losses_prog, losses_ref),
            "grad_gap": grad, "change_gap": chg,
            "change_gap_median": compare.median_gap(change_prog, change_ref,
                                                    leaves),
            "grad_leaf": grad_leaf, "change_leaf": chg_leaf,
            "left_out": sorted(set(grads_ref) - set(leaves))}


def worst(checks: list) -> dict:
    """The largest of each number over a list of check dicts; the worst
    leaves' names (``<number>_leaf``, for the record) of the seed that
    read the largest, and every seed's leaves left out."""
    out = {k: max(float(c[k]) for c in checks) for k, v in checks[0].items()
           if isinstance(v, float)}
    for k in ("grad", "change"):
        if f"{k}_leaf" in checks[0]:
            out[f"{k}_leaf"] = max(checks, key=lambda c: c[f"{k}_gap"])[
                f"{k}_leaf"]
    if "left_out" in checks[0]:
        out["left_out"] = sorted({x for c in checks for x in c["left_out"]})
    return out


def span(prof, name: str):
    """A host span of the traced window (``profile.Profiled.span``), or
    nothing in an untraced one."""
    return contextlib.nullcontext() if prof is None else prof.span(name)
