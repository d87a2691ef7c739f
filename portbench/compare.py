"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference computes from the same
inputs, compared with its cell's limit (``workloads/<cell>.json``).

Training (a step's state, handed on to the window):

- ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss, over the seeds, the checked steps and the networks.
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 - b1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``change_gap``: the same of each leaf's change after the checked steps;
  ``change_gap_median`` the median leaf's, where one small leaf's gap
  swings from seed to seed (SSRN's: a 24-element BatchNorm leaf whose
  element's gradient lies within rounding of 0 flips its Adam step).
- Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out of both: they move under Adam by round-off alone
  (a bias that BatchNorm cancels).

Serving: ``label_gap``, the widest gap by which the reference's logit of
a served label lies below the reference's best logit of that pixel (0
where the labels agree, small where rounding breaks a near tie).
"""

from __future__ import annotations

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the norm gaps
NEGLIGIBLE = 1e-3


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def kept_leaves(ref_grads: dict) -> list:
    """The leaves the norm gaps compare (:data:`NEGLIGIBLE`)."""
    n = norms(ref_grads)
    med = _median(n.values())
    return [k for k, v in n.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm(ref)) over ``leaves``."""
    np_, nr = norms({k: prog[k] for k in leaves}), norms(
        {k: ref[k] for k in leaves})
    med = _median(nr.values())
    return {k: abs(np_[k] - nr[k]) / max(nr[k], med) for k in leaves}


def norm_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """(the worst leaf's gap (:func:`leaf_gaps`), its name)."""
    gaps = leaf_gaps(prog, ref, leaves)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_gap(prog: dict, ref: dict, leaves) -> float:
    """The median leaf's gap (:func:`leaf_gaps`): steady from seed to seed
    where one small leaf's gap swings."""
    return _median(leaf_gaps(prog, ref, leaves).values())


def loss_gap(prog, ref) -> float:
    """Largest relative gap of paired losses (flat sequences)."""
    return max(abs(float(p) - float(r)) / abs(float(r))
               for p, r in zip(prog, ref))


def change(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def label_gap(ref_logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Widest ``max_c ref[i, c] - ref[i, label_i]`` over the pixels; a
    label outside the classes reads infinite."""
    labels = labels.long().to(ref_logits.device)
    if labels.shape[0] != ref_logits.shape[0] or bool(
            ((labels < 0) | (labels >= ref_logits.shape[1])).any()):
        return float("inf")
    best = ref_logits.max(1).values
    got = ref_logits.gather(1, labels[:, None])[:, 0]
    return float((best - got).max())
