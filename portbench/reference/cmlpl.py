"""CMLPL training steps of one seed (liuli33/CMLPL ``train.py:146-289``).

A step takes the labeled and unlabeled batches' patches and spectra,
perturbs each of the four inputs of each network with its own Gaussian
noise (``train.py:157-184``), runs both BaseNet2s with dropout, smooths
the unlabeled pseudo labels with the other network's memory queue once
the queues are warm (``:195-237``), and minimises for each network the
labeled cross-entropy, the masked consistency with the other network's
smoothed labels and the contrastive pseudo-label-graph loss (``:239-271``),
each network by its own Adam.  The queues then take the step's rows.

Random draws come from one ``torch.Generator`` a seed, on the device, in
the order the step makes them: the noise of net B's patches (labeled,
then unlabeled) and spectra, the same for net E, then net B's and net
E's dropout masks (a uniform draw below the keep rate).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import basenet2
from portbench.reference.adam import Adam
from portbench.reference.precision import matmul_precision
from portbench.reference.prep import patches


def threshold(epoch: int, num_epochs: int, thr: float) -> float:
    """``thr * exp(-0.5 (epoch / E)^2)`` (``train.py:147-148``), rounded
    to float32."""
    return float(torch.tensor(math.exp(-0.5 * (epoch / num_epochs) ** 2)
                              * thr, dtype=torch.float32))


def smooth(feats, probs, qf, qp, alpha, temperature):
    """``alpha p + (1 - alpha) softmax(f Q^T / T) Q_p`` (``:213-219``)."""
    a = torch.softmax(feats @ qf.T / temperature, dim=1)
    return alpha * probs + (1 - alpha) * (a @ qp)


def graph(pr, pc):
    """(Q, Q_n) of the pseudo-label graph with self-loops (``:249-256``)."""
    q0 = pr @ pc.T
    eye = torch.eye(q0.shape[0], device=q0.device)
    q0 = q0 * (1 - eye) + eye
    q = q0 * (q0 >= 0.8).float()
    q = q / q.sum(1, keepdim=True)
    qn = (1 - q0) * (q0 <= 0.3).float()
    return q, qn / (qn.sum(1, keepdim=True) + 1e-8)


def contrastive(fr, fc, q, qn, temperature):
    """The graph contrastive loss (``:246-265``)."""
    sim = torch.exp(fr @ fc.T / temperature)
    sim = sim / sim.sum(1, keepdim=True)
    return ((-(torch.log(sim) * q).sum(1)).mean()
            + (torch.log(sim + 1) * qn).sum(1).mean())


def consistency(logits, probs, mask):
    """Masked soft cross-entropy, over the whole batch (``:239-242``)."""
    return (-(F.log_softmax(logits, 1) * probs).sum(1) * mask).mean()


def run(cfg: dict, params_b: dict, params_e: dict, run_seed: int,
        padded: torch.Tensor, spectra: torch.Tensor, cols: int, steps,
        tf32: bool = False) -> dict:
    """The steps of one seed from its initial params.  ``steps``: a list
    of (labeled ids, labeled classes, unlabeled ids, epoch, batch index).
    Returns ``losses`` [(total B, total E)] a step, ``grads`` (B's and E's
    gradients of the first step, by ``"net_b.<name>"``), ``params`` after
    the steps (same names) and ``queues`` {name: (feats, probs)} with the
    rows written so far."""
    dev = padded.device
    w = cfg["patch_size"]
    rate, scale = cfg["dropout"], cfg["noise"]
    temp = cfg["temperature"]
    g = torch.Generator(dev).manual_seed(run_seed)
    params = {f"net_b.{k}": v.clone() for k, v in params_b.items()}
    params.update({f"net_e.{k}": v.clone() for k, v in params_e.items()})
    opt_b = Adam({k: v for k, v in params.items() if k[4] == "b"}, cfg["lr"])
    opt_e = Adam({k: v for k, v in params.items() if k[4] == "e"}, cfg["lr"])
    size = 5 * cfg["labeled_batch"] * 2
    queues = {n: [torch.zeros(size, cfg["feat_dim"], device=dev),
                  torch.zeros(size, cfg["classes"], device=dev), 0]
              for n in ("w", "s")}
    out = {"losses": [], "grads": None}
    joint = 64 * (w // 4) ** 2 + basenet2.FEAT_DIM

    def noisy(a):
        return a + torch.randn(a.shape, generator=g, device=dev) * scale

    with matmul_precision(tf32):
        for li, ly, ui, epoch, index in steps:
            li, ui = (torch.as_tensor(a, device=dev).long() for a in (li, ui))
            y = torch.as_tensor(ly, device=dev).long()
            xp_l, xp_u = (patches(padded, i, cols, w) for i in (li, ui))
            x_l, x_u = spectra[li], spectra[ui]
            views = []
            for _ in range(2):
                views.append(torch.cat([noisy(xp_l), noisy(xp_u)]))
                views.append(torch.cat([noisy(x_l), noisy(x_u)]))
            keep_b, keep_e = (
                torch.rand((len(li) + len(ui), joint), generator=g,
                           device=dev) < 1.0 - rate for _ in range(2))
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            nb = {k[6:]: v for k, v in p.items() if k[4] == "b"}
            ne = {k[6:]: v for k, v in p.items() if k[4] == "e"}
            logit_b, feat_b = basenet2.forward(nb, views[0], views[1],
                                               keep_b, rate)
            logit_e, feat_e = basenet2.forward(ne, views[2], views[3],
                                               keep_e, rate)
            bt = len(li)
            lab_b, un_b, lab_e, un_e = (logit_b[:bt], logit_b[bt:],
                                        logit_e[:bt], logit_e[bt:])
            xs, xw = feat_b[bt:], feat_e[bt:]
            onehot = F.one_hot(y, cfg["classes"]).float()
            thr = threshold(epoch, cfg["num_epochs"], cfg["thr"])
            warm = epoch > 0 or index > cfg["queue_batch"]
            with torch.no_grad():
                po, po1 = (torch.softmax(un_e, 1), torch.softmax(un_b, 1))
                pr, pr1 = po, po1
                if warm:
                    pr = smooth(xw, po, *queues["w"][:2], cfg["alpha"], temp)
                    pr1 = smooth(xs, po1, *queues["s"][:2], cfg["alpha"],
                                 temp)
                mask = (pr.max(1).values >= thr).float()
                masks = (pr1.max(1).values >= thr).float()
                writes = {"w": (torch.cat([xw, feat_b[:bt]]),
                                torch.cat([po, onehot])),
                          "s": (torch.cat([xs, feat_e[:bt]]),
                                torch.cat([po1, onehot]))}
                q, qn = graph(pr1, pr)
            total_b = (F.cross_entropy(lab_b, y)
                       + cfg["w_contrast"] * contrastive(xs, xw.detach(), q,
                                                         qn, temp)
                       + cfg["w_consistency"] * consistency(un_b, pr, mask))
            total_e = (F.cross_entropy(lab_e, y)
                       + cfg["w_contrast"] * contrastive(xs.detach(), xw, q,
                                                         qn, temp)
                       + cfg["w_consistency"] * consistency(un_e, pr1,
                                                            masks))
            grads = dict(zip(p, torch.autograd.grad(total_b + total_e,
                                                    list(p.values()))))
            out["losses"].append((float(total_b.detach()),
                                  float(total_e.detach())))
            if out["grads"] is None:
                out["grads"] = grads
            params = {**opt_b.step({k: v for k, v in params.items()
                                    if k[4] == "b"}, grads),
                      **opt_e.step({k: v for k, v in params.items()
                                    if k[4] == "e"}, grads)}
            for n, (f, pb) in writes.items():
                qf, qp, ptr = queues[n]
                rows = (ptr + torch.arange(len(f), device=dev)) % size
                qf[rows], qp[rows] = f, pb
                queues[n][2] = (ptr + len(f)) % size
    out["params"] = params
    out["queues"] = {n: (q[0], q[1]) for n, q in queues.items()}
    return out
