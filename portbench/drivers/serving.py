"""What the serving drivers that came after ``serve_loop`` share: the
serve CLI's flags of a configuration, and the start of its server on a
thread of this process, through pipes, with its ready line and warm
requests (``serve_loop.Driver.setup``'s steps, for a driver that writes
other weights or starts other ranks)."""

from __future__ import annotations

import os
import threading


def argv(p: dict, weights: str, device) -> list:
    """The serve CLI's flags of the configuration ``p``, with
    ``--weights`` and ``--device``; ``--model`` where it names one."""
    out = ["--dataID", str(p["dataset_id"]), "--weights", weights,
           "--n_PC", str(p["n_pc"]), "--w", str(p["patch_size"]),
           "--val_batch_size", str(p["serve_tile"]),
           "--device", str(device)]
    if p.get("model", "basenet2") != "basenet2":
        out += ["--model", p["model"]]
    return out


def start(drv, argv: list, lines=None) -> None:
    """Runs ``serve.main(argv)`` on a thread of this process
    (``drv._serve``), its stdin and stdout pipes as ``drv.send`` and
    ``drv.recv`` (``lines(fd)`` wraps the read end, else a text file), and
    waits for its ready line; then sends ``warm_requests`` requests,
    which the window does not count.  Raises if the server does not
    start or a warm request fails."""
    r_in, w_in = os.pipe()
    r_out, w_out = os.pipe()
    drv.error = None
    drv.thread = threading.Thread(target=drv._serve,
                                  args=(argv, r_in, w_out), daemon=True)
    drv.thread.start()
    drv.send = os.fdopen(w_in, "w")
    drv.recv = os.fdopen(r_out, "r") if lines is None else lines(r_out)
    ready = drv.recv.readline()
    if '"ready"' not in ready:
        raise RuntimeError(f"the server did not start: {ready!r} "
                           f"{drv.error!r}")
    drv.count = 0
    for _ in range(drv.p["warm_requests"]):
        if drv._request()[1] is None:
            raise RuntimeError(f"warm-up request failed: {drv.error!r}")
