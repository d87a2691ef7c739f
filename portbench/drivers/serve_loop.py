"""Closed-loop serving: one client sends a scene a request to the serve
CLI (``cli/serve.main``) running in this process, on a thread, through
pipes for its standard input and output, and waits for each response
before it sends the next.

Set-up makes one BaseNet2's weights (written as the ``.npz`` that
``--weights`` reads) and ``cubes`` distinct scenes at the
configuration's geometry (raw ``.npy`` cubes), all under a directory of
``TMPDIR`` removed after the run; starts the server, whose warm-up map is
set-up, and sends ``warm_requests`` requests that are not counted.  The
window cycles through the cubes, each response's map written as ``.npy``,
until ``--seconds`` have passed.  The check draws ``checked_requests`` of
the window's requests from the seed and compares each served map with
the plain reference's logits of its cube.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import compare, scenes
from portbench.drivers import common
from portbench.reference import basenet2 as ref_net
from portbench.reference import prep as ref_prep
from portbench.reference.precision import matmul_precision

#: pixels a block of the reference's map
BLOCK = 8192


class Driver:
    def __init__(self, cell, seed: int, device):
        self.p = cell.params
        self.seed = seed
        self.device = torch.device(device)
        self.thread = None
        self.dir = None

    def inputs(self) -> None:
        p, dev = self.p, self.device
        st = scenes.streams(self.seed, 3)
        self.dir = tempfile.mkdtemp(prefix="portbench-serve-")
        shapes = ref_net.shapes(p["n_pc"], p["bands"], p["classes"],
                                p["patch_size"])
        self.weights = scenes.basenet2_weights(st[0], shapes, 1, dev)[0]
        self.cubes = []
        for k, q in enumerate(st[1].spawn(p["cubes"])):
            cube, _ = scenes.make_scene(q, p["rows"], p["cols"], p["bands"],
                                        p["classes"], dev)
            path = os.path.join(self.dir, f"cube{k}.npy")
            np.save(path, cube.cpu().numpy())
            self.cubes.append(path)
        self.pick = np.random.default_rng(st[2])

    def setup(self) -> None:
        from cmlpl_tpu_torch.weights import params_to_jax, save_params_npz
        self.inputs()
        p = self.p
        wpath = os.path.join(self.dir, "weights.npz")
        save_params_npz(wpath, params_to_jax(
            {k: v.cpu() for k, v in self.weights.items()}))
        argv = ["--dataID", str(p["dataset_id"]), "--weights", wpath,
                "--n_PC", str(p["n_pc"]), "--w", str(p["patch_size"]),
                "--val_batch_size", str(p["serve_tile"]),
                "--device", str(self.device)]
        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self.error = None
        self.thread = threading.Thread(target=self._serve,
                                       args=(argv, r_in, w_out), daemon=True)
        self.thread.start()
        self.send = os.fdopen(w_in, "w")
        self.recv = os.fdopen(r_out, "r")
        ready = self.recv.readline()
        if '"ready"' not in ready:
            raise RuntimeError(f"the server did not start: {ready!r} "
                               f"{self.error!r}")
        self.count = 0
        for _ in range(p["warm_requests"]):
            if self._request()[1] is None:
                raise RuntimeError(f"warm-up request failed: {self.error!r}")

    def _serve(self, argv, r_in, w_out) -> None:
        from cmlpl_tpu_torch.cli import serve
        with os.fdopen(r_in, "r") as stdin, os.fdopen(w_out, "w") as stdout:
            try:
                serve.main(argv, stdin=stdin, stdout=stdout)
            except BaseException as e:   # reported by the client's reads
                self.error = e

    def _request(self):
        """Sends the next request and waits for its response: (seconds,
        response or None, (written, read) on the wall clock in ns)."""
        k = self.count
        self.count += 1
        out = os.path.join(self.dir, f"map{k}.npy")
        line = json.dumps({"cube": self.cubes[k % len(self.cubes)],
                           "out": out, "id": k}) + "\n"
        t0, w0 = time.perf_counter(), time.time_ns()
        self.send.write(line)
        self.send.flush()
        reply = self.recv.readline()
        dt, w1 = time.perf_counter() - t0, time.time_ns()
        resp = json.loads(reply) if reply else None
        if resp is not None and ("error" in resp or resp.get("id") != k):
            resp = None
        return dt, resp, (w0, w1)

    def window(self, seconds: float, prof) -> dict:
        lat, spans, self.served = [], [], []
        first = self.count
        t0 = time.perf_counter()
        while True:
            with common.span(prof, "request (server: read, prep, map, "
                             "write)"):
                dt, resp, span = self._request()
            lat.append(dt)
            spans.append(span)
            if resp is not None:
                self.served.append(resp["id"])
            if resp is None and self.error is not None:
                break
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.mark_end()
        attempted = self.count - first
        return {"seconds": elapsed, "attempted": attempted,
                "failed": attempted - len(self.served), "ok": len(self.served),
                "latencies": lat, "spans_ns": spans}

    def release(self) -> None:
        if self.thread is not None:
            self.send.close()
            self.thread.join(timeout=120)
            self.recv.close()
            if self.thread.is_alive():
                raise RuntimeError("the server did not stop")
            self.thread = None
        gc.collect()

    # -- the check ---------------------------------------------------------
    def _reference_logits(self, path: str, tf32: bool) -> torch.Tensor:
        p, dev = self.p, self.device
        padded, spectra = ref_prep.prepare(np.load(path), p["n_pc"],
                                           p["patch_size"], dev)
        params = {k: v.to(dev) for k, v in self.weights.items()}
        out = []
        with torch.no_grad(), matmul_precision(tf32):
            for s in range(0, spectra.shape[0], BLOCK):
                ids = torch.arange(s, min(s + BLOCK, spectra.shape[0]),
                                   device=dev)
                xp = ref_prep.patches(padded, ids, p["cols"], p["patch_size"])
                out.append(ref_net.forward(params, xp, spectra[ids])[0])
        return torch.cat(out)

    def check(self) -> dict:
        try:
            n = min(self.p["checked_requests"], len(self.served))
            chosen = sorted(self.pick.choice(self.served, n, replace=False))
            refs, gaps = {}, []
            for k in chosen:
                cube = self.cubes[k % len(self.cubes)]
                if cube not in refs:
                    refs[cube] = self._reference_logits(cube, False)
                labels = torch.from_numpy(np.load(os.path.join(
                    self.dir, f"map{k}.npy")).astype(np.int64))
                gaps.append(compare.label_gap(refs[cube], labels))
            return {"label_gap": max(gaps) if gaps else float("inf"),
                    "failed_requests": float(self.count - len(self.served)
                                             - self.p["warm_requests"])}
        finally:
            self.close()

    def control(self) -> dict:
        """The reference's TF32 map of each cube judged against its
        float32 logits (no program runs; :meth:`inputs` first)."""
        try:
            gaps = []
            for cube in self.cubes:
                low = self._reference_logits(cube, True).argmax(1)
                gaps.append(compare.label_gap(
                    self._reference_logits(cube, False), low))
            return {"label_gap": max(gaps)}
        finally:
            self.close()

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
