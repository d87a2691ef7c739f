"""Closed-loop serving over the cell's cards: ``serve_loop``'s traffic
(one client, a scene a request, each map written as ``.npy``, the same
weights, cubes and check) through ``serve --multihost``, one NCCL rank a
card.  Rank 0 reads each request, prepares its scene on its card and
broadcasts it; every rank maps its strip of the tiles; the labels are
gathered and rank 0 answers.

Rank 0 runs in this process, on a thread, as ``serve_loop`` runs its
server, with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
a free ``MASTER_PORT`` set in the environment; ranks 1 to chips - 1 are
child processes of ``python -m cmlpl_tpu_torch.cli.serve --multihost``
with the same flags on their own cards (their standard error in the run's
directory; on the CPU, for the tests, gloo ranks).  The kernels' library
is built before the ranks start, so no two build it.

No run hangs on a rank: while rank 0's server is awaited, the children
are watched, and one that exits, or a ready line that has not come
within :data:`READY_S` (the rendezvous and the warm-up map), ends the
run at once: the children are killed, their last lines printed, and the
process exits with code 1, since rank 0's thread may be held in a
collective that no peer will join.  :meth:`Driver.release` ends the
server (the end of its input), waits for the children to exit 0 and
destroys the process group.
"""

from __future__ import annotations

import os
import select
import socket
import subprocess
import sys
import time

import torch.distributed as dist

from portbench.drivers import serve_loop, serving

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: seconds from the ranks' start to rank 0's ready line
READY_S = 180.0
#: seconds a request's response may take once the server is ready
RESPONSE_S = 300.0
#: seconds the children may take to exit after the end of the input
EXIT_S = 60.0
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Lines:
    """The server's output pipe, read a line at a time while the other
    ranks are watched (the module docstring)."""

    def __init__(self, drv, fd: int):
        self.drv, self.fd, self.buf = drv, fd, b""
        self.limit = READY_S

    def readline(self) -> str:
        t0 = time.monotonic()
        while b"\n" not in self.buf:
            if select.select([self.fd], [], [], 0.5)[0]:
                chunk = os.read(self.fd, 1 << 16)
                if not chunk:                 # the server ended
                    line, self.buf = self.buf, b""
                    return line.decode()
                self.buf += chunk
                continue
            self.drv.watch()
            if time.monotonic() - t0 > self.limit:
                self.drv.fail(f"no line from rank 0 within {self.limit} s")
        line, _, self.buf = self.buf.partition(b"\n")
        self.limit = RESPONSE_S
        return line.decode() + "\n"

    def close(self) -> None:
        os.close(self.fd)


class Driver(serve_loop.Driver):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.chips = cell.chips
        self.procs = []
        self.logs = []

    def setup(self) -> None:
        from cmlpl_tpu_torch.ops._build import library
        from cmlpl_tpu_torch.weights import params_to_jax, save_params_npz
        self.inputs()
        path = os.path.join(self.dir, "weights.npz")
        save_params_npz(path, params_to_jax(
            {k: v.cpu() for k, v in self.weights.items()}))
        cuda = self.device.type == "cuda"
        if cuda:
            library()
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
               "WORLD_SIZE": str(self.chips)}
        flags = serving.argv(self.p, path, "cuda") + ["--multihost"]
        pypath = os.pathsep.join(filter(None, (ROOT, os.environ.get(
            "PYTHONPATH"))))
        for r in range(1, self.chips):
            log = open(os.path.join(self.dir, f"rank{r}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "cmlpl_tpu_torch.cli.serve",
                 *_on(flags, f"cuda:{r}" if cuda else "cpu")], cwd=ROOT,
                env=dict(os.environ, **env, RANK=str(r), LOCAL_RANK=str(r),
                         PYTHONPATH=pypath),
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                stderr=log))
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        serving.start(self, _on(flags, str(self.device)),
                      lambda fd: _Lines(self, fd))

    def watch(self) -> None:
        """Ends the run if a child rank has exited."""
        for r, p in enumerate(self.procs, 1):
            if p.poll() is not None:
                self.fail(f"rank {r} exited with {p.returncode}")

    def fail(self, why: str) -> None:
        """Kills the children, prints why and their last lines, and ends
        the process (the module docstring)."""
        names = [log.name for log in self.logs]
        self._kill()
        print(f"serve_ranks: {why}; rank 0's error: {self.error!r}",
              file=sys.stderr)
        for name in names:
            with open(name) as f:
                print(f"--- {os.path.basename(name)}\n{f.read()[-4000:]}",
                      file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)

    def release(self) -> None:
        super().release()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=EXIT_S))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ENV:
            os.environ.pop(k, None)
        if any(c != 0 for c in codes):
            raise RuntimeError(f"the other ranks ended with {codes}")

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.procs = []
        for log in self.logs:
            log.close()
        self.logs = []

    def close(self) -> None:
        self._kill()
        super().close()


def _on(flags: list, device: str) -> list:
    """``flags`` with ``--device`` set to ``device``."""
    out = list(flags)
    out[out.index("--device") + 1] = device
    return out
