"""Spawn W ranks of a function over gloo or NCCL and collect what each returns.

    results = spawn("evoworld_tpu_torch.parallel.checks:sharded_serving_rank", world_size=2,
                    workdir=tmp, device="cpu", args=(2, 4))

Each rank is a fresh `python -m evoworld_tpu_torch.parallel.launch <workdir>
<rank>` process that imports torch and the port only (never a test module),
brings the process group up through a `file://` rendezvous inside
`workdir` (no port is fixed, so concurrent jobs never meet), holds torch to
`threads` CPU threads, calls `target(mesh, *args)` with this rank's
`parallel.mesh.Mesh` and saves its return value (`torch.save`). A rank that
raises writes its traceback; `spawn` then raises with it once every rank has
ended or been killed at `timeout`. `Ranks` starts the ranks and returns at
once, for a caller with work of its own meanwhile. Started with no target,
the ranks import, bring the group up and wait for `call` to name it, so
that a caller can start them while it still needs the host and the card
for something else (a rank whose parent has gone stops waiting). Under
`torchrun` nothing here is needed: the CLIs bring the group up themselves
(`runtime.inference_setup`).
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import traceback

import torch


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


class Ranks:
    """`world_size` rank processes of `target` on `device` ("cuda" or "cpu":
    no default, so that a rank runs on the CPU only where the caller says so),
    started at construction; `results()` waits for them (the caller may
    compute meanwhile). With `target` None they wait for `call`."""

    def __init__(self, target: str | None, world_size: int, workdir: str, device: str, args: tuple = (),
                 mesh_model: int = 1, threads: int = 1, timeout: float = 900.0):
        os.makedirs(workdir, exist_ok=True)
        self.workdir, self.world_size, self.timeout, self.called = workdir, world_size, timeout, target is not None
        torch.save({"target": target, "args": args, "world_size": world_size, "device": device,
                    "mesh_model": mesh_model, "threads": threads, "parent": os.getpid()},
                   os.path.join(workdir, "job.pt"))
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the package's parent
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH", "")) if p)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads), PYTHONPATH=path)
        self.started = time.monotonic()
        self.deadline = self.started + timeout
        self.procs = [subprocess.Popen([sys.executable, "-m", "evoworld_tpu_torch.parallel.launch", workdir, str(r)],
                                       env=env) for r in range(world_size)]

    def call(self, target: str, args: tuple = (), timeout: float | None = None) -> Ranks:
        """Hand ranks started with no target theirs: every rank calls
        `target(mesh, *args)`; `timeout` (default the constructor's) counts
        from here."""
        if self.called:
            raise RuntimeError(f"the ranks in {self.workdir} already have their call")
        tmp = os.path.join(self.workdir, "call.pt.tmp")
        torch.save({"target": target, "args": args}, tmp)
        os.replace(tmp, os.path.join(self.workdir, "call.pt"))
        self.called, self.started = True, time.monotonic()
        self.deadline = self.started + (self.timeout if timeout is None else timeout)
        return self

    def kill(self) -> None:
        """End every rank still running (a caller giving up on the job)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self) -> list:
        """Every rank's return value in rank order; raises with the failed ranks' tracebacks."""
        if not self.called:
            self.kill()
            raise RuntimeError(f"the ranks in {self.workdir} were never given their call")
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.kill()
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.workdir, f"error.{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.returncode != 0:
                errors.append(f"rank {r} exited with code {p.returncode} (killed at the {self.timeout:.0f} s limit?)")
        if errors:
            raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
        return [torch.load(os.path.join(self.workdir, f"result.{r}.pt"), weights_only=False)
                for r in range(self.world_size)]


def spawn(target: str, world_size: int, workdir: str, device: str, args: tuple = (), **kwargs) -> list:
    """Run `target(mesh, *args)` on `world_size` ranks; returns their results in rank order."""
    return Ranks(target, world_size, workdir, device, args, **kwargs).results()


def _wait_for_call(workdir: str, parent: int) -> dict:
    """The call `Ranks.call` writes, once it is there; SystemExit where the
    process that started this rank has gone first."""
    path = os.path.join(workdir, "call.pt")
    while not os.path.exists(path):
        if os.getppid() != parent:
            raise SystemExit(f"the process that started this rank ({parent}) has gone; no call came")
        time.sleep(0.02)
    return torch.load(path, weights_only=False)


def _run_rank(workdir: str, rank: int) -> None:
    import torch.distributed as dist

    from evoworld_tpu_torch.parallel.mesh import init_distributed, make_mesh

    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    torch.set_num_threads(job["threads"])
    try:
        dev = init_distributed(job["device"], init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                               world_size=job["world_size"], rank=rank, local_rank=rank)
        mesh = make_mesh(dev, model=job["mesh_model"])
        if job["target"] is None:  # started ahead of its call
            job.update(_wait_for_call(workdir, job["parent"]))
        result = _resolve(job["target"])(mesh, *job["args"])
        torch.save(result, os.path.join(workdir, f"result.{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    _run_rank(sys.argv[1], int(sys.argv[2]))
