"""The mesh of the sharded provers: W = 2^k ranks of a torch.distributed
process group, each with its card.

The port of the JAX package's parallel/mesh.py (``make_mesh``,
``lane_sharding``, ``replicated``).  Every rank runs the whole prover on
its own copy of the data; only the sum-checks' large rounds are split
(parallel/sumcheck_shard.py).  Rank s holds the rows i = s (mod W) of a
vector, in order (``shard``), so binding the top variable, which pairs row
g with row g + n/2, pairs rows of one rank while W divides n/2: every
round is a plain bind of the local rows, and one ``all_gather`` of the
ranks' last rows brings them back in global order.  The collectives are
the group's own (gloo or NCCL, as the caller made it); they are not
kernels, and nothing falls back: a failed collective raises.

``run_ranks`` starts W ranks as spawned processes on one machine, in a
gloo group with a FileStore rendezvous in a temporary directory (no port,
no network), and returns what each rank's function returned.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import secrets
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..errors import SpartanError


class Mesh:
    """W ranks of a process group (``group``: the default group when
    None), this process's rank among them and its card ``device``."""

    def __init__(self, group=None, device="cuda"):
        self.group = dist.group.WORLD if group is None else group
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        if self.size & (self.size - 1):
            raise ValueError(f"a mesh needs a power-of-two number of ranks, not {self.size}")
        self.log_size = self.size.bit_length() - 1
        self.backend = dist.get_backend(self.group)
        self.device = torch.device(device)
        self.gathers = 0  # all_gather calls, and their host seconds
        self.gather_s = 0.0

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (i = rank mod W, in order) of a replicated
        (n, 8) or (K, n, 8) tensor, contiguous."""
        if t.dim() not in (2, 3) or t.shape[-2] % self.size:
            raise ValueError(f"shard: (n, 8) or (K, n, 8) with {self.size} | n")
        return t[..., self.rank :: self.size, :].contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors of one shape, concatenated on dim 0 in rank
        order."""
        t0 = time.perf_counter()
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        self.gathers += 1
        self.gather_s += time.perf_counter() - t0
        return torch.cat(out)

    def same_on_all_ranks(self, t: torch.Tensor, what: str = "value") -> None:
        """Raise SpartanError on every rank unless ``t`` is equal on all."""
        g = self.all_gather(t.reshape(1, -1)).cpu()
        if not bool((g == g[:1]).all()):
            raise SpartanError(f"{what} differs across the ranks of the mesh")

    def common_rng(self):
        """A blind source equal on every rank: rank 0 draws a 32-byte seed
        and broadcasts it; draws are SHAKE256 of the seed and a counter,
        reduced mod q (bias below 2^-128)."""
        seed = torch.frombuffer(bytearray(secrets.token_bytes(32)), dtype=torch.uint8)
        seed = seed.to(self.device)
        dist.broadcast(seed, src=dist.get_global_rank(self.group, 0), group=self.group)
        return SeededDraws(seed.cpu().numpy().tobytes())


class SeededDraws:
    """rng(q) -> int in [0, q) from a seed, the same in every process."""

    def __init__(self, seed: bytes):
        self.seed = seed
        self.count = 0

    def __call__(self, q: int) -> int:
        self.count += 1
        nbytes = (q.bit_length() + 128 + 7) // 8
        h = hashlib.shake_256(self.seed + self.count.to_bytes(8, "little"))
        return int.from_bytes(h.digest(nbytes), "little") % q


def sharded(mesh, n: int) -> bool:
    """Whether a sum-check over n rows runs sharded on ``mesh``: a mesh of
    two or more ranks, each with at least two rows."""
    return mesh is not None and mesh.size > 1 and n >= 2 * mesh.size


def _rank_main(fn, rank: int, size: int, tmp: str, device: str, timeout: float,
               args: tuple) -> None:
    """A spawned rank: join the gloo group, run fn(mesh, *args), write
    its result (or its traceback) under ``tmp``."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        store = dist.FileStore(os.path.join(tmp, "store"), size)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=size,
                                timeout=timedelta(seconds=timeout))
        try:
            res = fn(Mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)


def run_ranks(fn, size: int, args: tuple = (), device="cuda", timeout: float = 600.0):
    """fn(mesh, *args) on ``size`` spawned ranks of one gloo group on
    ``device`` -> the ranks' results in rank order.  ``fn`` is a
    module-level function (spawn imports it by name); build the CUDA
    kernels before, so that the ranks only load them.  A rank that fails,
    or a run past ``timeout`` seconds, ends every rank and raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sp2-mesh-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, size, tmp, str(device), timeout, args))
                 for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    err = os.path.join(tmp, f"rank{bad[0]}.err")
                    why = open(err).read() if os.path.exists(err) else f"exit code {codes[bad[0]]}"
                    raise RuntimeError(f"rank {bad[0]} of {size} failed:\n{why}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{size} ranks did not finish in {timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
