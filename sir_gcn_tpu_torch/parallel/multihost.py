"""Starting the ranks of a distributed run (port of
``sir_gcn_tpu/parallel/multihost.py``).

A run of N ranks is N processes, one card each (NCCL), or N CPU processes
with ``--cpu`` (gloo). Two ways start them:

* under a launcher: ``torchrun --nproc-per-node N -m <trainer> ...``
  exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, and :func:`initialize_multihost` joins the group from
  them;
* outside one, a trainer given ``--mesh-devices N`` or ``--dp-devices N``
  spawns the N local ranks itself (:func:`spawn_ranks`), which meet
  through a file store in a fresh temporary directory, so the command
  reads as the JAX package's does.

Nothing falls back to one device: a rank that fails, or a collective that
times out, fails the run, and the spawning process raises.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this fails (the gloo and NCCL
# default is 10 or 30 minutes); a spawned run that lasts longer than
# DEFAULT_DEADLINE_S (None: no limit) is stopped. spawn_ranks reads both
# when it is called.
DEFAULT_TIMEOUT_S = 600.0
DEFAULT_DEADLINE_S: Optional[float] = None
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as a rank."""
    return all(v in os.environ for v in _LAUNCHER_ENV)


def _backend(cpu: bool) -> str:
    return "gloo" if cpu else "nccl"


def check_devices(world: int, cpu: bool) -> None:
    """Raise unless the machine can hold ``world`` ranks: any number on
    the CPU, one card each on NCCL."""
    if cpu:
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    if not launched() and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA devices; found "
                           f"{torch.cuda.device_count()}")


def initialize_multihost(cpu: bool = False, init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group: NCCL, or gloo with ``cpu``. With no
    arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a failure raises.
    On NCCL the current card becomes ``cuda:<LOCAL_RANK>``. Returns the
    topology (``process_index``, ``process_count``, ``local_rank``)."""
    if not dist.is_initialized():
        if init_method is None:
            init_method = "env://"
        dist.init_process_group(
            _backend(cpu), init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    if not cpu:
        torch.cuda.set_device(local_rank())
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_rank": local_rank()}


def local_rank() -> int:
    """The rank among this host's processes: ``LOCAL_RANK`` where the
    launcher (or :func:`spawn_ranks`) set it, else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(cpu: bool) -> torch.device:
    """This rank's device: the CPU with ``cpu``, else ``cuda:<local
    rank>``; raises without a card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    return torch.device("cuda", local_rank())


def trainer_device(cpu: bool, world: int) -> torch.device:
    """A trainer's device: this rank's (:func:`local_device`) in a run of
    ``world`` > 1 ranks, else the card (``cuda``) or, with ``cpu``, the
    CPU; raises without a card."""
    if world > 1:
        return local_device(cpu)
    from ..train import resolve_device

    return resolve_device(cpu)


def needs_spawn(world: int, cpu: bool) -> bool:
    """For a trainer asked for ``world`` ranks: False for one rank, or when
    this process already is a rank (a process group of ``world`` ranks,
    joined here from a launcher's environment); True when the caller
    should spawn the ranks itself (:func:`spawn_ranks`). Raises without
    the devices (:func:`check_devices`) or for a group of another size."""
    if world <= 1:
        return False
    check_devices(world, cpu)
    if not dist.is_initialized():
        if not launched():
            return True
        initialize_multihost(cpu=cpu)
    if dist.get_world_size() != world:
        raise ValueError(f"asked for {world} ranks in a process group of "
                         f"{dist.get_world_size()}")
    return False


def _rank_main(rank: int, world: int, init_method: str, cpu: bool,
               timeout_s: float, fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, send rank 0's
    value (or any rank's traceback) to the parent."""
    os.environ["LOCAL_RANK"] = str(rank)
    if cpu:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        initialize_multihost(cpu=cpu, init_method=init_method, rank=rank,
                             world_size=world, timeout_s=timeout_s)
        out = fn(*args)
        if rank == 0:
            results.put(("ok", out))
    except BaseException:
        results.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world: int, fn: Callable, *args, cpu: bool = False,
                timeout_s: Optional[float] = None,
                deadline_s: Optional[float] = None,
                store_dir: Optional[str] = None):
    """Run ``fn(*args)`` on ``world`` local ranks (new processes of the
    ``spawn`` method; ``fn`` and ``args`` are pickled, so ``fn`` is a
    module-level function) and return rank 0's value. The ranks meet
    through a file store in a fresh temporary directory (made under
    ``store_dir`` when given); ranks above 0 print nothing. A collective
    waits at most ``timeout_s``, the whole run at most ``deadline_s``
    (None for either: the module's ``DEFAULT_TIMEOUT_S``,
    ``DEFAULT_DEADLINE_S``). A rank that fails or a run past its deadline
    stops every rank and raises ``RuntimeError``."""
    import multiprocessing as mp

    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    deadline_s = DEFAULT_DEADLINE_S if deadline_s is None else deadline_s

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="sir_gcn_ranks_", dir=store_dir)
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_method, cpu, timeout_s, fn,
                               args, results), daemon=False)
             for r in range(world)]
    end = None if deadline_s is None else time.monotonic() + deadline_s
    value, errors = None, []
    got = False
    try:
        for p in procs:
            p.start()
        while True:
            try:
                kind, payload = results.get(timeout=0.2)
                if kind == "ok":
                    value, got = payload, True
                else:
                    errors.append(payload)
            except queue_mod.Empty:
                pass
            codes = [p.exitcode for p in procs]
            if errors or any(c not in (None, 0) for c in codes):
                break
            if all(c == 0 for c in codes) and results.empty():
                break
            if end is not None and time.monotonic() > end:
                errors.append(f"the ranks ran past their {deadline_s} s "
                              f"deadline")
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes) or not got:
        raise RuntimeError(f"distributed run of {world} ranks failed (exit "
                           f"codes {codes}):\n" + "\n".join(errors))
    return value
