"""Several processes on one LOSO sweep over torch.distributed (counterpart of
multimodalsignal_tpu/parallel/multihost.py).

The JAX package joins N processes into one runtime and shards the sweep's
fold axis over every device of the job. Here each process (a rank) trains
one contiguous block of the sweep's lanes on its own GPU
(parallel/fold_sweep.py rank_block), and the ranks meet on the host:

  * The corpus is small and every rank stages the same one from the same
    config: data is replicated, never scattered. So put_global has no
    counterpart: each rank builds its own lanes from its replicated corpus.
  * Per-fold state (parameters, Adam moments, BN statistics, the schedules)
    lives only on the rank that trains the fold.
  * The only traffic is the per-epoch gather of the log columns and stop
    flags, the carry's gather at a checkpoint, and the final gather of the
    results: all of it host arrays. So the process group is gloo over CPU
    tensors, not NCCL: the compute stays on the card, and two ranks may
    share one GPU (NCCL refuses that).

A rank that raises leaves its peers in a collective: every collective here
times out after MMS_DIST_TIMEOUT seconds (default 1800; the first epoch may
build the CUDA kernels with nvcc), and gloo fails at once where a peer's
process has exited. Every gather carries its name, so ranks that fall out
of step raise instead of exchanging the wrong payloads.

Single-process (no process group, or one rank), every helper reduces to
the identity or a no-op, so the sweep has one code path.

Launch, one process per GPU (two may share one), all with the same
MMS_RUN_ID so that they agree on the run directory:

    MMS_COORDINATOR=localhost:29511 MMS_NUM_PROCESSES=2 MMS_PROCESS_ID=0 \\
        MMS_RUN_ID=r1 python -m multimodalsignal_tpu_torch.main ...
    MMS_COORDINATOR=localhost:29511 MMS_NUM_PROCESSES=2 MMS_PROCESS_ID=1 \\
        MMS_RUN_ID=r1 python -m multimodalsignal_tpu_torch.main ...
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "maybe_initialize_from_env",
    "shutdown",
    "is_primary",
    "log",
    "rank",
    "world_size",
    "to_host",
    "agree",
    "assert_agreement",
    "sync",
]

DEFAULT_TIMEOUT_S = 1800.0


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join this process into a gloo process group of `num_processes` ranks
    that meets at `coordinator_address` (host:port; rank 0 listens there),
    every collective bounded by MMS_DIST_TIMEOUT seconds. Raises if the
    group cannot form within that time: nothing falls back to a single
    process."""
    timeout_s = float(os.environ.get("MMS_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timedelta(seconds=timeout_s))


def maybe_initialize_from_env() -> bool:
    """initialize from MMS_COORDINATOR / MMS_NUM_PROCESSES / MMS_PROCESS_ID
    when all three are set; returns whether it did."""
    coord = os.environ.get("MMS_COORDINATOR")
    nproc = os.environ.get("MMS_NUM_PROCESSES")
    pid = os.environ.get("MMS_PROCESS_ID")
    if not (coord and nproc and pid):
        return False
    initialize(coord, int(nproc), int(pid))
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _multi() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    """This process's rank (0 single-process)."""
    return dist.get_rank() if _multi() else 0


def world_size() -> int:
    """The number of ranks (1 single-process)."""
    return dist.get_world_size() if _multi() else 1


def is_primary() -> bool:
    """True on the process that writes the run directory (rank 0)."""
    return rank() == 0


def log(*args, **kwargs) -> None:
    """print, on the primary process only."""
    if is_primary():
        print(*args, **kwargs)


def _gather(name: str, obj) -> list:
    """Every rank's `obj`, in rank order; raises where a rank gathered
    under another name (the ranks fell out of step)."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (name, obj))
    names = [n for n, _ in parts]
    if any(n != name for n in names):
        raise RuntimeError(f"multi-process collectives out of step: rank {rank()} gathered "
                           f"{name!r}, the ranks {names}")
    return [o for _, o in parts]


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _concat(parts: list):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_concat(list(c)) for c in zip(*parts)))
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(c)) for c in zip(*parts))
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def to_host(tree, name: str = "to_host"):
    """Every rank's fold-major tree (dicts, tuples, lists of arrays whose
    first axis is the rank's lanes; tensors come to the host) joined into
    the global fold order on every rank: rank r's block follows rank r-1's.
    Single-process: the tree as it is."""
    if not _multi():
        return tree
    return _concat(_gather(name, _host(tree)))


def agree(fn, name: str):
    """fn() on every rank, then one exchange of whether it ran out of
    device memory (torch.cuda.OutOfMemoryError): if it did on any rank,
    every rank raises that error (that rank its own, the others one that
    names it), so that replicated_sweep's halving takes the same branch
    everywhere. Returns fn()'s result. Single-process: fn()."""
    if not _multi():
        return fn()
    try:
        out, failure = fn(), None
    except torch.cuda.OutOfMemoryError as exc:
        out, failure = None, exc
    failed = [(r, message) for r, message in
              enumerate(_gather(name, None if failure is None else str(failure)))
              if message is not None]
    if failure is not None:
        raise failure
    if failed:
        r, message = failed[0]
        raise torch.cuda.OutOfMemoryError(f"rank {r} failed in {name}: {message}")
    return out


def assert_agreement(value: int, name: str) -> None:
    """Raise unless every process holds the same integer `value`.

    Guards host-side control decisions that must match across processes
    (the resume epoch read from a run directory that may not be shared): a
    divergence would put the per-epoch collectives out of step. No-op
    single-process."""
    if not _multi():
        return
    values = _gather(name, int(value))
    if any(v != values[0] for v in values):
        raise RuntimeError(
            f"multi-host disagreement on {name}: per-process values "
            f"{values} — is the run dir shared/replicated across "
            f"hosts? (checkpoint/resume requires every process to see the "
            f"same sweep_resume files)")


def sync(name: str = "mms_sync") -> None:
    """Barrier across processes (no-op single-process)."""
    if _multi():
        _gather(name, None)
