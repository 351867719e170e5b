"""Multi-host execution: jax.distributed entry + host-sharded EM/inference.

The reference scales beyond one machine with a Toil cluster workflow (one
signalMachine process per read per worker, file-based expectation merges —
SURVEY §2.3). Here:

* each host process calls :func:`initialize` (``jax.distributed``), after
  which ``jax.devices()`` is the GLOBAL device list and a single mesh
  spans all hosts; collectives run over NVLink within a host and the
  network across hosts;
* input is host-sharded: each process loads only its own slice of the
  read list (:func:`host_shard`), preps/stacks it locally, and
  :func:`global_batch` assembles a global sharded array from the
  process-local batches (no cross-host data movement — each host's reads
  land on its own devices);
* the EM/infer programs are the SAME single-program mesh code as
  single-host (`distributed.em_train_step`): the psum over the ``reads``
  axis becomes a cross-host collective automatically.

Launch recipe for GPU hosts: ONE process per host, owning all of that
host's cards (never two JAX processes on one card: each reserves most of
the card's memory when it starts). For N hosts:

    SIGNALALIGN_COORD=host0:8476 SIGNALALIGN_NPROC=<N> SIGNALALIGN_PROC=<i> \
        python -m signalalign_jax.cli train ... --distributed

Validated by tests/test_multihost.py on 2 simulated CPU processes.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """`jax.distributed.initialize` from args or SIGNALALIGN_* env vars.

    No-op when neither args nor env are present (single-process mode).
    Nothing on a plain GPU host describes a cluster to JAX, so a
    multi-process run always names its coordinator, process count and
    process id.
    """
    import jax

    coordinator = coordinator or os.environ.get("SIGNALALIGN_COORD")
    if num_processes is None and "SIGNALALIGN_NPROC" in os.environ:
        num_processes = int(os.environ["SIGNALALIGN_NPROC"])
    if process_id is None and "SIGNALALIGN_PROC" in os.environ:
        process_id = int(os.environ["SIGNALALIGN_PROC"])
    if coordinator is None and num_processes is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)


def process_info() -> Tuple[int, int]:
    """(process_index, process_count)."""
    import jax
    return jax.process_index(), jax.process_count()


def host_shard(items: Sequence, process_id: Optional[int] = None,
               num_processes: Optional[int] = None) -> List:
    """This host's slice of a global work list (round-robin, so read-size
    variation spreads evenly across hosts). Each host loads/preps only its
    own fast5s — input IO scales with host count."""
    import jax
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [it for i, it in enumerate(items) if i % n == pid]


def global_mesh(axis: str = "reads"):
    """Mesh over ALL devices of ALL processes (data-parallel reads axis)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def global_batch(mesh, local_args: Sequence[np.ndarray], axis: str = "reads"):
    """Assemble global sharded arrays from per-process local batches.

    ``local_args`` are the host-local stacked problem arrays (leading axis
    = local reads). Every process must pass the same number of reads per
    local device (pad the last batch by repeating a problem). The result
    is a tuple of jax global arrays sharded along ``axis`` whose shards
    live where their host loaded them.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS

    sharding = NamedSharding(mesh, PS(axis))
    out = []
    for a in local_args:
        a = np.asarray(a)
        global_shape = (a.shape[0] * jax.process_count(),) + a.shape[1:]
        arrs = [jax.device_put(chunk, d) for chunk, d in zip(
            np.split(a, len(mesh.local_devices)), mesh.local_devices)]
        out.append(jax.make_array_from_single_device_arrays(
            global_shape, sharding, arrs))
    return tuple(out)


def em_train_step_multihost(mesh, local_args, W: int, P: int, mode: int,
                            num_kmers: int = 0):
    """Host-sharded EM iteration: local batches -> global array -> the
    standard mesh EM program (distributed.em_train_step). Returns
    replicated (new_transitions, likelihood, totals[, kexp]) — identical
    on every process (the psum crosses hosts)."""
    from signalalign_jax.parallel import distributed as dist

    gargs = global_batch(mesh, local_args)
    return dist.em_train_step(mesh, gargs, W=W, P=P, mode=mode,
                              num_kmers=num_kmers)


def infer_step_multihost(mesh, local_args, W: int, P: int, mode: int):
    """Host-sharded posterior inference over the global mesh."""
    from signalalign_jax.parallel import distributed as dist

    gargs = global_batch(mesh, local_args)
    return dist.infer_step(mesh, gargs, W=W, P=P, mode=mode)
