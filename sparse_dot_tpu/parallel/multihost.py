"""Multi-host (multi-process) execution support.

The reference is strictly single-process — its only parallelism is
MKL's in-process OpenMP threading (``README.md:9-10``,
``_mkl_interface/_cfunctions.py:742-747``).  This module is the
scaling layer past one host: it wraps
``jax.distributed.initialize`` (the JAX runtime's coordination service
across hosts), and provides multihost-aware array placement so the sharded
constructors in :mod:`sparse_dot_tpu.parallel.ops` work unchanged when
the mesh spans processes.

Design notes
------------
* ``initialize()`` with no arguments defers to JAX's own cluster
  detection.  Explicit ``coordinator_address``/``num_processes``/
  ``process_id`` cover clusters it does not detect, and tests.
* In a multi-process program each process only *addresses* its local
  devices.  ``jax.device_put(host_array, NamedSharding)`` requires every
  shard to be addressable, so cross-process placement goes through
  ``jax.make_array_from_callback`` — each process materializes only the
  shards it owns (:func:`put_sharded`).
* Reading a global array back (``np.asarray``) only works for fully
  addressable arrays; :func:`gather_to_host` all-gathers across
  processes first when needed.

Everything degrades to plain single-process behavior when
``jax.process_count() == 1``, so the same code path is exercised by the
test suite on the virtual CPU mesh.
"""

import numpy as np

import jax


def is_initialized():
    """True once ``jax.distributed.initialize`` has run in this process.

    Deliberately touches NOTHING that would initialize the XLA backend
    (``jax.process_count()`` would): ``jax.distributed.initialize``
    must run before the first backend query, so the probe here has to
    stay side-effect free (review r5 finding)."""
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:
        return False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, **kwargs):
    """Join (or start) the multi-process JAX runtime.

    The analog of the reference's import-time MKL init
    (``_mkl_interface/__init__.py:108-163``) for the scaling dimension
    the reference never had.  No-ops when already initialized.  With no
    arguments, ``jax.distributed.initialize``'s own cluster detection
    (Slurm, Open MPI, ...) decides, and a process outside any detected
    cluster stays single-process; otherwise pass the coordinator's
    ``host:port`` plus the process grid.  Must
    run before the first JAX backend query in the process (a JAX
    constraint; the gating here is careful not to trigger one).

    Returns a dict of the resulting process topology (see
    :func:`process_info`).
    """
    auto = coordinator_address is None and num_processes is None
    if not is_initialized():
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
                **kwargs,
            )
        except (ValueError, RuntimeError):
            if not auto:
                raise
            # JAX's cluster detection found no cluster (or the backend
            # already runs): stay single-process.
    return process_info()


def shutdown():
    """Leave the multi-process runtime (no-op when not initialized)."""
    if is_initialized():
        jax.distributed.shutdown()


def process_info():
    """Process/device topology visible to this process."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
        "platform": jax.default_backend(),
    }


def put_sharded(host_array, mesh, spec):
    """Place a host array onto a mesh under a PartitionSpec, working
    across process boundaries.

    Single-process meshes use plain ``device_put``.  Multi-process
    meshes use ``jax.make_array_from_callback`` so each process only
    materializes the shards its local devices own — the host array is
    the *global* value (every process passes the same logical content;
    only the locally-needed slices are read).
    """
    sharding = jax.sharding.NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host_array, sharding)
    host_array = np.asarray(host_array)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


def gather_to_host(x):
    """Global device array -> host numpy array on every process.

    Fully-addressable arrays (single process, or replicated outputs)
    convert directly; otherwise the shards are all-gathered across processes
    first (``multihost_utils.process_allgather`` with tiled layout
    reassembles the global value).
    """
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def sync_global_devices(name="sparse_dot_tpu"):
    """Barrier across all processes (no-op single-process)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
