"""Multi-host coordination: ordered gather of encoded blocks to one file.

The distributed generalization of the reference's single-process writer
(ref go/writer.go): every host encodes its local shard of blocks with the
device pipeline, per-block byte sizes are all-gathered, writer-order
offsets are the exclusive prefix sum over the *global* block order (the
distributed blockIndex, ref go/block_index.go:16-23), and process 0
writes one byte-exact file.

Single-process (incl. the virtual CPU mesh) is the degenerate case and
shares all code paths except the cross-process allgather.

On a real multi-host slice, call ``jax.distributed.initialize()`` first
(``init_distributed`` wraps it); block batches are expected to be
process-sharded in process-major global order.
"""

from __future__ import annotations

import numpy as np

from .pipeline import EncodedBlocks

__all__ = ["init_distributed", "gather_blocks", "is_coordinator",
           "barrier"]


# Env vars whose mere presence signals multi-process intent (explicit
# coordinator config).
_INTENT_ENV = (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
)
# Cluster autodetect environments (SLURM, Open MPI, PMI, GKE): intent
# only when they announce MORE THAN ONE task -- every single-task job
# inside `salloc` sets SLURM_JOB_ID, and a bare job id must not turn a
# correct single-process run into a hard failure when jax's cluster
# autodetect chokes on a partial environment.
_INTENT_SIZE_ENV = (
    "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE",
    "PMI_SIZE", "K8S_NUM_PROCESSES",
)


def _multiprocess_intent(environ) -> bool:
    if any(environ.get(v) for v in _INTENT_ENV):
        return True
    for v in _INTENT_SIZE_ENV:
        val = environ.get(v)
        if val:
            try:
                if int(val) > 1:
                    return True
            except ValueError:
                return True  # unparseable size: assume intent
    return False


def _already_initialized() -> bool:
    """True iff jax.distributed.initialize() already succeeded in this
    process.  Checks jax.distributed's own client state: checking
    ``jax.process_count() > 1`` instead is a bug -- it initializes the
    XLA backends as a side effect, after which initialize() can never
    succeed, and it reads 1 on an uninitialized multi-host run."""
    try:
        from jax._src import distributed as _dist
        return _dist.global_state.client is not None
    except Exception:  # noqa: BLE001 - private API moved; fall through
        return False


def init_distributed(**kw) -> None:
    """Initialize multi-host JAX.

    A genuine coordinator failure must NOT degrade silently into a wrong
    single-process run: when the caller *intends* multi-process (explicit
    kwargs or cluster env vars present, incl. SLURM/Open MPI auto-detect
    environments), init errors propagate.  Only the plain single-process
    convenience call (no kwargs, no cluster env) and double-
    initialization are no-ops.
    """
    import os

    import jax

    if _already_initialized():
        return
    intended = bool(kw) or _multiprocess_intent(os.environ)
    try:
        jax.distributed.initialize(**kw)
    except Exception as e:  # noqa: BLE001 - classified below
        msg = str(e).lower()
        if "already initialized" in msg:
            return
        if not intended:
            return  # no multi-process intent anywhere: single process
        # jax's call-ordering error says "must be called before any JAX
        # computations/calls ..." -- match that phrase specifically so
        # genuine coordinator failures whose message merely mentions
        # "backend"/"initialize" keep the coordinator diagnosis
        if "must be called before" in msg:
            raise RuntimeError(
                "init_distributed() must be the first JAX call in the "
                "process: the XLA backends are already initialized, so "
                "multi-host setup can no longer happen.  Move "
                "init_distributed() (or jax.distributed.initialize()) "
                "above any other jax use") from e
        raise RuntimeError(
            "multi-host initialization failed (coordinator "
            "unreachable or misconfigured); refusing to continue "
            "as a single process") from e


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0


def barrier(name: str = "minnow_barrier") -> None:
    """Cross-process synchronization point (e.g. wait for the
    coordinator's file write before every process opens it for the
    sharded read-back).  Single-process: no-op."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils as mhu

    mhu.sync_global_devices(name)


def _kv_client():
    """The jax.distributed coordination-service KV client (None when
    uninitialized / unavailable)."""
    try:
        from jax._src import distributed as _dist
        return _dist.global_state.client
    except Exception:  # noqa: BLE001 - private API moved
        return None


# Per-process gather sequence number: all processes call gather_blocks
# in the same order (it is a collective), so the counter is globally
# consistent and keys from successive gathers never collide.
_GATHER_SEQ = [0]

# KV values go through one gRPC message each; chunk well under common
# 4 MB message limits.
_KV_CHUNK = 2 << 20


def gather_blocks(enc: EncodedBlocks, mode: str = None) -> EncodedBlocks:
    """Gather per-host encoded blocks into the global writer order
    (process-major), for the single coordinator-written file
    (ref writer order contract: go/block_index.go:16-23).

    Two transports:

    * ``"gather"`` (coordinator-only, the default at process_count > 4):
      every process ships its payload stream + metadata ONCE to the
      coordination service over the already-established jax.distributed
      channel; per-host traffic is O(local bytes) and only the
      coordinator materializes the global stream.  Returns the full
      EncodedBlocks on the coordinator and **None** everywhere else.
    * ``"allgather"`` (the default at process_count <= 4): the round-4
      payload allgather -- every process receives every byte, O(P x
      total bytes) DCN traffic.  Kept as the small-P fallback and for
      callers that need the result on every process.

    ``mode=None`` picks automatically; pass explicitly to force either.
    Handles *unequal* per-process block counts; in allgather mode
    payloads travel as ONE concatenated byte stream per process padded
    to the max per-process total (not per-block max), so overhead is
    bounded by the per-process total imbalance.
    """
    import jax

    if jax.process_count() == 1:
        return enc
    if mode is None:
        mode = ("gather" if jax.process_count() > 4
                and _kv_client() is not None else "allgather")
    if mode == "gather":
        return _gather_to_coordinator(enc)
    if mode != "allgather":
        raise ValueError("unknown gather mode %r" % mode)

    from jax.experimental import multihost_utils as mhu

    sizes = enc.sizes
    b_local = len(enc.payloads)
    local_total = int(sizes.sum())

    # (P, 2): per-process block count and payload total
    counts = np.asarray(mhu.process_allgather(
        np.asarray([b_local, local_total], np.int64)))
    counts = counts.reshape(-1, 2)
    max_b = int(counts[:, 0].max())
    max_total = int(counts[:, 1].max())

    # metadata padded to max_b rows
    meta = np.zeros((4, max_b), np.int64)
    meta[0, :b_local] = sizes
    meta[1, :b_local] = enc.mins.view(np.int64)
    meta[2, :b_local] = enc.bits
    meta[3, :b_local] = enc.lens
    all_meta = np.asarray(mhu.process_allgather(meta))
    all_meta = all_meta.reshape(-1, 4, max_b)

    # one ragged byte stream per process, padded to max_total
    stream = np.zeros(max_total, np.uint8)
    if local_total:
        stream[:local_total] = np.frombuffer(
            b"".join(enc.payloads), dtype=np.uint8)
    all_streams = np.asarray(mhu.process_allgather(stream))
    all_streams = all_streams.reshape(-1, max_total)

    payloads: list = []
    mins: list = []
    bits: list = []
    lens: list = []
    for p in range(counts.shape[0]):
        bp = int(counts[p, 0])
        p_sizes = all_meta[p, 0, :bp]
        offs = np.concatenate([[0], np.cumsum(p_sizes)])
        for i in range(bp):
            payloads.append(
                all_streams[p, offs[i]:offs[i + 1]].tobytes())
        mins.append(all_meta[p, 1, :bp])
        bits.append(all_meta[p, 2, :bp])
        lens.append(all_meta[p, 3, :bp])
    return EncodedBlocks(payloads,
                         np.concatenate(mins),
                         np.concatenate(bits),
                         np.concatenate(lens))


def _pack_shard(enc: EncodedBlocks) -> bytes:
    """One self-describing byte blob per process: block count, then the
    (4, B) int64 metadata (sizes, mins, bits, lens), then the
    concatenated payload stream."""
    b_local = len(enc.payloads)
    meta = np.empty((4, b_local), np.int64)
    meta[0] = enc.sizes
    meta[1] = enc.mins
    meta[2] = enc.bits
    meta[3] = enc.lens
    return (np.int64(b_local).tobytes() + meta.tobytes()
            + b"".join(enc.payloads))


def _unpack_shard(blob: bytes):
    """Inverse of _pack_shard: (payloads, mins, bits, lens) arrays."""
    b = int(np.frombuffer(blob[:8], np.int64)[0])
    meta = np.frombuffer(blob[8:8 + 32 * b], np.int64).reshape(4, b)
    sizes = meta[0]
    offs = 8 + 32 * b + np.concatenate([[0], np.cumsum(sizes)])
    payloads = [blob[offs[i]:offs[i + 1]] for i in range(b)]
    return payloads, meta[1], meta[2], meta[3]


def _gather_to_coordinator(enc: EncodedBlocks,
                           timeout_s: float = 600.0) -> EncodedBlocks:
    """Coordinator-only gather over the jax.distributed coordination
    service KV store (SURVEY section 5.8 single-writer gather): process
    p publishes its shard blob in <= _KV_CHUNK-byte chunks under keys
    only the coordinator reads; per-host traffic is its own bytes, the
    coordinator's is the global total.  Returns EncodedBlocks on the
    coordinator, None on every other process."""
    import jax

    client = _kv_client()
    if client is None:
        raise RuntimeError(
            "coordinator gather requires jax.distributed.initialize() "
            "(no coordination-service client)")
    seq, _GATHER_SEQ[0] = _GATHER_SEQ[0], _GATHER_SEQ[0] + 1
    p, n_proc = jax.process_index(), jax.process_count()
    prefix = "minnow_gather/%d" % seq

    if p != 0:
        blob = _pack_shard(enc)
        chunks = [blob[i:i + _KV_CHUNK]
                  for i in range(0, len(blob), _KV_CHUNK)] or [b""]
        for i, ch in enumerate(chunks):
            client.key_value_set_bytes("%s/%d/c%d" % (prefix, p, i), ch)
        # chunk count last: its presence tells the coordinator the data
        # chunks above are all committed
        client.key_value_set_bytes("%s/%d/n" % (prefix, p),
                                   str(len(chunks)).encode())
        return None

    timeout = int(timeout_s * 1000)  # the client API takes milliseconds
    payloads = list(enc.payloads)
    mins = [np.asarray(enc.mins, np.int64)]
    bits = [np.asarray(enc.bits, np.int64)]
    lens = [np.asarray(enc.lens, np.int64)]
    for q in range(1, n_proc):
        n_chunks = int(client.blocking_key_value_get_bytes(
            "%s/%d/n" % (prefix, q), timeout))
        blob = b"".join(
            client.blocking_key_value_get_bytes(
                "%s/%d/c%d" % (prefix, q, i), timeout)
            for i in range(n_chunks))
        pq, mq, bq, lq = _unpack_shard(blob)
        payloads.extend(pq)
        mins.append(mq)
        bits.append(bq)
        lens.append(lq)
    try:
        client.key_value_delete(prefix)
    except Exception:  # noqa: BLE001 - cleanup is best-effort
        pass
    return EncodedBlocks(payloads, np.concatenate(mins),
                         np.concatenate(bits), np.concatenate(lens))
