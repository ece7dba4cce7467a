"""Support-layer tests: sched (mirrors ref go/thread/thread_test.go),
profiling, distributed single-process path."""

import numpy as np

from minnow_tpu.utils import profiling, sched


def test_split_array_sums_match_serial():
    # parallel sum == serial sum under both strategies for many worker
    # counts (ref go/thread/thread_test.go:34-112)
    x = np.arange(10_000)
    want = x.sum()
    for workers in (1, 2, 3, 49, 100, 1000):
        for strategy in ("contiguous", "jump"):
            parts = np.zeros(max(workers, 1), dtype=np.int64)

            def work(w, start, end, step):
                s = 0
                for i in range(start, end, step):
                    s += x[i]
                parts[w] += s

            sched.split_array(len(x), workers, work, strategy)
            assert parts.sum() == want, (workers, strategy)


def test_worker_queue_runs_every_job():
    done = np.zeros(257, dtype=bool)
    sched.worker_queue(7, 257, lambda w, j: done.__setitem__(j, True))
    assert done.all()


def test_split_array_bad_strategy():
    import pytest

    with pytest.raises(ValueError, match="Unknown strategy"):
        sched.split_array(4, 2, lambda *a: None, "weighted")


def test_stage_timer():
    t = profiling.StageTimer()
    with t.stage("pack", nbytes=10**9):
        pass
    t.add("io", 0.5, 2 * 10**9)
    rep = t.report()
    assert rep["pack"]["bytes"] == 10**9
    assert rep["io"]["GBps"] == 4.0
    assert "seconds" in rep["pack"]
    assert isinstance(t.dump(), str)


def test_gather_blocks_single_process_identity():
    from minnow_tpu.parallel import BlockEncoder
    from minnow_tpu.parallel.distributed import (gather_blocks,
                                                 is_coordinator)

    x = np.arange(40, dtype=np.int64).reshape(4, 10)
    enc = BlockEncoder().encode_int_blocks(x)
    out = gather_blocks(enc)
    assert out is enc
    assert is_coordinator()


def test_weighted_contiguous_balances_and_covers():
    from minnow_tpu.utils.sched import (split_array, weighted_bounds,
                                        weighted_contiguous)

    rng = np.random.default_rng(0)
    weights = rng.uniform(0.1, 10, 100)
    x = np.arange(100)
    parts = np.zeros(8, dtype=np.int64)
    seen = np.zeros(100, dtype=bool)

    def work(w, start, end, step):
        for i in range(start, end, step):
            parts[w] += x[i]
            assert not seen[i]
            seen[i] = True

    split_array(100, 8, work, weighted_contiguous(weights))
    assert seen.all()
    assert parts.sum() == x.sum()
    # balance: chunk weights within 2x of the mean target
    bounds = weighted_bounds(weights, 8)
    sums = [weights[bounds[w]:bounds[w + 1]].sum() for w in range(8)]
    assert max(sums) <= 2 * weights.sum() / 8 + weights.max()


def test_multiprocess_gather_four_jax_processes():
    """Real 4-process jax.distributed run (CPU, gloo) with *unequal*
    per-process block counts and ragged block lengths: the
    coordinator-written minh file is byte-identical to a single-process
    host write (tools/multiprocess_gather_check.py)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # workers don't need the virtual mesh
    res = subprocess.run(
        [sys.executable,
         os.path.join(root, "tools", "multiprocess_gather_check.py")],
        env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "multiprocess gather OK" in res.stdout


def test_multiprocess_intent_single_worker_hostnames():
    """A single-worker environment (no coordinator, one task) must not
    read as multi-process intent; an explicit coordinator or a task
    count above one does."""
    from minnow_tpu.parallel import distributed

    assert not distributed._multiprocess_intent({})
    assert not distributed._multiprocess_intent({"SLURM_JOB_ID": "7"})
    assert distributed._multiprocess_intent(
        {"JAX_COORDINATOR_ADDRESS": "localhost:1234"})
    assert distributed._multiprocess_intent({"SLURM_NTASKS": "4"})
    assert not distributed._multiprocess_intent({"SLURM_NTASKS": "1"})


def test_init_distributed_propagates_intended_failures(monkeypatch):
    """A coordinator failure must not degrade silently into a wrong
    single-process run (init_distributed contract)."""
    import pytest

    from minnow_tpu.parallel import distributed

    import jax

    def boom(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(jax.distributed, "initialize", boom)

    # explicit multi-process intent (kwargs) -> propagate
    with pytest.raises(RuntimeError, match="refusing to continue"):
        distributed.init_distributed(
            coordinator_address="localhost:1", num_processes=2,
            process_id=0)

    # cluster env intent -> propagate
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="refusing to continue"):
        distributed.init_distributed()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")

    # no intent anywhere: plain single-process convenience, no raise
    distributed.init_distributed()

    # double-initialization stays a no-op
    def already(**kw):
        raise RuntimeError("jax.distributed is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    distributed.init_distributed(coordinator_address="x", num_processes=2,
                                 process_id=0)


def test_init_distributed_backend_already_init_classified(monkeypatch):
    """The 'backends already initialized' RuntimeError from
    jax.distributed.initialize must be reported as a call-ordering bug,
    not a coordinator failure (ADVICE r2)."""
    import pytest

    from minnow_tpu.parallel import distributed

    import jax

    def too_late(**kw):
        raise RuntimeError(
            "jax.distributed.initialize() must be called before any JAX "
            "calls that might initialize the XLA backend")

    monkeypatch.setattr(jax.distributed, "initialize", too_late)
    with pytest.raises(RuntimeError, match="first JAX call"):
        distributed.init_distributed(
            coordinator_address="localhost:1", num_processes=2,
            process_id=0)


def test_init_distributed_cluster_env_intent(monkeypatch):
    """SLURM / Open MPI auto-detect environments count as multi-process
    intent only when they announce MORE THAN ONE task: an init failure
    there must propagate; a single-task allocation (bare SLURM_JOB_ID,
    ntasks=1) must stay a working single-process run (ADVICE r2)."""
    import pytest

    from minnow_tpu.parallel import distributed

    import jax

    def boom(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.setenv(var, "4")
        with pytest.raises(RuntimeError, match="refusing to continue"):
            distributed.init_distributed()
        monkeypatch.delenv(var)

    # single-task SLURM allocation: no intent, silent single-process
    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    distributed.init_distributed()
    monkeypatch.delenv("SLURM_JOB_ID")
    monkeypatch.delenv("SLURM_NTASKS")


def test_init_distributed_error_classification(monkeypatch):
    """A coordinator error whose message merely mentions 'backend' and
    'initialize' keeps the coordinator diagnosis; only jax's 'must be
    called before' phrase maps to the call-ordering message."""
    import pytest

    from minnow_tpu.parallel import distributed

    import jax

    def deadline(**kw):
        raise RuntimeError(
            "failed to initialize distributed backend: "
            "DEADLINE_EXCEEDED")

    monkeypatch.setattr(jax.distributed, "initialize", deadline)
    with pytest.raises(RuntimeError, match="coordinator"):
        distributed.init_distributed(
            coordinator_address="localhost:1", num_processes=2,
            process_id=0)


def test_already_initialized_does_not_touch_backends(monkeypatch):
    """_already_initialized must not initialize XLA backends as a side
    effect; it reads jax.distributed's own client state."""
    from minnow_tpu.parallel import distributed

    assert distributed._already_initialized() is False

    class FakeClient:
        pass

    from jax._src import distributed as _dist

    monkeypatch.setattr(_dist.global_state, "client", FakeClient())
    assert distributed._already_initialized() is True
