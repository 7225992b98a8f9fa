"""jepsen_tpu_torch: the PyTorch/CUDA port of jepsen_tpu.

The JAX package `jepsen_tpu` checks stored histories with JAX kernels on
a TPU; this package runs the same batch checks with PyTorch on an NVIDIA
Hopper GPU (H100), the closure squaring in a CUDA kernel written by hand
for `sm_90a`. It imports neither `jax` nor anything of `jepsen_tpu`:
where it needs a module of the JAX package it keeps its own copy, under
the same name and in the same place, so each module here has an
obvious counterpart there.

The ported slices are the batch sweeps — Elle list-append (dense, and
past the dense limit by SCC condensation) and rw-register, per-key
CAS-register linearizability, the stored checker — and the single-run
checker stack that `analyze` runs on one stored run (`checker`'s
compose, stats and friends, `Linearizable`, `checker.elle`'s
`AppendChecker` and `WrChecker`, `independent.checker`), and the test
runner that makes a history and checks it (`test`, `test-all`):

    cli            run_cli (test, test-all, analyze); analyze-store
    core           run (a test end to end) and analyze (one run)
    generator      the generator DSL and its threaded interpreter
    client, control, os_setup, db, net, nemesis
                   the harness: clients, the remote control plane, the
                   OS and DB lifecycles, partitions and faults
    workloads      noop_test, the atom DB; append, wr, register, bank,
                   long_fork
    store          run-dir walk, verdict journal, results.edn rendering
    ingest         history -> encoding (append or wr) in a spawned pool
    shm            the pool's shared-memory transport
    parallel       length bucketing, the supervised async dispatcher
                   (check_bucketed_async: packing, host->device copy,
                   OOM backdown, the watchdog), and check_long_history
                   for runs past DENSE_TXN_LIMIT
    supervisor     quarantine, strict mode and the self-nemesis
    gates          the JEPSEN_TPU_* gates the port reads
    checker/elle   encoders, edge build, closure, anomaly flags, verdicts
      kernels      dense closures over packed histories or edge lists
      condense     SCC condensation of long histories (numpy + scipy)
      graph        the host cycle classifier (oversized SCCs)
      wr           the rw-register encoder and verdict
      closure_square + csrc/closure_square.cu   the hand kernel
    _build         compiles csrc/*.cu with nvcc at first use
    devices        the torch.device every entry point runs on, and
                   the checkers' backend (auto|tpu: the device path)
    independent    per-key generators, split and checker; util: the
                   thread maps, relative time, retries

Entry points run on `cuda` unless the caller asks for `cpu`.
"""

__version__ = "0.1.0"
