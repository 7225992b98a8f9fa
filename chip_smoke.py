#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`jepsen_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; it refuses to run without CUDA. Phases, each fatal on
failure:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    every csrc/*.cu kernel from this checkout's sources
  3. kernels  each hand kernel held to its plain PyTorch version on the
              card (exact equality of every output; closure_square also
              with its device word `active` at 1 and at 0, the skipped
              round returning its input), then timed at the main path's
              shape beside the plain version and the nearest library
              calls (bf16 bmm, and int8 torch._int_mm), closure_square's
              skipped round too
  4. main     `analyze-store --checker append` on cuda over a synthetic
              two-level store of 64 runs x 10,000 ops (T=5000 txns,
              K=64 keys, every 8th run carrying a G1c cycle): exactly the
              corrupt runs must come out G1c/invalid, the launch counts
              must show the closures went through the kernel (every
              round of every closure enqueued, the active ones equal to
              the buckets' closure rounds; CUDA event pairs around each
              launch time it), and a
              re-run with the plain squaring on a copy of the store must
              write byte-identical results; then the installed CLI,
              `python -m jepsen_tpu_torch.cli ... --device cuda`, on a
              small store, byte-identical to a --device cpu run
  5. wr       `analyze-store --checker wr` on cuda over a synthetic
              rw-register store of 32 runs x 10,000 ops (5,000 txns, K=64
              keys, every 8th run carrying a write-skew pair): exactly
              those runs must come out G2-item/invalid, the launches must
              equal the buckets' closure rounds, and a plain-squaring
              re-run on a copy of 8 of the runs must write byte-identical
              results
  6. long     `analyze-store --checker append` over 3 list-append runs of
              100,000 ops (50,000 txns, K=64), past the dense limit, so
              through SCC condensation: a valid run (no SCC, no launch),
              one with an adjacent G1c pair (a 2-txn SCC) and one whose
              read observes an append 16,304 txns into its future (one
              SCC of ~4,000 txns, classified by closure_square at
              T_pad=4096); verdicts as designed, launches equal to the
              closure rounds, and a plain-squaring re-run of the two
              cyclic runs byte-identical
  7. knossos  the dense configuration-grid kernel, knossos_dense_scan,
              held to its plain version scan_dense_ref on the card (exact
              equality of valid [B] and of the Jacobi rounds [B]) at S from
              1 to 14 slots x V from 3 to 64 values, ragged histories with
              pad steps, valid and corrupt, B from 1 to 256: at least two
              cases in each tier (warp, block) and a case on each side of
              the tier boundary at V = 8 and V = 64; then timed beside the
              plain version at the main shape: 100 histories of 1,000 ops
              at concurrency 10 (BASELINE config #1)
  8. register `analyze-store --checker register` on cuda over a store of
              64 lifted CAS-register runs x 1,000 ops over 50 keys
              (every 8th run carrying a read of a value never written on
              key 0): exactly those runs invalid with failures ["0"], the
              dense kernel launched, and a re-run with scan_dense_ref on
              a copy byte-identical; then config #1's 100 histories and
              their 100 corrupt copies through Linearizable.check_batch,
              every valid? equal to the native WGL oracle's; then the
              conc-20 populations (high concurrency, and value-rich),
              which take all three tiers (dense, frontier, WGL), equal
              to the oracle, the frontier tier through the hand kernel
              knossos_frontier_scan (launched, its launches and device ms
              a path of their own: `conc20`)
  9. store    the rest of `analyze-store` on cuda over one mixed store:
              32 list-append runs at phase 4's width (every 8th with
              G1c), 16 lifted CAS-register runs (phase 8's shape), and
              under `other` a queue run, a torn history.jsonl, an empty
              run dir and a run stored as the Clojure reference stores
              it (test.fressian, history.edn). An uninterrupted append
              sweep, then one cut mid-way through the synth verdicts
              (VerdictJournal.record raises KeyboardInterrupt) and
              resumed by `python -m jepsen_tpu_torch.cli ... --resume`
              in a subprocess: equal exit codes, byte-identical per-run
              files (results, markers, test.json) and links, the
              journal less the cut line, and fewer closure_square
              launches (but some) on resume. The same for register,
              cut within the register verdicts, resumed in process:
              fewer keys through knossos_dense_scan. Then `--checker
              stored --name other` touches other's runs only. Each
              compared pair of sweeps runs on one path in turn (the
              empty run's verdict holds its path).
 10. supervisor  the supervised dispatcher over 32 list-append histories
              at phase 4's width: (a) check_bucketed_async (two buckets
              in flight, the pack-h2d thread) against the synchronous
              path (JEPSEN_TPU_PACK_THREAD=0, one in flight): equal
              verdicts, walls and the device's idle share, and
              is_ready() false right after the dispatch of one bucket
              of every history returns; (b) a real
              torch.cuda.OutOfMemoryError under a memory cap between one
              history's footprint and one bucket's: buckets split, equal
              verdicts; (c) `python -m jepsen_tpu_torch.cli` under
              JEPSEN_TPU_FAULT_INJECT=encode:0.4,oom:first over phase
              9's store: exit 2, the nemesis's runs quarantined (stage
              encode), every other run byte-identical to phase 9's clean
              sweep; (d) JEPSEN_TPU_DISPATCH_TIMEOUT_S far below that
              bucket's device time: the bucket quarantined (stage
              watchdog), and the next sweep without it clean; (e)
              JEPSEN_TPU_STRICT=1 with oom:first exits non-zero.
 11. telemetry  (a) knossos_dense_scan's stats build (peak occupancy)
              against scan_dense_ref with stats, valid, rounds and peak
              exactly, in the warp tier at config #1's grid (S=10, V=8)
              and in the block tier (S=12, V=8 and S=14, V=64: past 512
              words); both builds timed in turns at config #1's shape;
              the Elle closure at the append bucket's shape timed with
              and without its per-round counters, and _graph_stats;
              (b) small stores of each path (append, wr, long runs
              condensed at a lowered dense limit, register) swept with
              JEPSEN_TPU_KERNEL_STATS=1 by the kernels and by their plain
              versions: analytics.jsonl byte-identical; (c) the stores of
              phases 4, 5, 6 and 8 swept again with the stats gate and
              --report: verdict files byte-identical to their stats-off
              sweeps', the same kernel launches, trace.json,
              metrics.json, events.jsonl, report.json and
              analytics.jsonl present and parsed, the counters equal to
              the bucket logs'; the append sweep's attribution (stage
              shares, the device's idle share) printed; (d) the append
              sweep's wall with JEPSEN_TPU_TRACE=0, with the default
              tracer and with the stats gate, in turns; (e) one
              JEPSEN_TPU_JAX_PROFILE=1 sweep of a small append store:
              its torch.profiler Chrome trace holds CUDA kernel events
              named closure_square.
 12. native ingest  phase 4's store (64 x T=5000) and phase 5's wr store
              (32 x T=5000) swept again with their sidecars removed
              (cold: every run through the native encoder, csrc/
              hist_encode.cc, which writes the encoded sidecar), then
              warm (every run a cache hit; the append buckets packed
              from the dispatch-shaped v2 views): verdict files
              byte-identical to phases 4 and 5, the same closure_square
              launches, cache_hits / cache_misses in metrics.json equal
              to the runs, no native fallback; each sweep's wall, parse
              share and the device's idle share (report.json) and
              histories/s printed with the card's name and power limit.
 13. pooled ingest  the sweeps' spawned encode workers, driven from a
              subprocess (`python -m jepsen_tpu_torch.tools.pool_smoke`,
              which, unlike this script, imports no torch in the
              workers spawn re-imports it in). /dev/shm's size first.
              A store of 32 list-append runs at phase 4's width (every
              8th with G1c): (a) every encoding the pool delivers equals
              the serial path's, array for array and in run order
              (the cache off, so both parse; phase 5's wr store too),
              both ingest walls printed; (b) the plain sweep (plain
              squaring, serial ingest), then the pooled CLI cold and
              warm: the same results, markers and journal, closure_square
              launches equal to the rounds the plain sweep enqueued,
              the pool run in full (`pooled`, a worker pid track in
              trace.json, no serial resume); wall, histories/s, parse
              and idle shares, workers, shm_bytes, worker_spans and the
              measured overlap of the workers' parse spans with the
              device windows; the same sweeps through the serial
              ingest, cold and warm, and pooled cold with one worker
              fewer than the cores (the parent's own core), each in
              its own process with its CUDA context made before the
              sweep; phase 5's wr store (cold) and phase 8's
              register store through the pooled CLI, verdict files and
              launches as in those phases; (c) the register store's
              load, pooled against serial; (d) JEPSEN_TPU_FAULT_INJECT=
              kill:0.05 on a copy of the store: a worker SIGKILLs
              itself, the sweep resumes serially, exit 2, the selected
              runs quarantined (encode) and every other run as the
              clean sweep's; no jttshm_<pid>_* segment of this process
              or its sweeps left in /dev/shm.
 14. analyze  `run_cli`'s `analyze` of one stored run, in this process,
              through the checkers a suite composes, each path held to
              its plain version on a copy (every file byte-identical
              relative to its store, but the run's trace.json and
              metrics.json): (a) a list-append run at phase 4's width
              carrying a G1c pair and a valid one, through compose(elle
              append_checker(backend="tpu"), stats, unhandled
              exceptions): exit 1 and 0, G1c with its cycle-txns
              witness, elle/G1c.txt and anomalies.edn, closure_square
              launches equal to the dispatches' enqueued rounds; (b) a
              rw-register run at phase 5's width with a write-skew pair
              through rw_register_checker(backend="tpu"); (c) a lifted
              CAS-register run of phase 8's shape (1,000 ops over 50
              keys, key 0 corrupt) through independent.checker(
              linearizable(backend="tpu")), the batch route: failures
              [0], every key's results.edn and history.edn, linear.svg
              for key 0 alone; (d) the same run through
              independent.checker(compose(timeline, linearizable)), the
              fan-out route: one knossos_dense_scan launch a key from
              the pool's threads, every key's verdict as (c)'s, a
              timeline.html a key; its device time from a second pass
              on one thread, whose event pairs bracket no other
              thread's wait; (e) backend="race": verdicts as (c)'s, the
              winning side printed, a losing device side's verdicts
              held to the CPU side's; (f) `analyze-store
              --backend cpu` on a store written as phase 4's small CLI
              store: the device sweep's verdicts.jsonl and verdicts,
              no launch.
 15. costdb   the device cost observatory, the live telemetry and the
              planner: phase 4's store swept with JEPSEN_TPU_COSTDB=1,
              JEPSEN_TPU_HEALTH_INTERVAL_S=0.5, JEPSEN_TPU_METRICS_PORT
              at a free port, JEPSEN_TPU_PLANNER=1 (cold) and
              --report, /metrics scraped from the
              sweep's start to its end: verdict files and launches as
              phase 4's, every costdb record measured (CUDA events) on
              the card against its peak row, every roofline share at
              most 1.05, Σ device_secs at least the closure_square
              event sum (both printed beside the tracer's bucket
              windows), the allocator's bytes in the residency gauges
              and health.json, health.json's progress complete; the
              same for phase 5's wr store, which writes no costdb (its
              edge batches are not observed, as in the reference); a
              planner store (8 of phase 4's runs and 8 shorter ones)
              swept with JEPSEN_TPU_PLANNER=1 cold (buckets as
              bucket_by_length's at multiple 128; plan.json fitted) and
              warm (buckets composed at another multiple, from the
              store's own plan.json, or from one seeded with T_pad²
              costs when that fit keeps 128): phase 4's runs' verdicts
              unchanged, warm equal to cold; then
              `kernels._edges_batched(with_counts=True)` timed apart
              from its bucket at phase 4's shape against its bytes, and
              the wr path's edge_batch_to_device at phase 5's.
 16. serve    the verdict daemon, in process on the card
              (`serve.VerdictDaemon`, JEPSEN_TPU_METRICS_PORT and a
              0.5 s health interval), three tenants at once: A (weight
              2) submits 32 of phase 4's runs by dir, B the other 32,
              half inline and half through shared memory, C phase 5's
              32 wr runs by dir. Every ack equals phase 4's or 5's
              results.json (so exactly the corrupt runs are invalid),
              every id is journaled once, closure_square launches on
              `serve-append` and `serve-wr` (each fold's launches and
              buckets recorded on the dispatch thread; the active
              launches equal the folds' closure rounds), /metrics has
              the per-tenant series and health.json's serve section
              names the three; resending every id on new connections
              replays each with no launch. Then `python -m
              jepsen_tpu_torch.cli serve --device cuda`: SIGKILLed
              after 8 acks of phase 4's 64 runs, restarted, every id
              resent: the journaled ones replay, every id is journaled
              once, and SIGTERM drains with exit 0. Prints the fold
              sizes and buckets, verdicts/s, the serve_request spans'
              p50 and p99 and the launches and device ms per path.
 17. fleet    `python -m jepsen_tpu_torch.cli fleet --daemons 3
              --device cuda` on the one card, three tenants over phase
              4's 64 runs by dir; tenant A's affine member is
              SIGKILLed once it has journaled A's first verdict: every
              verdict arrives once, equal to phase 4's, every id is
              journaled once, fleet-reassign.jsonl records A's move,
              the router's SIGTERM exits 0 and every member is gone.
              The members are other processes, so their launches are
              not counted here (phase 16 shows the kernel path).
 18. mesh     `analyze-store --mesh --device cuda`, two shard processes
              at once on the one card over a cold copy of the first 32
              of phase 4's runs (JEPSEN_TPU_MESH_SHARDS=2): (a) both shards with
              JEPSEN_TPU_COSTDB=1 and --report: each shard verdicts its
              own `shard_of` slice (its journal holds it), shard 1 exits
              its own worst and the coordinator the merged 1, the
              summary line reads 32 verdicted and 4 invalid, every
              results.json/.edn byte-identical to phase 4's, each
              shard's costdb holds closure_square dispatches and the
              merged costdb.jsonl their sum, report.json has per_shard
              "0" and "1"; the two-shard wall printed beside phase 4's;
              (b) on a warm copy, shard 1's process group SIGKILLed
              once its journal holds two lines (so its resume needs a
              bucket of two fewer; nothing of it left 2 s on),
              shard 0 alone with JEPSEN_TPU_MESH_WAIT_S=0 exits 2 with
              shard 1 lost, shard 1 --resume (its per-run markers
              stripped: journal-only evidence) re-checks exactly its
              un-journaled runs, with fewer closure_square launches than
              the whole shard and at most as many buckets, and shard 0
              --resume --report merges the complete fleet, exit 1; (c)
              the pair of (a) again from a copy of jepsen_tpu_torch/
              with an empty _build/ (PYTHONPATH), so the shards' first
              builds race: one closure_square .so left, no temporary
              file, results as phase 4's. Each shard runs the CLI's own
              __main__ under RESUME_CMD, which reports its launches.
 19. test     `run_cli(test_fn, argv=["test", "--dummy", ...])` as a
              suite's main calls it, in this process at concurrency 10:
              the generator, the interpreter's worker threads, the dummy
              remote, the store's save_1 and save_2, and the checker on
              the card. (a) BASELINE config #2: append.test() at its
              defaults under gen.limit(10,000) against a serializable
              in-process list store: valid, closure_square launched at
              T_pad 10,240, and the stored history re-checked by
              `analyze` with the plain squaring gives a byte-identical
              results.json; (b) 2,000 txns against a list store whose
              reads see a stale snapshot: invalid, with the anomaly
              types of the host oracle (`analyze --backend cpu` on the
              same stored history); (c) BASELINE config #1:
              register.test() at its defaults (1,000 ops over 10 keys)
              against CAS registers one a key: valid, knossos_dense_scan
              launched, every key's verdict as the CPU WGL's; (d)
              `test-all` over the three: exit 1, a line each. Each
              test's generator.run and analyze spans (its trace.json)
              are printed beside its launches and device time; no
              interpreter worker thread outlives its test.
 20. suites   the `tidb` and `cockroach` suites, each through its
              `run_cli` with the argv a user gives its main (`test
              --dummy --faults ...`, no --device: the card), against the
              in-process fake SQL servers of tests/fake_sql.py (loaded by
              path; it imports the standard library alone) over the
              port's wire drivers, with the combined fault bundle: (a)
              tidb append (BASELINE config #4's suite) under --faults
              partition,kill,pause,clock for 8 s, a fault a second, at
              concurrency 10: valid, closure_square launched, the
              history's nemesis ops of all four families, the dummy
              remote's iptables commands, its kill -KILL/-STOP/-CONT
              through grepkill, one bump-time (strobe-time) command a
              bumped (strobed) node and the uploads of the port's helper
              sources; (b) cockroach register (config #3's suite) under
              --faults partition,clock: valid, knossos_dense_scan
              launched; (c) cockroach `test-all` over its seven
              workloads, 3 s each: a line each and the worst exit code.
              Every stored run re-checked by `analyze --backend cpu`
              (the host oracles) gives the same verdict (per key for
              register); in (c) each entry as the host's and the plot
              entries (bank's `plot`, sequential's `perf`) by the rule
              of phase 21. Each test's generator.run and analyze spans,
              launches and device time printed; no interpreter worker
              and no server thread outlives the phase; it takes under
              90 s.
 21. baseline the suites of BASELINE.json's configs #1 and #5, each
              through its own `main` with the argv a user gives it (its
              `<db>_test` wrapped for the run), against the fake
              servers of tests/ (fake_etcd, fake_sql, fake_cql,
              fake_dgraph; loaded by path, standard library only): (a)
              etcd at its published shape (10 threads a key, 300 ops a
              key, values 0-4, stagger 1/30 s) at concurrency 30 for
              10 s under --faults partition,kill,pause,clock: one
              knossos_dense_scan launch a dense key, each key's verdict
              the CPU WGL's, every family's ops in the history and its
              commands on the dummy remote, the device time from a
              one-thread re-check; (b) yugabyte YSQL `append` over
              pgwire (closure_square) and YCQL `register` over the CQL
              protocol (knossos_dense_scan), --nemesis partition, 5 s
              each; (c) dgraph `register` (knossos_dense_scan) and
              `bank` (host checkers alone), 5 s each. Each stored run
              re-checked by `analyze --backend cpu`: each entry as the
              host's (its verdicts, per key, where a kernel made it),
              each plot entry valid with its PNGs where matplotlib is
              installed and `unknown` with an error naming it where it
              is not (the phase says which), the exit code the whole
              verdict's. It takes under 75 s.
 22. more     the mongodb family (`mongodb`, `mongodb_rocks`),
              `zookeeper` and `consul` over their own wire drivers
              (OP_MSG and BSON, jute, consul's HTTP KV), and `galera`,
              `percona`, `mysql_cluster` and `postgres_rds` over the SQL
              wire drivers, each through its own `main` with the argv a
              user gives it, 2 s under its own nemesis (the partitioner;
              postgres_rds's is the noop), against the fakes of tests/
              (fake_torch_mongo: fake_mongo.py's server on the port's
              BSON codec; fake_misc, fake_sql): mongodb, mongodb_rocks,
              zookeeper and consul `register` (knossos_dense_scan; one
              launch a dense key for zookeeper and consul, whose device
              time comes from a one-thread re-check), galera and percona
              `dirty-reads` and mysql_cluster `bank` (host checkers, no
              launch), postgres_rds `append` and `wr` (closure_square).
              Each stored run re-checked by `analyze --backend cpu`
              with its test map's checker: each entry as the host's
              (per key for the registers), the plot entries by the
              matplotlib rule, the exit code the whole verdict's. A run
              whose generator.run outlasts its limit by more than 2 s
              prints its slowest client op (f, latency, completion,
              error). It takes under 90 s.
 23. queues   phase 22's shape for the RESP, ReQL and AMQP suites and
              robustirc, against the fakes of tests/fake_misc.py:
              `raftis` register (FakeRedisServer), `rethinkdb` register
              and set (FakeReqlServer), `disque` queue
              (FakeDisqueServer), `rabbitmq` queue (FakeAMQPServer) and
              `robustirc` set over plain HTTP (FakeRobustIRCServer, tls
              off). The registers' model is the plain read/write
              `register`, which Linearizable (as the reference's) gives
              the host WGL engine, so no path launches a kernel: each
              register key valid on that engine as the re-check's, the
              queues lose no acknowledged enqueue and drain after the
              limit, the sets lose no add. Each stored run re-checked as
              in phase 22. It takes under 90 s.
 24. wire     phase 22's shape for the aerospike, ignite, hazelcast and
              faunadb suites over their own wire drivers, against the
              fakes of tests/ on the port's codecs (fake_torch_aerospike,
              fake_torch_ignite, fake_torch_hazelcast: the reference's
              fakes executed on the port's codec; fake_fauna, standard
              library only). The first three clients connect to the
              node's name at their client class's `port`: those runs
              take `--node 127.0.0.1` and the class's port is set to the
              fake's for the run and restored after it (one node: the
              partitioner cuts no link). faunadb reaches its fake through
              `db-hosts`. aerospike, ignite and faunadb `register` (a
              fresh CAS register: knossos_dense_scan, one launch for all
              keys, the device time from a one-thread re-check),
              aerospike `counter`, ignite `bank`, hazelcast `queue` (the
              drain after the limit) and `lock` (the mutex: the host WGL
              engine) and faunadb `set` (host checkers, no launch). Each
              stored run re-checked as in phase 22; the phase says
              whether `hashlib` has RIPEMD-160 (aerospike's record
              digest). It takes under 90 s.
 25. last     phase 22's shape for the last five suites and the store
              browser: `crate` over the pg wire (FakePGServer) with
              `register` (a fresh CAS register: one knossos_dense_scan
              launch for all keys, every key `tpu-dense`), `wr` (the
              rw-register checker: closure_square; crate's menu has no
              `append`), `version-divergence` and `lost-updates` (host
              checkers); `logcabin` register through the TreeOps remote
              of tests/fake_torch_treeops.py (one dense launch for all
              keys); `elasticsearch` set and dirty-read (FakeESServer);
              `chronos` schedule for 50 s (so a job's first target falls
              due before the final read whatever its epsilon and
              duration: target-count >= 1, missed-count 0) and jobs,
              against tests/fake_torch_chronos.py; `charybdefs`
              file-faults on the dummy remote. Each stored run re-checked
              as in phase 22. Then `python -m jepsen_tpu_torch.cli serve
              --web` over a store of the phase's runs: the run table, a
              run's listing, a file and its zip held to the store's
              bytes, `..` refused. It takes under 160 s.
 26. scripts  the port's smoke and gate scripts, its linter and the
              native split: (a)-(d) `python -m jepsen_tpu_torch.obs.smoke`,
              `.serve.smoke`, `.serve.fleet_smoke` and
              `python -m jepsen_tpu_torch.warm_bench` (beside the serve
              smoke), each `--device
              cuda` in a process group of its own, each exiting 0 with
              its contract met; every Python process under each (the
              script, its daemons and fleet members, warm_bench's three
              sweeps) reports its closure_square launches and their
              CUDA-event milliseconds at exit through a
              `sitecustomize` (SCRIPT_SITE) on its PYTHONPATH, and each
              script must have launched the kernel (fleet members the
              nemesis SIGKILLs report nothing); (e) `python -m
              jepsen_tpu_torch.cli lint` exits 0 on this machine's
              Python and `ast`; (f) the native per-key split
              (`independent.subhistories_path`) of every phase-8
              register run equals the Python split key for key, the
              native path taken for each. It takes under 240 s.
 27. devices  several devices. (a) A mesh that repeats the one card,
              `make_mesh([cuda:0]*8)` (4x2): phase 4's store through
              `check_bucketed(mesh=)` (each 5000-txn history padded to
              4 dp rows, each row's closures split into 2 column blocks:
              `closure_square`'s `cols`), phase 5's wr runs through
              `check_edge_batch(devices=[cuda:0]*4)`, config #1's 100
              register histories through the dense tier and the first
              10 of them through the packed frontier with
              `devices=[cuda:0]*3` (ragged; knossos_frontier_scan
              launched once on each dp slice: path `mesh-packed`;
              `mesh-packed-one` the one-device run it is held to), one
              12,000-txn history with
              a G1c pair through `check_long_history(mesh=
              sp_mesh([cuda:0]*4))` against its one-device result, and
              `FoldDispatcher(mesh=)` over 8 of phase 4's and 8 of
              phase 5's runs (phase 16's folds): every verdict equal to
              phases 4, 5 and 8's (results.json) or the one-device
              run's, the launches equal to the bucket logs'. (b) The
              column-range launch held to `closure_square_ref` with the
              same range at B=2, T=5120 with mp=2 and mp=4 (every
              block, active absent/1/0, the blocks stitched into the
              full round), then each block's CUDA-event median beside
              the full launch's and its bound. (c) With more than one
              card visible, (a) over the real cards (`make_mesh()`);
              with one, it says so and does not run. (d) Two processes
              on the card joined through `parallel.init_distributed`
              (gloo, 127.0.0.1; `tools/multihost_dryrun.py`): the
              global-dp check's gathered flags equal the one-process
              flags, and `analyze-store --mesh --device cuda` with no
              shard count gives results byte-identical to a one-process
              sweep of the same store, the coordinator merging the
              fleet; every joined process reports its closure_square
              launches and device ms through phase 26's SCRIPT_SITE,
              and each of the two parts must have launched the kernel
              (paths `mesh-joined-global`, `mesh-joined-sweep`). Each
              part prints its wall and its closure_square and
              knossos_dense_scan launches. It takes under 150 s.
 28. frontier  the bounded frontier's hand kernel, knossos_frontier_scan
              (csrc/knossos_frontier.cu), held to its plain versions run
              on the card (`_scan_history`, `_scan_history_packed`):
              (a) the shape sweep of tools/knossos_frontier_check.py's
              CASES, F from 4 to 4,096 (both tiers), S from 1 to 24
              (two arrays) and 27 (packed), the register walk's layout
              edges (sorts of 256 to 16,384 keys), packed, two arrays
              and two arrays with stats, pad tails, info ops,
              overflowing histories, and blocks striding over histories
              on the global tier: valid, overflow, rounds, peak and
              explored equal; (b) conc-20's frontier histories from
              phase 8 in each variant: every output equal, the kernel's
              median ms (CUDA events) beside the block-sort walk's and
              the plain version's ms (one `_scan_history` run for both
              two-array variants), the rounds, the slowest history's
              rounds and the us a round, the threads and keys a thread,
              ptxas's registers and spills, and the bound (packed: from
              the live configurations of each round, one more untimed
              plain run); then one kernel-only launch of the histories
              repeated to 264 (packed, two arrays), its outputs equal
              to the 13-history launch's repeated. It takes under 30 s.

Every phase prints its wall (phases 1-13 through `phase_wall`), and the
script ends with all of them in one line.

The sweeps run in this process (phases 4-12) ingest through the same
pool. Spawn re-imports this script in each worker, so it imports torch
only in `main()`: at load time it imports the standard library alone.

Since the sweeps' default is the native encoder with the sidecar cache
on, phase 4's and 5's first sweeps are cold and write sidecars, and the
later sweeps of their stores (phase 11's) are warm.

Each path is driven with its kernels' launch counts set to 0 just before
it and read just after; a path that launched one of them no time fails.
Phase 11's stats sweeps count as paths of their own (`stats-<path>`),
and so do phase 12's (`native-<path>-cold`, `native-<path>-warm`) and
phase 27's (`mesh-append`, `mesh-wr`, `mesh-register`, `mesh-packed`,
`mesh-packed-one`, `mesh-long`, `mesh-fold-append`, `mesh-fold-wr`; `real-*` with several
cards),
phase 13's (`pool-append-cold`, `pool-append-warm`, `pool-wr`,
`pool-register`, `pool-kill`), counted in the sweep's own process, and
phase 14's (`analyze-append`, `analyze-wr`, `analyze-register`,
`analyze-fanout`, `analyze-race`), phase 15's (`costdb-append`,
`costdb-wr`, `planner-append-cold`, `planner-append-warm`), phase
16's (`serve-append`, `serve-wr`: the in-process daemon's folds), and
phase 18's (`mesh-shard0`, `mesh-shard1`, `mesh-lost-shard0`,
`mesh-resume-shard1`, `mesh-fresh-shard0`, `mesh-fresh-shard1`: each
counted in its shard's own process), phase 19's (`test-append`,
`test-append-broken`, `test-register`, `test-all`), phase 20's
(`suite-tidb-append`, `suite-cockroach-register`, `suite-test-all`) and
phase 21's (`suite-etcd-register`, `suite-ysql-append`,
`suite-ycql-register`, `suite-dgraph-register`) and phase 22's
(`suite-mongodb-register`, `suite-mongodb_rocks-register`,
`suite-zookeeper-register`, `suite-consul-register`,
`suite-postgres_rds-append`, `suite-postgres_rds-wr`). Phase 23's paths
(`suite-raftis-register`, `suite-rethinkdb-register`,
`suite-rethinkdb-set`, `suite-disque-queue`, `suite-rabbitmq-queue`,
`suite-robustirc-set`) are driven and read the same way, and must
launch neither kernel; so are phase 24's and phase 25's, where only
`suite-crate-register` and `suite-logcabin-register` (knossos_dense_scan)
and `suite-crate-wr` (closure_square) launch one. Phase 26's paths
(`obs-smoke`, `serve-smoke`, `fleet-smoke`, `warm-bench`) are each a
script's whole process tree, counted in each process at its exit.
knossos_frontier_scan's count is set to 0 before phase 4 and read after
phase 27 (its total must be launched); within that, phase 8's `conc20`
and phase 27's `mesh-packed-one` and `mesh-packed` are read as
differences of the running count, and `phases 4-27 other` is the rest
(a frontier key of a sweep, a fan-out or a suite). Phase 28's comparisons come after
and do not count.

The last lines are a `{"kernels": [...]}` record per kernel (with its
launches and summed device milliseconds per path), the nvidia-smi line,
and `{"ok": true, "device": {...}}`. Scratch data goes
to `.chip_smoke/` in the checkout and is removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: torch, imported by main(): spawn re-imports this script in every
#: worker of a sweep's ingest pool, and a worker must not pay for torch
torch = None

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"

#: Published dense peaks: int8 tensor-core operations/s and HBM bytes/s
#: (NVIDIA H100 data sheet; the SXM part unless the name says PCIe).
PEAKS = (("H100 PCIe", 1513e12, 2.0e12), ("H100", 1979e12, 3.35e12))
#: 32-bit operations/s outside the tensor cores: the data sheet's
#: float32 rate (67 TFLOP/s SXM, 51 PCIe). It has no int32 row; the
#: integer pipes are no faster, so a bound from this rate is a floor.
WORD_PEAKS = (("H100 PCIe", 51e12), ("H100", 67e12))

#: The main path's closure shape: 5000-txn histories pad to T=5120, and
#: the 1<<27-cell budget, halved for two buckets in flight, fits 2 of
#: them. The kernel is also timed at B=5, the bucket of earlier slices.
MAIN_B, MAIN_T, WIDE_B = 2, 5120, 5
DEVICE = "cuda"
STORE_RUNS, STORE_T, STORE_K, BAD_EVERY = 64, 5000, 64, 8
#: Phase 5: rw-register runs; the plain re-run takes the first WR_PLAIN.
WR_RUNS, WR_T, WR_K, WR_BAD_EVERY, WR_PLAIN = 32, 5000, 64, 8, 8
#: Phase 7: (slots S, values V, histories B, ops a history) of each
#: kernel-vs-plain case, and the main shape (BASELINE config #1). The
#: tier boundary (dense.plan_scan) lies between S = 11 and 12 at V = 8,
#: and between S = 8 and 9 at V = 64.
KN_CASES = [(1, 8, 256, 40), (1, 64, 1, 200), (4, 8, 37, 80),
            (4, 64, 256, 60), (5, 3, 64, 60), (6, 16, 37, 120),
            (10, 8, 100, 120), (9, 32, 16, 150), (8, 64, 16, 150),
            (11, 8, 16, 120), (12, 8, 16, 100), (9, 64, 16, 150),
            (10, 64, 8, 120), (14, 8, 16, 80), (14, 64, 2, 80)]
KN_B, KN_OPS, KN_CONC = 100, 1000, 10
#: Phase 8: lifted register runs (bench.py's register sweep shape), and
#: each conc-20 population's size and ops.
REG_RUNS, REG_OPS, REG_KEYS, REG_BAD_EVERY = 64, 1000, 50, 8
C20_B, C20_OPS = 20, 400
#: Phase 6: long list-append runs (synth.LONG_RUN_KINDS) and the
#: anomaly types each must come out with. The future run's classes are
#: those the host classifier (graph.classify_cycles) finds in its SCC.
LONG_T, LONG_K, LONG_GAP = 50_000, 64, 16_304
LONG_EXPECT = {"valid": [], "pair": ["G1c"],
               "future": ["G-single", "G1c", "G2-item"]}
#: Phase 9: the mixed store's list-append and register runs, the short
#: list-append history of its fressian run, and where each sweep is
#: cut (the k-th journal line): mid-way through synth's verdicts for
#: append (other/run-00003's dense verdict comes first), mid-way through
#: register's for register (other's four runs come first).
MIX_SYNTH, MIX_REG, MIX_EDN_T = 32, 16, 200
MIX_CUT = {"append": 1 + MIX_SYNTH // 2, "register": 4 + MIX_REG // 2}
#: Phase 10: list-append histories at phase 4's width (every 8th with
#: G1c), the watchdog's timeout (seconds; the bucket it guards, every
#: history at once, takes hundreds of milliseconds on the card) and the
#: self-nemesis spec of the CLI sweep.
SUP_RUNS = 32
WATCHDOG_S = 1e-4
FAULTS = "encode:0.4,oom:first"
#: Phase 11: the peak check's cases (S, V, B, ops) — the warp tier at
#: config #1's grid, the block tier past 512 words — and the runs of
#: each small store swept by the kernels and by the plain versions (the
#: last one of each is an anomalous run), and the long small store's
#: shape and dense limit.
PEAK_CASES = [(10, 8, 8, 200), (12, 8, 8, 100), (14, 64, 2, 80)]
SMALL_RUNS = 8
SMALL_LONG_T, SMALL_LONG_K, SMALL_LONG_GAP, SMALL_LONG_LIMIT = \
    3000, 16, 1003, 1000
#: Phase 13: the pooled sweep's store (BASELINE config #4's 1k-history
#: batch cut to 32, which keeps the whole smoke within its time now that
#: phases 26 and 27 run too; the kill nemesis still selects three runs
#: of them: 12, 20 and 29) at phase 4's width, and the kill nemesis's
#: rate.
POOL_RUNS = 32
POOL_KILL = "kill:0.05"
#: Phase 27: the repeated mesh's size (8 entries: 4x2), the wr and
#: register dp splits, the long history's txns and its sp_mesh width,
#: the packed frontier's cut of config #1, the fold sizes.
MESH_N, WR_DP, REG_DP, SP_MP = 8, 4, 3, 4
LONG_MESH_T, PACKED_CUT, FOLD_RUNS = 12_000, 10, 8
#: Phase 18's two shards, the coordinator's wait in its full fleet, and
#: the runs of phase 4's store its fleet sweeps (the first 32 of 64,
#: 4 of them with G1c: a cut that keeps the smoke within its time).
MESH_SHARDS, MESH_WAIT_S, MESH_RUNS = 2, 300, 32
#: Phase 4's one-process wall, kept for phase 18 to print beside its
#: two-shard wall.
MAIN_WALL: dict = {}
#: The CLI's own __main__ run as a subprocess (phase 9's resumed append
#: sweep, phase 18's shards) with closure_square's count and event pairs
#: reported on stderr at exit.
RESUME_CMD = """\
import atexit, json, runpy, sys, torch
from jepsen_tpu_torch.checker.elle import closure_square as cs
cs.closure_square.events = ev = []
def report():
    torch.cuda.synchronize()
    print("chip_smoke-launches " + json.dumps(
        {"launches": cs.closure_square.launches,
         "device_ms": sum(a.elapsed_time(b) for a, b in ev)}),
        file=sys.stderr)
atexit.register(report)
sys.argv[0] = "jepsen_tpu_torch.cli"
runpy.run_module("jepsen_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


#: Each phase's wall clock (s), by phase number, in the order run.
WALLS: dict = {}


@contextlib.contextmanager
def phase_wall(n: int, say_it: bool = True):
    """Time phase n's block into WALLS; print it unless the phase prints
    its own wall (phases 14-22)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        WALLS[n] = round(time.perf_counter() - t0, 1)
    if say_it:
        say(f"phase {n} in {WALLS[n]:.1f}s")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def child_pids() -> list[int]:
    """The pids of this process's live (or unreaped) children."""
    me, out = os.getpid(), []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            stat = Path(f"/proc/{p}/stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(p))
    return out


def reap(pid: int, grace: float) -> bool:
    """Wait up to `grace` seconds for child `pid` to end, then SIGKILL
    it and wait again; True if it had to be killed."""
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        try:
            if os.waitpid(pid, os.WNOHANG)[0]:
                return False
        except ChildProcessError:
            return False
        time.sleep(0.05)
    with contextlib.suppress(ProcessLookupError):
        os.kill(pid, signal.SIGKILL)
    with contextlib.suppress(ChildProcessError):
        os.waitpid(pid, 0)
    return True


#: Processes started by this script's children, not by it (phase 17's
#: fleet members, spawned by the router): the router reaps them; a
#: failed phase may leave them orphaned, and stop_children kills them.
GRANDCHILDREN: list[int] = []


def alive(pid: int) -> bool:
    """Is `pid` a live process (neither gone nor a zombie)?"""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


def stop_children() -> list[str]:
    """Stop every process the phases started that is still there when
    they end: the in-process sweeps' spawned ingest workers,
    multiprocessing's resource tracker (which the first spawn starts
    and which otherwise ends only after this process has, once it sees
    its pipe close), any other child, and any of GRANDCHILDREN still
    alive. Returns the ones that would not end by themselves and were
    killed."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker

    stuck = []
    for p in mp.active_children():
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
            stuck.append(f"ingest worker {p.pid}")
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        fd, pid = tracker._fd, tracker._pid
        tracker._fd = tracker._pid = None
    if fd is not None:
        os.close(fd)            # the tracker ends when this pipe closes
    if pid is not None and reap(pid, 10.0):
        stuck.append(f"resource tracker {pid}")
    for pid in child_pids():
        if reap(pid, 2.0):
            stuck.append(f"child {pid}")
    for pid in GRANDCHILDREN:
        if alive(pid):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
            stuck.append(f"grandchild {pid}")
    return stuck


def peaks(name: str) -> tuple[float, float]:
    for key, ops, bw in PEAKS:
        if key in name:
            return ops, bw
    say(f"no published peak for {name!r}; bounds use the H100 SXM row")
    return PEAKS[-1][1], PEAKS[-1][2]


def word_peak(name: str) -> float:
    return next((r for key, r in WORD_PEAKS if key in name),
                WORD_PEAKS[-1][1])


def cuda_ms(fn, reps: int, burst: int = 5) -> list[float]:
    """Per-launch milliseconds of `fn`: `reps` samples, each a CUDA event
    pair around `burst` back-to-back calls, so that the host's launch
    overhead overlaps the device's work instead of adding to it."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / burst)
    return out


def random_bool(B: int, T: int, density: float, seed: int,
                reflexive: bool = True) -> torch.Tensor:
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    m = torch.rand((B, T, T), generator=g, device=DEVICE) < density
    if reflexive:
        m |= torch.eye(T, dtype=torch.bool, device=DEVICE)
    return m


def transposed(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(1, 2).contiguous()


def kernel_cases() -> list:
    """(label, m) pairs: random batches at T not a multiple of the
    256-wide column tile, at the long path's shapes and at the main and
    wr paths' bucket shapes (B=1 and B=2 at T=5120; B=5 too), then
    special inputs."""
    cases = []
    seed = 0
    shapes = [(B, T) for B in (1, 3) for T in (128, 384, 640)]
    # condensed SCCs at B=1 (a ragged 128-multiple, and the long run's
    # T_pad=4096)
    shapes += [(1, 3968), (1, 4096)]
    for B, T in shapes + [(1, MAIN_T), (MAIN_B, MAIN_T), (WIDE_B, MAIN_T)]:
        for density in (0.001, 0.01, 0.05):
            seed += 1
            cases.append((f"B={B} T={T} p={density}",
                          random_bool(B, T, density, seed)))
    cases.append(("zeros", torch.zeros((2, 384, 384), dtype=torch.bool,
                                       device=DEVICE)))
    cases.append(("ones", torch.ones((2, 384, 384), dtype=torch.bool,
                                     device=DEVICE)))
    wide = torch.zeros((1, 384, 384), dtype=torch.bool, device=DEVICE)
    wide[0, 5, :] = True      # 384 products per cell: past int8's range
    wide[0, :, 7] = True
    cases.append(("wide row", wide))
    eye = torch.eye(640, dtype=torch.bool, device=DEVICE)
    cases.append(("identity", eye.expand(3, 640, 640).contiguous()))
    cases.append(("non-reflexive", random_bool(3, 640, 0.004, 98,
                                               reflexive=False)))
    # converged (identity) and unconverged histories in one batch
    cases.append(("mixed", torch.cat([eye[:384, :384][None],
                                      random_bool(2, 384, 0.01, 97)])))
    return cases


def phase_kernels(name: str) -> dict:
    """closure_square against closure_square_ref on the card (out, outT
    and changed, exactly; with no device word, and with `active` at 1
    and at 0), then its timing at the main path's shape, a skipped
    round's too."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs

    def word(w: int) -> torch.Tensor:
        return torch.tensor([w, 0], dtype=torch.int32, device=DEVICE)

    cases = kernel_cases()
    max_err = 0.0
    for label, m in cases:
        mt = transposed(m)
        for w in (None, 1, 0):
            a_k = None if w is None else word(w)
            a_r = None if w is None else word(w)
            got = cs.closure_square(m, mt, a_k)
            want = cs.closure_square_ref(m, mt, a_r)
            torch.cuda.synchronize()
            for part, g, x in zip(("out", "outT", "changed"), got, want):
                err = float((g != x).any())
                max_err = max(max_err, err)
                check(err == 0.0, f"closure_square's {part} differs from "
                                  f"its plain version on {label} (active "
                                  f"{w})")
            if w is not None:
                check(torch.equal(a_k, a_r), f"the next round's word "
                      f"differs on {label} (active {w}): {a_k.tolist()} "
                      f"vs {a_r.tolist()}")
            if w == 0:
                check(torch.equal(got[0], m) and torch.equal(got[1], mt)
                      and not bool(got[2].any())
                      and a_k.tolist() == [0, 0],
                      f"a skipped round changed something on {label}")
            if w == 1:
                check(a_k.tolist() == [1, int(bool(want[2].any()))],
                      f"the next round's word on {label}: {a_k.tolist()}")
            if label == "identity" and w is None:
                check(not bool(got[2].any()), "identity squared came out "
                                              "changed")
    say(f"closure_square == closure_square_ref on {len(cases)} cases x "
        "(no word, active 1, active 0) (out, outT, changed and the next "
        "round's word; exact); active 0 returns its input")

    wide = random_bool(WIDE_B, MAIN_T, 0.01, 98)
    wide_t = transposed(wide)
    wide_kernel = lambda: cs.closure_square(wide, wide_t)      # noqa: E731
    cuda_ms(wide_kernel, 3)                                    # warm-up
    ms_wide = statistics.median(cuda_ms(wide_kernel, 10))
    del wide, wide_t

    m = random_bool(MAIN_B, MAIN_T, 0.01, 99)
    mt = transposed(m)
    off = word(0)
    mb = m.to(torch.bfloat16)
    mi = m.view(torch.int8)
    kernel = lambda: cs.closure_square(m, mt)                  # noqa: E731
    plain = lambda: cs.closure_square_ref(m, mt)               # noqa: E731
    library = lambda: torch.bmm(mb, mb) > 0                    # noqa: E731

    def int8_library():
        return torch.stack([torch._int_mm(mi[b], mi[b]) > 0
                            for b in range(MAIN_B)])

    want = library()
    check(torch.equal(kernel()[0], want),
          "closure_square differs from bf16 bmm at the main shape")
    fns = {"kernel": kernel, "plain": plain, "library": library,
           "int8_library": int8_library,
           "skipped": lambda: cs.closure_square(m, mt, off)}
    try:
        got8 = int8_library()
    except RuntimeError as e:          # a yardstick only: never fatal
        say(f"torch._int_mm is not available here ({e}); int8_library_ms "
            "is null")
        del fns["int8_library"]
    else:
        check(torch.equal(got8, want),
              "torch._int_mm > 0 differs from bf16 bmm at the main shape")
    for fn in fns.values():
        cuda_ms(fn, 3)                                         # warm-up
    samples: dict = {k: [] for k in fns}
    order = list(fns) + list(reversed(fns))
    for _ in range(5):                  # in turns, so drift hits them all
        for key in order:
            samples[key] += cuda_ms(fns[key], 1)
    ms = {k: statistics.median(v) for k, v in samples.items()}
    ops_peak, bw_peak = peaks(name)
    ops = 2 * MAIN_B * MAIN_T ** 3           # multiply-adds
    # m and mT read once, out and outT written once, B changed bytes
    nbytes = 4 * MAIN_B * MAIN_T ** 2 + MAIN_B
    t_ops, t_bytes = ops / ops_peak * 1e3, nbytes / bw_peak * 1e3
    # a skipped round moves the four matrices once, no operations
    t_skip = nbytes / bw_peak * 1e3
    say(f"closure_square B={MAIN_B} T={MAIN_T} median ms: kernel "
        f"{ms['kernel']}, plain (fp32 bmm) {ms['plain']}, library (bf16 "
        f"bmm > 0) {ms['library']}, int8 library (torch._int_mm > 0 per "
        f"history) {ms.get('int8_library')}; bound {max(t_ops, t_bytes)} "
        f"(operations {t_ops}, bytes {t_bytes}); a skipped round (active "
        f"0: the copy) {ms['skipped']}, bound {t_skip} (bytes); the "
        f"kernel at B={WIDE_B} {ms_wide}")
    return {"name": "closure_square", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/closure_square.cu",
            "replaces": "jepsen_tpu/checker/elle/pallas_square.py:63",
            "launches": None, "max_abs_err": max_err,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": ms["library"],
            "int8_library_ms": ms.get("int8_library"),
            "skipped_ms": ms["skipped"], "skipped_bound_ms": t_skip,
            f"ms_b{WIDE_B}": ms_wide}


def sweep(store: Path, checker: str = "append",
          **kw) -> tuple[int, list, float, str]:
    """One in-process analyze-store sweep; its stdout summary lines are
    captured, not printed."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.store import Store

    log: list = []
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.analyze_store(Store(store), checker=checker,
                               bucket_log=log, **kw)
    torch.cuda.synchronize()
    return rc, log, time.perf_counter() - t0, buf.getvalue()


def launch_split(log: list, launches: int) -> tuple[int, int]:
    """(active, skipped) closure_square launches of a path from its
    bucket log: every round of every closure is enqueued (the log's
    `launches`, which must equal the count), and the active ones are the
    closures' rounds."""
    enqueued = sum(b["launches"] for b in log)
    active = sum(sum(b["closure_rounds"]) for b in log)
    check(launches == enqueued and 0 < active <= launches,
          f"{launches} kernel launches for {enqueued} enqueued rounds, "
          f"{active} of them active")
    return active, launches - active


def counted(fn, kernel=None):
    """Run fn() with the kernel wrapper's launch count (default
    closure_square's) set to 0 and a CUDA event pair recorded around
    each launch; returns (fn's result, the launches, their summed device
    milliseconds)."""
    if kernel is None:
        from jepsen_tpu_torch.checker.elle import closure_square as cs
        kernel = cs.closure_square
    kernel.launches = 0
    kernel.events = events = []
    try:
        out = fn()
    finally:
        kernel.events = None
    launches = kernel.launches
    check(len(events) == launches, "an event pair per launch")
    return out, launches, sum(a.elapsed_time(b) for a, b in events)


def counted_dense(fn):
    from jepsen_tpu_torch.checker.knossos import dense
    return counted(fn, dense.knossos_dense_scan)


def frontier_kernel():
    from jepsen_tpu_torch.checker.knossos import kernels
    return kernels.knossos_frontier_scan


def frontier_start() -> None:
    """knossos_frontier_scan's count to 0 and an event pair recorded
    around each launch from here on (phases 4-27)."""
    k = frontier_kernel()
    k.launches, k.events = 0, []


def frontier_mark() -> tuple[int, int]:
    """The running (launches, event pairs) of knossos_frontier_scan."""
    k = frontier_kernel()
    return k.launches, len(k.events)


def frontier_since(mark: tuple[int, int]) -> tuple[int, float]:
    """The launches since `mark` and their summed device ms."""
    torch.cuda.synchronize()
    k = frontier_kernel()
    n0, e0 = mark
    return k.launches - n0, sum(a.elapsed_time(b) for a, b in k.events[e0:])


def frontier_stop() -> tuple[int, float]:
    """The launches since frontier_start and their device ms; the event
    pairs stop."""
    out = frontier_since((0, 0))
    frontier_kernel().events = None
    return out


def copy_runs(src: Path, dst: Path, runs: list[str]) -> None:
    for run in runs:
        shutil.copytree(src / run, dst / run)


def same_outputs(a: Path, b: Path, runs: list[str]) -> None:
    """results.json/.edn of `runs` byte-identical under test dirs a and
    b, and so are the stores' verdicts.jsonl lines for those runs."""
    for run in runs:
        for f in ("results.json", "results.edn"):
            check((a / run / f).read_bytes() == (b / run / f).read_bytes(),
                  f"{f} of {run} differs between {a} and {b}")
    dirs = {f"{a.name}/{run}" for run in runs}

    def lines(store: Path) -> list[str]:
        return [ln for ln in (store / "verdicts.jsonl").read_text()
                .splitlines() if json.loads(ln)["dir"] in dirs]

    check(len(lines(a.parent)) == len(runs)
          and lines(a.parent) == lines(b.parent),
          f"verdicts.jsonl differs between {a.parent} and {b.parent}")


def phase_main() -> tuple[int, float]:
    """The main path on the card; returns its closure_square launches
    and their summed device milliseconds."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "store", WORK / "store-plain"
    synth.write_synth_run_store(store, B=STORE_RUNS, T=STORE_T, K=STORE_K,
                                bad_every=BAD_EVERY)
    shutil.copytree(store, plain_store)
    say(f"wrote {STORE_RUNS} runs x {2 * STORE_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")

    (rc, log, wall, out), launches, square_ms = counted(
        lambda: sweep(store, device=DEVICE))
    MAIN_WALL["wall"] = wall
    square_s = square_ms / 1e3
    check(rc == 1, f"analyze-store exited {rc}, expected 1 (invalid runs)")
    check(len(out.splitlines()) == STORE_RUNS,
          "expected one summary line per run")
    runs = sorted(p.name for p in (store / "synth").iterdir())
    for h, run in enumerate(runs):
        res = json.loads((store / "synth" / run / "results.json").read_text())
        if h % BAD_EVERY == BAD_EVERY - 1:
            check(res["valid?"] is False and "G1c" in res["anomaly-types"],
                  f"{run} should be invalid with G1c: {res}")
        else:
            check(res["valid?"] is True and res["anomaly-types"] == [],
                  f"{run} should be valid: {res}")
    rounds = [b["closure_rounds"] for b in log]
    active, skipped = launch_split(log, launches)
    say(f"main path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{STORE_RUNS / wall:.3f} histories/s, "
        f"{sum(b['seconds'] for b in log):.3f}s of it in bucket checks "
        f"(pack, copy, kernels, flags; the rest is load + encode), "
        f"{len(log)} buckets of "
        f"{[b['histories'] for b in log]} at T_pad "
        f"{sorted({b['t_pad'] for b in log})}, closure rounds per bucket "
        f"{rounds}, {launches} closure_square launches ({active} active, "
        f"{skipped} skipped) taking {square_s:.6f}s of device time (CUDA "
        "event pairs)")

    (rc_p, log_p, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == rc, f"plain-squaring sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "synth", plain_store / "synth", runs)
    say(f"plain-squaring sweep: {wall_p:.3f}s wall, "
        f"{sum(b['seconds'] for b in log_p):.3f}s in bucket checks; "
        "results.json, results.edn and verdicts.jsonl byte-identical")
    return launches, square_ms


def phase_cli() -> None:
    """The installed entry point on the card, against a CPU run."""
    from jepsen_tpu_torch.checker.elle import synth

    gpu, cpu = WORK / "small-cuda", WORK / "small-cpu"
    for s in (gpu, cpu):
        synth.write_synth_run_store(s, B=8, T=300, K=16, bad_every=4)
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
         "--store", str(gpu), "--checker", "append", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 1,
          f"cli exited {proc.returncode}: {proc.stderr[-3000:]}")
    rc, _, _, _ = sweep(cpu, device="cpu")
    check(rc == 1, f"cpu sweep exited {rc}")
    same_outputs(gpu / "synth", cpu / "synth",
                 sorted(p.name for p in (gpu / "synth").iterdir()))
    say("python -m jepsen_tpu_torch.cli --device cuda == --device cpu "
        "(byte-identical)")


def phase_wr() -> tuple[int, float]:
    """`analyze-store --checker wr` on the card; returns its
    closure_square launches and their summed device milliseconds."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "wr", WORK / "wr-plain"
    synth.write_wr_run_store(store, B=WR_RUNS, T=WR_T, K=WR_K,
                             bad_every=WR_BAD_EVERY)
    runs = sorted(p.name for p in (store / "wr").iterdir())
    copy_runs(store / "wr", plain_store / "wr", runs[:WR_PLAIN])
    say(f"wrote {WR_RUNS} rw-register runs x {2 * WR_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")

    (rc, log, wall, out), launches, square_ms = counted(
        lambda: sweep(store, checker="wr", device=DEVICE))
    check(rc == 1, f"wr analyze-store exited {rc}, expected 1")
    check(len(out.splitlines()) == WR_RUNS,
          "expected one summary line per run")
    for h, run in enumerate(runs):
        res = json.loads((store / "wr" / run / "results.json").read_text())
        if h % WR_BAD_EVERY == WR_BAD_EVERY - 1:
            check(res["valid?"] is False
                  and res["anomaly-types"] == ["G2-item"],
                  f"{run} should be invalid with G2-item: {res}")
        else:
            check(res["valid?"] is True and res["anomaly-types"] == [],
                  f"{run} should be valid: {res}")
    rounds = [b["closure_rounds"] for b in log]
    active, skipped = launch_split(log, launches)
    say(f"wr path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{WR_RUNS / wall:.3f} histories/s, "
        f"{sum(b['seconds'] for b in log):.3f}s of it in bucket checks "
        f"(pack, copy, scatter, kernels, flags), {len(log)} buckets of "
        f"{[b['histories'] for b in log]} at T_pad "
        f"{[b['t_pad'] for b in log]}, closure rounds per bucket "
        f"{rounds}, {launches} closure_square launches ({active} active, "
        f"{skipped} skipped) taking {square_ms / 1e3:.6f}s of device time "
        "(CUDA event pairs)")

    (rc_p, log_p, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, checker="wr", device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == 1, f"plain-squaring wr sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "wr", plain_store / "wr", runs[:WR_PLAIN])
    say(f"plain-squaring wr sweep of {WR_PLAIN} runs: {wall_p:.3f}s wall, "
        f"{sum(b['seconds'] for b in log_p):.3f}s in bucket checks; "
        "byte-identical")
    return launches, square_ms


def phase_long() -> tuple[int, float]:
    """Long list-append runs on the card through SCC condensation;
    returns the closure_square launches and their summed device
    milliseconds."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import condense, kernels, synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "long", WORK / "long-plain"
    synth.write_long_append_store(store, T=LONG_T, K=LONG_K,
                                  future_gap=LONG_GAP)
    runs = sorted(p.name for p in (store / "long").iterdir())
    kinds = dict(zip(runs, synth.LONG_RUN_KINDS))
    cyclic = [r for r in runs if LONG_EXPECT[kinds[r]]]
    copy_runs(store / "long", plain_store / "long", cyclic)
    say(f"wrote {len(runs)} list-append runs x {2 * LONG_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")
    check(LONG_T > parallel.DENSE_TXN_LIMIT, "long runs must be condensed")

    clog: list = []
    (rc, log, wall, _), launches, square_ms = counted(
        lambda: sweep(store, device=DEVICE, condense_log=clog))
    check(rc == 1, f"long analyze-store exited {rc}, expected 1")
    for run in runs:
        res = json.loads((store / "long" / run / "results.json")
                         .read_text())
        want = LONG_EXPECT[kinds[run]]
        check(res["valid?"] is (not want) and res["anomaly-types"] == want,
              f"{run} ({kinds[run]}) should come out {want}: "
              f"{res['valid?']} {res['anomaly-types']}")
    check(len(clog) == len(runs), f"{len(clog)} condensed histories")
    by_kind = dict(zip(synth.LONG_RUN_KINDS, clog))
    check(by_kind["valid"]["scc_sizes"] == []
          and by_kind["valid"]["closure_rounds"] == 0,
          f"the valid run found an SCC or launched: {by_kind['valid']}")
    check(by_kind["pair"]["scc_sizes"] == [2],
          f"the pair run's SCCs: {by_kind['pair']['scc_sizes']}")
    fut = by_kind["future"]
    check(len(fut["scc_sizes"]) == 1
          and LONG_GAP // 8 < fut["scc_sizes"][0]
          and fut["scc_sizes"][0] <= condense.DEVICE_SCC_LIMIT
          and fut["t_pads"] == [kernels.pad_to(fut["scc_sizes"][0], 128)]
          and fut["closure_rounds"] > 0,
          f"the future run's SCC was not classified on the card: {fut}")
    for kind, rec in by_kind.items():
        if rec["host_scc_sizes"]:
            say(f"long {kind}: SCCs of {rec['host_scc_sizes']} txns went "
                f"to the host classifier (> {condense.DEVICE_SCC_LIMIT})")
    active, skipped = launch_split(log, launches)
    say(f"long path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{len(runs) / wall:.3f} histories/s; condensation (edge build + "
        f"SCCs) {sum(r['condense_seconds'] for r in clog):.6f}s, "
        f"classification {sum(r['classify_seconds'] for r in clog):.6f}s "
        f"of which {sum(b['seconds'] for b in log):.6f}s in device "
        f"buckets and {square_ms / 1e3:.6f}s closure_square device time "
        f"(CUDA event pairs); the rest is load + encode. SCC sizes "
        + ", ".join(f"{k} {r['scc_sizes']} (T_pad {r['t_pads']}, "
                    f"{r['closure_rounds']} rounds)"
                    for k, r in by_kind.items())
        + f"; {launches} closure_square launches ({active} active, "
        f"{skipped} skipped)")

    (rc_p, _, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == 1, f"plain-squaring long sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "long", plain_store / "long", cyclic)
    say(f"plain-squaring long sweep of {cyclic}: {wall_p:.3f}s wall; "
        "byte-identical")
    return launches, square_ms


def dense_batch(S: int, V: int, B: int, n_ops: int, seed: int):
    """B synthetic register histories (every other one corrupted) at
    concurrency S, packed at exactly S slots and V values with 3 pad
    steps past the longest: (regs, comp) on the device."""
    from jepsen_tpu_torch.checker.knossos import synth

    regs, comp = synth.dense_batch(S, V, B, n_ops, seed)
    return torch.from_numpy(regs).to(DEVICE), torch.from_numpy(comp).to(DEVICE)


def event_ms(fn):
    """fn() between a CUDA event pair: (its result, the milliseconds)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_knossos(name: str) -> dict:
    """knossos_dense_scan against scan_dense_ref on the card (valid,
    exactly), then its timing at the main shape."""
    from jepsen_tpu_torch.checker.knossos import dense, synth

    seen, by_tier = set(), {}
    for i, (S, V, B, n_ops) in enumerate(KN_CASES):
        regs, comp = dense_batch(S, V, B, n_ops, seed=i)
        plan = dense.plan_scan(S, V)
        got = dense.knossos_dense_scan(regs, comp, V, S)
        want = dense.scan_dense_ref(regs, comp, V, S)
        torch.cuda.synchronize()
        for part, g, w in zip(("valid", "rounds"), got, want):
            check(torch.equal(g, w),
                  f"knossos_dense_scan's {part} differs from scan_dense_ref "
                  f"at S={S} V={V} B={B} ({plan.tier} tier): {g.tolist()} "
                  f"vs {w.tolist()}")
        seen.update(got[0].tolist())
        by_tier.setdefault(plan.tier, []).append((S, V, B, n_ops))
        say(f"  S={S} V={V} B={B} ops={n_ops}: {plan.tier} tier "
            f"({plan.threads} threads, {plan.smem_bytes} B shared), "
            f"{int(got[1].sum())} rounds, equal")
    check(seen == {True, False}, "the cases hold valid and invalid ones")
    check(set(by_tier) == {"warp", "block"}
          and all(len(c) >= 2 for c in by_tier.values()),
          f"each tier needs two cases or more: {by_tier}")
    say(f"knossos_dense_scan == scan_dense_ref on {len(KN_CASES)} cases "
        f"(valid [B] and rounds [B], exact); by tier (S, V, B, ops) "
        f"{by_tier}")

    hs = synth.synth_register_batch(B=KN_B, n_ops=KN_OPS, n_procs=KN_CONC,
                                    info_prob=0.0, seed=1)
    b = dense.pack_dense_batch([dense.encode_dense_history(h) for h in hs])
    sh = b["shape"]
    regs = torch.from_numpy(b["regs"]).to(DEVICE)
    comp = torch.from_numpy(b["comp"]).to(DEVICE)
    S, V = sh.n_slots, sh.n_values
    kernel = lambda: dense.knossos_dense_scan(regs, comp, V, S)  # noqa: E731
    (valid, rounds), _ = event_ms(kernel)
    (pvalid, prounds), plain_ms = event_ms(
        lambda: dense.scan_dense_ref(regs, comp, V, S))
    check(torch.equal(valid, pvalid) and bool(valid.all())
          and torch.equal(rounds, prounds),
          "config #1's histories: kernel and plain disagree (valid or "
          "rounds), or one is not valid")
    cuda_ms(kernel, 2)                                          # warm-up
    ms = statistics.median(cuda_ms(kernel, 5, burst=3))
    # the bound: regs and comp read once, valid and rounds written once;
    # per round actually run (the kernel's own count), 2 word operations
    # (lift, or) for each slot on each word of the grid and 1 for the
    # rows' OR, and per completion step 2 for the retire
    W = max(1, (1 << S) // 32)
    steps = int((comp >= 0).sum())
    nbytes = 4 * (regs.numel() + comp.numel()) + 5 * KN_B
    ops = int(rounds.sum()) * V * W * (2 * S + 1) + steps * V * W * 2
    t_ops = ops / word_peak(name) * 1e3
    t_bytes = nbytes / peaks(name)[1] * 1e3
    plan = dense.plan_scan(S, V)
    say(f"knossos_dense_scan at the main shape B={KN_B} C_pad={sh.n_steps} "
        f"S={S} V={V}, {plan.tier} tier ({plan.histories_per_block} "
        f"histories a block) ({steps} completion steps, rounds "
        f"{int(rounds.sum())}, equal to the plain version's): kernel "
        f"median {ms} ms, plain (scan_dense_ref) {plain_ms} ms; "
        f"bound {max(t_ops, t_bytes)} ms (operations {t_ops}: {ops} word "
        f"ops; bytes {t_bytes}: {nbytes} B); no single PyTorch call "
        "computes it")
    return {"name": "knossos_dense_scan", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/knossos_dense.cu",
            "replaces": "jepsen_tpu/checker/knossos/dense.py:211",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "shape": {"B": KN_B, "C_pad": sh.n_steps, "S": S, "V": V},
            "tier": plan.tier, "rounds": int(rounds.sum())}


def oracle(hs: list) -> list:
    """Every history's valid? from the port's native WGL search."""
    from jepsen_tpu_torch.checker import knossos, models
    return [knossos.wgl(models.cas_register(), h)["valid?"] for h in hs]


def tiers(log: list) -> str:
    return ", ".join(f"{t['tier']} {t['histories']} in {t['seconds']:.6f}s"
                     for t in log)


def phase_register() -> dict:
    """The register checker on the card; returns per path (launches,
    device milliseconds) of knossos_dense_scan ("dense") and of
    knossos_frontier_scan ("frontier"), and conc-20's frontier
    histories ("frontier_encs", for phase 28)."""
    from jepsen_tpu_torch.checker import Linearizable, models
    from jepsen_tpu_torch.checker.knossos import dense, synth
    from jepsen_tpu_torch.checker.knossos import encode as kenc

    paths = {}
    t0 = time.perf_counter()
    store, plain_store = WORK / "reg", WORK / "reg-plain"
    synth.write_register_run_store(store, runs=REG_RUNS, ops=REG_OPS,
                                   keys=REG_KEYS, bad_every=REG_BAD_EVERY)
    shutil.copytree(store, plain_store)
    say(f"wrote {REG_RUNS} register runs x {REG_OPS} ops over {REG_KEYS} "
        f"keys in {time.perf_counter() - t0:.1f}s")
    rlog: dict = {}
    (rc, _, wall, out), launches, dense_ms = counted_dense(
        lambda: sweep(store, checker="register", device=DEVICE,
                      register_log=rlog))
    check(rc == 1, f"register analyze-store exited {rc}, expected 1")
    check(len(out.splitlines()) == REG_RUNS,
          "expected one summary line per run")
    runs = sorted(p.name for p in (store / "register").iterdir())
    for r, run in enumerate(runs):
        res = json.loads((store / "register" / run / "results.json")
                         .read_text())
        bad = r % REG_BAD_EVERY == REG_BAD_EVERY - 1
        check(res["valid?"] is (not bad)
              and res["failures"] == (["0"] if bad else [])
              and res["key-count"] == REG_KEYS,
              f"{run} should be {'invalid on key 0' if bad else 'valid'}: "
              f"{res['valid?']} {res['failures']}")
    check(launches > 0, "the register sweep never launched the kernel")
    say(f"register path ({DEVICE}): {wall:.3f}s wall, load "
        f"{rlog['load_s']:.3f}s, split {rlog['split_s']:.3f}s, check "
        f"{rlog['check_s']:.3f}s for {rlog['keys']} keys ({tiers(rlog['tiers'])}); "
        f"{launches} knossos_dense_scan launches taking {dense_ms} ms of "
        "device time (CUDA event pairs)")
    paths["register"] = (launches, dense_ms)
    (rc_p, _, wall_p, _), relaunched, _ = counted_dense(
        lambda: sweep(plain_store, checker="register", device=DEVICE,
                      dense_scan=dense.scan_dense_ref))
    check(rc_p == rc, f"plain-scan register sweep exited {rc_p}")
    check(relaunched == 0, "the plain-scan sweep launched the kernel")
    same_outputs(store / "register", plain_store / "register", runs)
    say(f"plain-scan register sweep: {wall_p:.3f}s wall; results.json, "
        "results.edn and verdicts.jsonl byte-identical")

    hs = synth.synth_register_batch(B=KN_B, n_ops=KN_OPS, n_procs=KN_CONC,
                                    info_prob=0.0, seed=1)
    hs += [synth.corrupt(h, seed=i) for i, h in enumerate(hs)]
    c = Linearizable(models.cas_register(), device=DEVICE)
    tl: list = []
    t0 = time.perf_counter()
    got, launches, dense_ms = counted_dense(
        lambda: c.check_batch({}, hs, {}, tier_log=tl))
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = oracle(hs)
    t_oracle = time.perf_counter() - t0
    check([r["valid?"] for r in got] == want,
          "config #1: a device verdict differs from the native WGL's")
    check(want[:KN_B] == [True] * KN_B, "config #1's clean histories must "
                                         "be valid")
    check(launches > 0, "config #1 never launched the kernel")
    say(f"config #1 ({KN_B} histories of {KN_OPS} ops at concurrency "
        f"{KN_CONC}, and their corrupt copies, {want.count(False)} "
        f"invalid): check_batch {wall:.3f}s wall ({tiers(tl)}), "
        f"{launches} knossos_dense_scan launches taking {dense_ms} ms of "
        f"device time; native WGL on the same {len(hs)}: {t_oracle:.3f}s; "
        "every valid? equal")
    paths["config1"] = (launches, dense_ms)

    hs = synth.synth_register_batch(B=C20_B, n_ops=C20_OPS, n_procs=20,
                                    info_prob=0.005, seed=7, max_pending=16)
    hs += synth.synth_register_batch(B=C20_B, n_ops=max(C20_OPS, 256),
                                     n_procs=20, n_values=10_000,
                                     info_prob=0.005, seed=11,
                                     max_pending=8)
    c = Linearizable(models.cas_register(), device=DEVICE)
    tl = []
    t0 = time.perf_counter()
    mark = frontier_mark()
    got, launches, dense_ms = counted_dense(
        lambda: c.check_batch({}, hs, {}, tier_log=tl))
    wall = time.perf_counter() - t0
    n_front, front_ms = frontier_since(mark)
    want = oracle(hs)
    tally: dict = {}
    for r in got:
        tally[r["analyzer"]] = tally.get(r["analyzer"], 0) + 1
    check([r["valid?"] for r in got] == want,
          "conc-20: a device verdict differs from the native WGL's")
    check(set(tally) == {"tpu-dense", "tpu-jit", "wgl"},
          f"conc-20 should take all three tiers: {tally}")
    check(launches > 0, "conc-20 never launched the kernel")
    check(n_front > 0, "conc-20's frontier tier never launched "
          "knossos_frontier_scan")
    paths["conc20"] = (launches, dense_ms)
    # the frontier tier's histories, timed alone in phase 28
    front = [r["analyzer"] == "tpu-jit" for r in got]
    encs = [kenc.encode_register_history(h)
            for h, f in zip(hs, front) if f]
    say(f"conc-20 ({2 * C20_B} histories): check_batch {wall:.3f}s wall, "
        f"tiers {tally} ({tiers(tl)}), {launches} knossos_dense_scan "
        f"launches taking {dense_ms} ms of device time, {n_front} "
        f"knossos_frontier_scan launches taking {front_ms} ms; every "
        f"valid? equal to the native WGL's; {len(encs)} histories answered "
        "by the frontier tier")
    return {"dense": paths, "frontier": {"conc20": (n_front, front_ms)},
            "frontier_encs": encs}


def write_mixed_store(base: Path) -> None:
    """Phase 9's store: synth (list-append), register (lifted CAS
    register) and other (the stored checker's runs)."""
    from jepsen_tpu_torch import fressian, history
    from jepsen_tpu_torch.checker.elle import synth
    from jepsen_tpu_torch.checker.knossos import synth as ksynth
    from jepsen_tpu_torch.edn import Keyword as K

    synth.write_synth_run_store(base, B=MIX_SYNTH, T=STORE_T, K=STORE_K,
                                bad_every=BAD_EVERY)
    ksynth.write_register_run_store(base, runs=MIX_REG, ops=REG_OPS,
                                    keys=REG_KEYS, bad_every=REG_BAD_EVERY)
    other = base / "other"
    for i in range(4):
        (other / f"run-{i:05d}").mkdir(parents=True)
    (other / "run-00000" / "history.jsonl").write_text("".join(
        json.dumps({"type": t, "process": 0, "f": "enqueue", "value": 1,
                    "index": i}) + "\n"
        for i, t in enumerate(("invoke", "ok"))))
    (other / "run-00001" / "history.jsonl").write_text(
        '{"type": "invoke", "process": 0, "f": "rea')
    # run-00002 stays empty: no history at all
    d = other / "run-00003"
    (d / "test.fressian").write_bytes(fressian.dumps(
        {K("name"): "other", K("concurrency"): 5, K("nodes"): ["n1", "n2"],
         K("nemesis-tags"): {K("partition"), K("kill")}}))
    (d / "history.edn").write_text(history.history_to_edn(
        synth.synth_append_history(T=MIX_EDN_T, K=8, seed=3)))


def store_outputs(store: Path) -> dict:
    """Every run's results, markers and test.json (bytes), the links
    (their targets) and the journal's lines."""
    out = {}
    for p in sorted(store.rglob("*")):
        rel = str(p.relative_to(store))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file() and (p.name in ("results.json", "results.edn",
                                         "test.json")
                              or p.name.startswith(".sweep-")):
            out[rel] = p.read_bytes()
    out["verdicts.jsonl"] = (store / "verdicts.jsonl").read_text() \
        .splitlines()
    return out


def in_turn(pristine: Path, work: Path, fn):
    """fn(work) on a fresh copy of `pristine` at `work`; the store is
    then removed, so the next sweep runs on the same path. Returns
    (fn's result, the store's outputs)."""
    shutil.copytree(pristine, work, symlinks=True)
    out = fn(work)
    outputs = store_outputs(work)
    shutil.rmtree(work)
    return out, outputs


def cut_sweep(store: Path, checker: str, k: int, **kw) -> float:
    """A sweep whose k-th journal line raises KeyboardInterrupt, as a
    killed sweep stops; returns its wall seconds."""
    from jepsen_tpu_torch.store import VerdictJournal

    orig, calls = VerdictJournal.record, []

    def record(self, *a, **kws):
        calls.append(1)
        if len(calls) == k:
            raise KeyboardInterrupt(f"sweep cut at verdict {k}")
        return orig(self, *a, **kws)

    VerdictJournal.record = record
    t0 = time.perf_counter()
    try:
        sweep(store, checker, **kw)
    except KeyboardInterrupt:
        return time.perf_counter() - t0
    finally:
        VerdictJournal.record = orig
    raise SmokeFailure(f"the {checker} sweep was not cut at verdict {k}")


def same_but_cut_line(full: dict, resumed: dict, k: int, what: str) -> None:
    """Per-run outputs byte-identical; the resumed journal is the full
    one less its k-th line (the cut run: marked, never journaled)."""
    full, resumed = dict(full), dict(resumed)
    jf, jr = full.pop("verdicts.jsonl"), resumed.pop("verdicts.jsonl")
    check(sorted(full) == sorted(resumed),
          f"{what}: the cut and resumed sweep left other files: "
          f"{sorted(set(full) ^ set(resumed))[:5]}")
    for key in full:
        check(full[key] == resumed[key],
              f"{what}: {key} differs between the full and the resumed "
              "sweep")
    check(jr == jf[:k - 1] + jf[k:],
          f"{what}: the journal is not the full one less line {k}")


def phase_store() -> dict:
    """Phase 9 on the card; returns per path (launches, device
    milliseconds) of closure_square and of knossos_dense_scan, and the
    outputs of the uninterrupted append sweep (phase 10 compares with
    them)."""
    from jepsen_tpu_torch.checker.knossos import dense

    t0 = time.perf_counter()
    pristine, work = WORK / "mixed-pristine", WORK / "mixed"
    write_mixed_store(pristine)
    n_runs = MIX_SYNTH + MIX_REG + 4
    say(f"wrote the mixed store ({MIX_SYNTH} list-append runs x "
        f"{2 * STORE_T} ops, {MIX_REG} register runs x {REG_OPS} ops, 4 "
        f"other runs) in {time.perf_counter() - t0:.1f}s")
    square, scan = {}, {}

    # append: full, then cut + resumed (the CLI in a subprocess)
    ((rc, _, wall, _), n, ms), full = in_turn(
        pristine, work,
        lambda w: counted(lambda: sweep(w, "append", device=DEVICE)))
    check(rc == 2, f"the full append sweep exited {rc}, expected 2")
    check(len(full["verdicts.jsonl"]) == n_runs,
          f"{len(full['verdicts.jsonl'])} journal lines for {n_runs} runs")
    for h in range(MIX_SYNTH):
        res = json.loads(full[f"synth/run-{h:05d}/results.json"])
        bad = h % BAD_EVERY == BAD_EVERY - 1
        check(res["valid?"] is (not bad)
              and res["anomaly-types"] == (["G1c"] if bad else []),
              f"synth/run-{h:05d}: {res['valid?']} {res['anomaly-types']}")
    check(json.loads(full["other/run-00003/results.json"])["valid?"]
          is True, "the fressian run's history should be valid")
    for run in ("run-00001", "run-00002"):
        res = json.loads(full[f"other/{run}/results.json"])
        check(res["quarantined"] == "stored",
              f"other/{run} should be quarantined: {res}")
    check(json.loads(full["register/run-00000/test.json"])["name"]
          == "register", "the stored checker wrote no test.json")
    square["store-append-full"] = (n, ms)
    append_full = full
    say(f"append, full: {wall:.3f}s wall, {n} closure_square launches "
        f"({ms} ms device), rc {rc}")

    k = MIX_CUT["append"]

    def cut_then_resume(w: Path):
        (wall_cut, n_cut, ms_cut) = counted(
            lambda: cut_sweep(w, "append", k, device=DEVICE))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", RESUME_CMD, "analyze-store", "--store",
             str(w), "--checker", "append", "--device", DEVICE,
             "--resume"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        wall_res = time.perf_counter() - t
        rep = [ln for ln in proc.stderr.splitlines()
               if ln.startswith("chip_smoke-launches ")]
        check(len(rep) == 1, f"the resumed sweep reported no launches: "
                             f"{proc.stderr[-3000:]}")
        counts = json.loads(rep[0].split(" ", 1)[1])
        # the CLI's own timer around analyze_store, without the
        # subprocess's start
        swept = [float(ln.split()[1].rstrip("s"))
                 for ln in proc.stderr.splitlines()
                 if ln.startswith("analyze-store: ")]
        return (wall_cut, n_cut, ms_cut, proc.returncode, wall_res,
                swept[-1] if swept else None, counts["launches"],
                counts["device_ms"])

    (wall_cut, n_cut, ms_cut, rc_res, wall_res, cli_res, n_res, ms_res), \
        resumed = in_turn(pristine, work, cut_then_resume)
    check(rc_res == rc, f"the resumed append sweep exited {rc_res}, the "
                        f"full one {rc}")
    same_but_cut_line(full, resumed, k, "append")
    check(0 < n_res < n, f"the resumed append sweep launched closure_square "
                         f"{n_res} times, the full one {n}")
    check(n_cut > 0, "the cut append sweep never launched closure_square")
    square["store-append-cut"] = (n_cut, ms_cut)
    square["store-append-resumed"] = (n_res, ms_res)
    say(f"append, cut at verdict {k}: {wall_cut:.3f}s wall, {n_cut} "
        f"launches ({ms_cut} ms); resumed (python -m jepsen_tpu_torch.cli "
        f"... --resume): {wall_res:.3f}s wall including the subprocess's "
        f"start ({cli_res}s in analyze_store by the CLI's own timer), "
        f"{n_res} launches ({ms_res} ms), rc {rc_res}; per-run "
        "files and links byte-identical to the full sweep, the journal "
        "the full one less the cut line")

    # register: full, then cut + resumed in process
    def register(w: Path, cut: int | None = None):
        rlog: dict = {}
        if cut is None:
            (rc, _, wall, _), n, ms = counted_dense(
                lambda: sweep(w, "register", device=DEVICE,
                              register_log=rlog))
            return rc, wall, n, ms, rlog
        wall, n, ms = counted_dense(
            lambda: cut_sweep(w, "register", cut, device=DEVICE))
        (rc, _, wall_r, _), n_r, ms_r = counted_dense(
            lambda: sweep(w, "register", device=DEVICE, resume=True,
                          register_log=rlog))
        return (wall, n, ms), (rc, wall_r, n_r, ms_r, rlog)

    (rc_r, wall, n, ms, rlog), full = in_turn(pristine, work, register)
    check(rc_r == 2, f"the full register sweep exited {rc_r}, expected 2")
    for r in range(MIX_REG):
        res = json.loads(full[f"register/run-{r:05d}/results.json"])
        bad = r % REG_BAD_EVERY == REG_BAD_EVERY - 1
        check(res["valid?"] is (not bad)
              and res["failures"] == (["0"] if bad else []),
              f"register/run-{r:05d}: {res['valid?']} {res['failures']}")
    check(json.loads(full["synth/run-00000/.sweep-register"])
          == {"valid?": True}, "synth's runs should take the stored "
                               "checker under register")
    check(n > 0 and rlog["keys"] == MIX_REG * REG_KEYS,
          f"the full register sweep: {n} launches, {rlog['keys']} keys")
    scan["store-register-full"] = (n, ms)
    k = MIX_CUT["register"]
    ((wall_cut, n_cut, ms_cut), (rc_res, wall_res, n_res, ms_res, rlog_r)), \
        resumed = in_turn(pristine, work, lambda w: register(w, k))
    check(rc_res == rc_r, f"the resumed register sweep exited {rc_res}")
    same_but_cut_line(full, resumed, k, "register")
    check(n_cut > 0 and n_res > 0,
          f"knossos_dense_scan launches: cut {n_cut}, resumed {n_res}")
    check(rlog_r["keys"] < rlog["keys"],
          f"the resumed register sweep checked {rlog_r['keys']} keys, the "
          f"full one {rlog['keys']}")
    scan["store-register-cut"] = (n_cut, ms_cut)
    scan["store-register-resumed"] = (n_res, ms_res)
    say(f"register, full: {wall:.3f}s wall, {rlog['keys']} keys, {n} "
        f"knossos_dense_scan launches ({ms} ms); cut at verdict {k}: "
        f"{wall_cut:.3f}s wall, {n_cut} launches ({ms_cut} ms); resumed: "
        f"{wall_res:.3f}s wall, {rlog_r['keys']} keys, {n_res} launches "
        f"({ms_res} ms), rc {rc_res}; byte-identical, the journal the full "
        "one less the cut line")

    # --checker stored --name other: other's runs only
    def outside_other(w: Path) -> dict:
        """mtimes of what lies in the run dirs of synth and register."""
        return {p: p.stat().st_mtime_ns for p in w.glob("*/*/*")
                if p.relative_to(w).parts[0] != "other"}

    def stored_other(w: Path):
        before = outside_other(w)
        rc, _, wall, _ = sweep(w, "stored", device=DEVICE, name="other")
        return rc, wall, before, outside_other(w)

    (rc_s, wall_s, before, after), outs = in_turn(pristine, work,
                                                  stored_other)
    dirs = [json.loads(ln)["dir"] for ln in outs["verdicts.jsonl"]]
    check(rc_s == 2 and dirs == [f"other/run-{i:05d}" for i in range(4)],
          f"--checker stored --name other: rc {rc_s}, verdicts for {dirs}")
    check(before == after,
          "--checker stored --name other touched a run outside other")
    check(json.loads(outs["other/run-00003/test.json"])["nemesis-tags"]
          == ["kill", "partition"], "the fressian run's test.json")
    say(f"stored --name other: {wall_s:.3f}s wall, rc {rc_s}, verdicts "
        f"for {len(dirs)} runs, no run outside other touched")
    return {"closure_square": square, "knossos_dense_scan": scan,
            "append_full": append_full}


@contextlib.contextmanager
def gate_env(**env):
    """The named JEPSEN_TPU_* gates set in this process's environment for
    the block (the port reads its gates at call time)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_run(store: Path, **env) -> subprocess.CompletedProcess:
    """`python -m jepsen_tpu_torch.cli analyze-store --checker append` on
    the card over `store`, with the named gates in its environment."""
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
         "--store", str(store), "--checker", "append", "--device", DEVICE],
        cwd=ROOT, env={**os.environ, **{k: str(v) for k, v in env.items()}},
        capture_output=True, text=True, timeout=600)


def phase_supervisor(pristine: Path, clean: dict) -> dict:
    """Phase 10 on the card (`pristine` and `clean`: phase 9's store and
    its uninterrupted append sweep's outputs); returns per path
    (launches, device milliseconds) of closure_square."""
    from jepsen_tpu_torch import parallel, supervisor
    from jepsen_tpu_torch.checker.elle import synth
    from jepsen_tpu_torch.checker.elle.encode import encode_history

    dev = torch.device(DEVICE)
    paths = {}
    t0 = time.perf_counter()
    bad = [h % BAD_EVERY == BAD_EVERY - 1 for h in range(SUP_RUNS)]
    encs = [encode_history(synth.synth_append_history(
        T=STORE_T, K=STORE_K, seed=h, g1c=b)) for h, b in enumerate(bad)]
    say(f"encoded {SUP_RUNS} list-append histories x {2 * STORE_T} ops "
        f"in {time.perf_counter() - t0:.1f}s")

    def expected(res: list, which: list) -> None:
        for h, r in zip(which, res):
            check(("G1c" in r) if bad[h] else r == {},
                  f"history {h} ({'G1c' if bad[h] else 'valid'}): {r}")

    # (a) the pipeline against the synchronous path, in turns
    def sweep_async(pipelined: bool):
        log: list = []
        with gate_env(JEPSEN_TPU_PACK_THREAD=int(pipelined)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pv = parallel.check_bucketed_async(
                encs, dev, max_inflight=2 if pipelined else 1,
                bucket_log=log)
            enqueued = time.perf_counter() - t
            ready = pv.is_ready()
            res = pv.result()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t, enqueued, ready, log

    runs = []
    for pipelined in (True, False, False, True):
        (res, wall, enq, ready, log), n, ms = counted(
            lambda: sweep_async(pipelined))
        expected(res, range(SUP_RUNS))
        active, skipped = launch_split(log, n)
        runs.append((pipelined, res, wall, enq, ready, n, ms, log))
        key = "supervisor-" + ("pipelined" if pipelined else "sync")
        paths.setdefault(key, (n, ms))
        say(f"(a) {'pipelined (2 in flight, pack-h2d thread)' if pipelined else 'synchronous (1 in flight, JEPSEN_TPU_PACK_THREAD=0)'}: "
            f"{wall:.6f}s wall, dispatch returned after {enq:.6f}s with "
            f"is_ready() {ready}; {len(log)} buckets of "
            f"{[b['histories'] for b in log]}; {n} closure_square "
            f"launches ({active} active, {skipped} skipped) taking "
            f"{ms:.3f} ms of device time; idle share "
            f"{1 - ms / 1e3 / wall:.4f} (1 - event-pair time / wall)")
    clean_res = runs[0][1]
    check(all(r[1] == clean_res for r in runs),
          "the pipelined and synchronous sweeps disagree")
    # The proof that a dispatch does not wait for the device: every
    # history in one T=5120 bucket (its device time, hundreds of
    # milliseconds, far above its enqueue's host time; in the sweeps
    # above the card keeps up with the host, so their last bucket may be
    # done by the time they return). The budget is split over the two
    # buckets in flight.
    one_bucket = 2 * SUP_RUNS * MAIN_T ** 2

    def sweep_one_bucket():
        torch.cuda.synchronize()
        t = time.perf_counter()
        pv = parallel.check_bucketed_async(encs, dev,
                                           budget_cells=one_bucket)
        enq = time.perf_counter() - t
        ready = pv.is_ready()
        res = pv.result()
        return res, enq, ready, time.perf_counter() - t

    (res, enq, ready, wall), n_one, ms_one = counted(sweep_one_bucket)
    check(not ready, f"is_ready() was true right after "
                     f"check_bucketed_async returned ({enq:.6f}s)")
    check(res == clean_res, "the one-bucket sweep's verdicts differ")
    say(f"(a) one bucket of all {SUP_RUNS} histories at T={MAIN_T}: "
        f"check_bucketed_async returned after {enq:.6f}s with is_ready() "
        f"{ready}; result() after {wall:.6f}s; {n_one} closure_square "
        f"launches taking {ms_one:.3f} ms of device time")
    cyc = [e for e, b in zip(encs, bad) if b]

    # (b) a real OOM: a memory cap between one history's footprint and
    # one bucket's

    def footprint(group) -> int:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        parallel.check_bucketed(group, dev)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    one, two = footprint(cyc[:1]), footprint(cyc[:2])
    check(two > one, f"a bucket of two takes {two} B, one history {one} B")
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = reserved + one + 3 * (two - one) // 4
    planned = len(parallel.bucket_by_length(encs,
                                            budget_cells=(1 << 27) // 2))
    log = []
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        res, n, ms = counted(lambda: parallel.check_bucketed(
            encs, dev, bucket_log=log))
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
        torch.cuda.empty_cache()
    splits = len(log) - planned
    check(res == clean_res, "verdicts under the memory cap differ: "
          f"{[r for r in res if isinstance(r, supervisor.Quarantined)]}")
    check(splits >= 1, f"no bucket split under the cap ({len(log)} "
                       f"buckets, {planned} planned)")
    paths["supervisor-oom"] = (n, ms)
    say(f"(b) real OOM: one history {one} B, a bucket of two {two} B "
        f"(peak allocated); cap {cap} B ({reserved} B reserved before); "
        f"{splits} of {planned} buckets split into halves, "
        f"{len(log)} checked, verdicts identical; {n} launches")

    # (c) the CLI under the self-nemesis over phase 9's store
    work = WORK / "mixed"
    proc, outs = in_turn(pristine, work,
                         lambda w: cli_run(w, JEPSEN_TPU_FAULT_INJECT=FAULTS))
    check(proc.returncode == 2, f"the faulted CLI sweep exited "
                                f"{proc.returncode}: {proc.stderr[-3000:]}")
    inj = supervisor._Injector(FAULTS)
    runs_of = sorted({"/".join(k.split("/")[:2]) for k in clean
                      if k.endswith("/.sweep-append")})
    chosen = [r for r in runs_of if inj.selects("encode", r.split("/")[1])]
    check(0 < len(chosen) < len(runs_of), f"the nemesis chose {chosen}")
    for run in runs_of:
        if run in chosen:
            res = json.loads(outs[f"{run}/results.json"])
            check(res.get("quarantined") == "encode"
                  and res["valid?"] == "unknown",
                  f"{run} should be quarantined at encode: {res}")
            continue
        for f in ("results.json", "results.edn", ".sweep-append"):
            key = f"{run}/{f}"
            check(outs.get(key) == clean.get(key),
                  f"{key} differs from the clean sweep's")

    def unchosen(lines):
        return [ln for ln in lines if json.loads(ln)["dir"] not in chosen]

    check(unchosen(outs["verdicts.jsonl"])
          == unchosen(clean["verdicts.jsonl"])
          and len(outs["verdicts.jsonl"]) == len(runs_of),
          "the faulted sweep's journal differs from the clean one's")
    say(f"(c) python -m jepsen_tpu_torch.cli under "
        f"JEPSEN_TPU_FAULT_INJECT={FAULTS}: rc 2, {len(chosen)} of "
        f"{len(runs_of)} runs quarantined at encode, the other "
        f"{len(runs_of) - len(chosen)} byte-identical to the clean sweep "
        "(results, markers, journal lines)")

    # (d) the watchdog far below one bucket's device time: the bucket of
    # every history from (a), whose closure_square launches alone took
    # ms_one milliseconds on the card, so the watchdog cannot lose the
    # race to a host that enqueues slower than the card squares
    with gate_env(JEPSEN_TPU_DISPATCH_TIMEOUT_S=WATCHDOG_S):
        t = time.perf_counter()
        got = parallel.check_bucketed(encs, dev, budget_cells=one_bucket)
        t_wd = time.perf_counter() - t
    check(all(isinstance(g, supervisor.Quarantined)
              and g.stage == "watchdog" for g in got),
          f"the watchdog did not quarantine the bucket: {got}")
    torch.cuda.synchronize()
    again = parallel.check_bucketed(encs, dev, budget_cells=one_bucket)
    check(again == clean_res, f"the sweep after the watchdog fired: {again}")
    say(f"(d) JEPSEN_TPU_DISPATCH_TIMEOUT_S={WATCHDOG_S} against a bucket "
        f"of {SUP_RUNS} whose closure_square launches take {ms_one:.3f} ms: "
        f"all {len(got)} quarantined (stage watchdog) after {t_wd:.6f}s; "
        "the next sweep without the gate gave the clean verdicts")

    # (e) strict mode with an injected OOM
    small = WORK / "strict"
    synth.write_synth_run_store(small, B=4, T=300, K=16, bad_every=4)
    proc = cli_run(small, JEPSEN_TPU_STRICT=1,
                   JEPSEN_TPU_FAULT_INJECT="oom:first")
    check(proc.returncode not in (0, 1, 2)
          and "RESOURCE_EXHAUSTED" in proc.stderr,
          f"strict + oom:first exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(not list(small.rglob("results.json")),
          "the strict sweep wrote verdicts")
    say(f"(e) JEPSEN_TPU_STRICT=1 with oom:first: rc {proc.returncode}, "
        "no verdict written")
    return paths


def run_files(store: Path) -> dict:
    """Every run's results.json/.edn (bytes), by store-relative path."""
    return {str(p.relative_to(store)): p.read_bytes()
            for p in sorted(store.glob("*/*/results.*"))}


def telemetry_files(store: Path) -> dict:
    """The sweep telemetry a stats sweep with --report leaves, parsed
    (fails if one is missing or does not parse)."""
    from jepsen_tpu_torch.obs import events
    from jepsen_tpu_torch.store import load_analytics

    out = {}
    for f in ("trace.json", "metrics.json", "report.json"):
        p = store / f
        check(p.is_file(), f"{p} was not written")
        out[f] = json.loads(p.read_text())
    check(bool(out["trace.json"]["traceEvents"]), f"{store}: empty trace")
    out["events"] = events.load_events(store)
    kinds = [e["event"] for e in out["events"]]
    check("sweep_start" in kinds and "sweep_end" in kinds
          and "analytics_flush" in kinds, f"{store}: events {kinds}")
    out["analytics"] = load_analytics(store)
    check(bool(out["analytics"]), f"{store}: no analytics records")
    return out


def phase_peak() -> dict:
    """Phase 11 (a): knossos_dense_scan's peak against the plain
    version's, then both builds timed at config #1's shape."""
    from jepsen_tpu_torch.checker.knossos import dense, synth

    for i, (S, V, B, n_ops) in enumerate(PEAK_CASES):
        regs, comp = dense_batch(S, V, B, n_ops, seed=100 + i)
        plan = dense.plan_scan(S, V)
        got = dense.knossos_dense_scan(regs, comp, V, S, with_stats=True)
        want = dense.scan_dense_ref(regs, comp, V, S, with_stats=True)
        off = dense.knossos_dense_scan(regs, comp, V, S)
        torch.cuda.synchronize()
        for part, g, w in zip(("valid", "rounds", "peak"), got, want):
            check(torch.equal(g, w),
                  f"knossos_dense_scan's {part} (stats build) differs from "
                  f"scan_dense_ref at S={S} V={V} ({plan.tier} tier): "
                  f"{g.tolist()} vs {w.tolist()}")
        check(all(torch.equal(a, b) for a, b in zip(off, got[:2])),
              f"the stats-off build's outputs differ at S={S} V={V}")
        say(f"  peak S={S} V={V} B={B} ops={n_ops}: {plan.tier} tier, "
            f"peaks {got[2].tolist()}, equal to the plain version's")
    hs = synth.synth_register_batch(B=KN_B, n_ops=KN_OPS, n_procs=KN_CONC,
                                    info_prob=0.0, seed=1)
    b = dense.pack_dense_batch([dense.encode_dense_history(h) for h in hs])
    sh = b["shape"]
    regs = torch.from_numpy(b["regs"]).to(DEVICE)
    comp = torch.from_numpy(b["comp"]).to(DEVICE)
    S, V = sh.n_slots, sh.n_values
    fns = {"off": lambda: dense.knossos_dense_scan(regs, comp, V, S),
           "stats": lambda: dense.knossos_dense_scan(regs, comp, V, S,
                                                     with_stats=True)}
    for fn in fns.values():
        cuda_ms(fn, 2)                                          # warm-up
    samples = {k: [] for k in fns}
    for k in ("off", "stats", "stats", "off") * 3:             # in turns
        samples[k] += cuda_ms(fns[k], 1, burst=3)
    ms = {k: statistics.median(v) for k, v in samples.items()}
    peak = fns["stats"]()[2]
    say(f"knossos_dense_scan at config #1's shape B={KN_B} "
        f"C_pad={sh.n_steps} S={S} V={V}: stats-off build {ms['off']} ms, "
        f"stats build {ms['stats']} ms a launch (medians of 6 samples of "
        f"bursts of 3, in turns); peak occupancy max {int(peak.max())}, "
        f"mean {float(peak.float().mean())}")
    return {"stats_off_ms": ms["off"], "stats_ms": ms["stats"]}


def phase_closure_stats() -> dict:
    """Phase 11 (a): the Elle closure's stats at the append path's bucket
    shape (B=2, T=5120): one closure of all its rounds with and without
    the per-round counters, in turns, and `_graph_stats` on its result
    (plain PyTorch around closure_square; CUDA event pairs)."""
    from jepsen_tpu_torch.checker.elle import kernels as K

    m = random_bool(MAIN_B, MAIN_T, 2.0 / MAIN_T, seed=21)
    steps = K.closure_steps(MAIN_T)
    nI = ~torch.eye(MAIN_T, dtype=torch.bool, device=DEVICE)
    fns = {"off": lambda: K._closure_batched(m, steps),
           "stats": lambda: K._closure_batched(m, steps, stats=[])}
    tel: list = []
    c = K._closure_batched(m, steps, stats=tel)
    check(torch.equal(c, fns["off"]()), "the stats closure's matrix differs")
    zero = torch.zeros(MAIN_B, 3, dtype=torch.int32, device=DEVICE)
    z1 = torch.zeros(MAIN_B, dtype=torch.int32, device=DEVICE)
    fns["graph"] = lambda: K._graph_stats(zero, z1, z1, c, tel[0], tel[1],
                                          nI)
    for fn in fns.values():
        cuda_ms(fn, 1, burst=2)                                 # warm-up
    samples = {k: [] for k in fns}
    for k in ("off", "stats", "graph", "graph", "stats", "off") * 2:
        samples[k] += cuda_ms(fns[k], 1, burst=2)
    ms = {k: statistics.median(v) for k, v in samples.items()}
    # bounds from the shapes: each active round a 2·B·T³ int8 squaring;
    # the counters three word operations a cell a round; the closure
    # reads its [B,T,T] input once and writes its result once, and
    # _graph_stats reads the closure once (its outputs are [B] words)
    # and does ~4 word operations a cell
    name = torch.cuda.get_device_name(0)
    ops, bw = peaks(name)
    wops = word_peak(name)
    active = int(tel[0].max())
    cells = MAIN_B * MAIN_T * MAIN_T
    t_sq = active * 2 * MAIN_B * MAIN_T ** 3 / ops * 1e3
    t_cnt = steps * 3 * cells / wops * 1e3
    t_rw = 2 * cells / bw * 1e3
    bounds = {"off": max(t_sq, t_rw), "stats": max(t_sq + t_cnt, t_rw),
              "graph": max(4 * cells / wops * 1e3, cells / bw * 1e3)}
    bound_by = {"off": "operations" if t_sq >= t_rw else "bytes",
                "stats": "operations" if t_sq + t_cnt >= t_rw else "bytes",
                "graph": "operations" if 4 * cells / wops >= cells / bw
                else "bytes"}
    say(f"(a) Elle closure at B={MAIN_B}, T={MAIN_T} ({steps} rounds "
        f"enqueued, {active} active): {ms['off']} ms without "
        f"the stats, {ms['stats']} ms with the per-round counters; "
        f"_graph_stats on its closure {ms['graph']} ms (medians of 4 "
        "samples of bursts of 2, in turns); bounds "
        + ", ".join(f"{k} {bounds[k]} ms ({bound_by[k]})" for k in bounds))
    return {"closure_ms": ms["off"], "closure_stats_ms": ms["stats"],
            "graph_stats_ms": ms["graph"], "bound_ms": bounds,
            "bound_by": bound_by}


def small_store(kind: str, base: Path) -> Path:
    """A small store of `kind` for the kernel/plain analytics check:
    SMALL_RUNS runs copied from its phase's store, or for `long` a
    fresh small store of long runs."""
    from jepsen_tpu_torch.checker.elle import synth

    if kind == "long":
        synth.write_long_append_store(base, T=SMALL_LONG_T, K=SMALL_LONG_K,
                                      future_gap=SMALL_LONG_GAP)
        return base
    src, name = {"append": (WORK / "store", "synth"),
                 "wr": (WORK / "wr", "wr"),
                 "register": (WORK / "reg", "register")}[kind]
    runs = sorted(p.name for p in (src / name).iterdir())[:SMALL_RUNS]
    for run in runs:
        d = base / name / run
        d.mkdir(parents=True)
        for f in ("history.jsonl", "history.edn", "test.json"):
            if (src / name / run / f).is_file():
                shutil.copy(src / name / run / f, d / f)
    return base


def phase_telemetry(launches: dict, dense_record: dict) -> dict:
    """Phase 11 (b)–(e); `launches` holds each path's stats-off kernel
    launches from phases 4, 5, 6 and 8. Returns the numbers PERF.md
    reads."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.knossos import dense
    from jepsen_tpu_torch.obs import attribution

    out: dict = {}
    checker_of = {"append": "append", "wr": "wr", "long": "append",
                  "register": "register"}
    plain = {"append": {"square": cs.closure_square_ref},
             "wr": {"square": cs.closure_square_ref},
             "long": {"square": cs.closure_square_ref},
             "register": {"dense_scan": dense.scan_dense_ref}}

    # (b) the analytics of small stores, kernels against plain versions
    limit = parallel.DENSE_TXN_LIMIT
    for kind in ("append", "wr", "long", "register"):
        ledgers = []
        for label, kw in (("kernel", {}), ("plain", plain[kind])):
            store = small_store(kind, WORK / f"tele-{kind}-{label}")
            if kind == "long":
                parallel.DENSE_TXN_LIMIT = SMALL_LONG_LIMIT
            try:
                with gate_env(JEPSEN_TPU_KERNEL_STATS=1):
                    rc, _, _, _ = sweep(store, checker_of[kind],
                                        device=DEVICE, **kw)
            finally:
                parallel.DENSE_TXN_LIMIT = limit
            check(rc == 1, f"the small {kind} stats sweep ({label}) exited "
                           f"{rc}, expected 1")
            ledgers.append((store / "analytics.jsonl").read_bytes())
        lines = ledgers[0].decode().splitlines()
        check(ledgers[0] == ledgers[1] and lines,
              f"the small {kind} store's analytics.jsonl differs between "
              "the kernels and the plain versions")
        say(f"(b) {kind}: analytics.jsonl of {len(lines)} records "
            "byte-identical, kernels vs plain versions")

    # (c) the stats sweeps of phases 4, 5, 6 and 8's stores, with --report
    stores = {"append": (WORK / "store", STORE_RUNS),
              "wr": (WORK / "wr", WR_RUNS), "long": (WORK / "long", 3),
              "register": (WORK / "reg", REG_RUNS)}
    for kind, (store, n_runs) in stores.items():
        before = run_files(store)
        counter = counted_dense if kind == "register" else counted
        with gate_env(JEPSEN_TPU_KERNEL_STATS=1):
            (rc, log, wall, _), n, ms = counter(lambda: sweep(
                store, checker_of[kind], device=DEVICE, report=True))
        check(rc == 1, f"the {kind} stats sweep exited {rc}")
        check(run_files(store) == before,
              f"the {kind} stats sweep changed a verdict file")
        check(n == launches[kind], f"the {kind} stats sweep launched its "
              f"kernel {n} times, the stats-off sweep {launches[kind]}")
        tele = telemetry_files(store)
        c = tele["metrics.json"]["counters"]
        check(c.get("runs_verdicted") == n_runs
              and tele["metrics.json"]["gauges"].get("runs_total") == n_runs
              and len(tele["analytics"]) == n_runs
              and c.get("kernel.stats_records") == n_runs,
              f"{kind}: counters {c} for {n_runs} runs")
        if kind == "append":
            check(c["buckets_dispatched"] == c["buckets_resolved"]
                  == len(log) and c["h2d_bytes"] > 0,
                  f"append: buckets {c} against {len(log)} in the log")
            check(sum(r["closure_rounds"] for r in tele["analytics"]) > 0,
                  "append: no closure rounds in the ledger")
        rep = tele["report.json"]
        out[kind] = {"wall": wall, "launches": n, "device_ms": ms,
                     "counters": c, "report": rep}
        if kind != "append":
            say(f"(c) {kind} stats sweep: {wall:.3f}s wall, rc {rc}, "
                f"{n} launches ({ms} ms) as without stats; verdicts "
                f"byte-identical; {len(tele['analytics'])} analytics "
                f"records; counters {c}")
            continue
        st = rep["stalls"]
        idle = st["device_idle_secs"] / rep["wall_secs"]             if rep["wall_secs"] else None
        out["append"]["idle_share"] = idle
        say(f"(c) append stats sweep: {wall:.3f}s wall, rc {rc}, {n} "
            f"launches ({ms} ms) as without stats; verdicts "
            f"byte-identical; counters {c}")
        say(f"(c) append attribution (report.json): "
            f"{attribution.summary_line(rep)}; shares "
            + ", ".join(f"{k} {v}" for k, v in rep["shares"].items())
            + f"; device busy {st['device_busy_secs']}s over "
            f"{st['dispatches']} windows, idle {st['device_idle_secs']}s "
            f"(idle share {idle}); gaps: ingest-starved "
            f"{st['ingest_starved_secs']}s, pack-bound "
            f"{st['pack_bound_secs']}s, other {st['other_secs']}s; phase "
            f"totals {tele['metrics.json']['phase_totals_secs']}")

    # (d) the append sweep's wall three ways, in turns
    walls: dict = {"trace_off": [], "default": [], "stats": []}
    envs = {"trace_off": {"JEPSEN_TPU_TRACE": 0}, "default": {},
            "stats": {"JEPSEN_TPU_KERNEL_STATS": 1}}
    for key in ("trace_off", "default", "stats"):
        with gate_env(**envs[key]):
            rc, _, wall, _ = sweep(WORK / "store", "append", device=DEVICE)
        check(rc == 1, f"the {key} append sweep exited {rc}")
        walls[key].append(wall)
    check(not (WORK / "store" / "torch-profile").exists(),
          "a profile was written with the profiler gate off")
    out["walls"] = walls
    say("(d) append sweep wall (s), in turns: JEPSEN_TPU_TRACE=0 "
        f"{walls['trace_off']}, default tracer {walls['default']}, "
        f"JEPSEN_TPU_KERNEL_STATS=1 {walls['stats']}; card {nvidia_smi()}")

    # (e) one torch.profiler capture over a short append sweep
    prof = small_store("append", WORK / "tele-profile")
    with gate_env(JEPSEN_TPU_JAX_PROFILE=1):
        rc, _, wall, _ = sweep(prof, "append", device=DEVICE)
    ptrace = prof / "torch-profile" / "trace.json"
    check(rc == 1 and ptrace.is_file(),
          f"the profiled sweep exited {rc}, trace {ptrace.is_file()}")
    evs = json.loads(ptrace.read_text())["traceEvents"]
    kernels = [e for e in evs if e.get("cat") == "kernel"]
    squares = [e for e in kernels if "closure_square" in str(e.get("name"))]
    check(bool(squares), f"the profile holds no closure_square kernel "
                         f"event ({len(kernels)} kernel events, "
                         f"categories {sorted({str(e.get('cat')) for e in evs})})")
    out["profile"] = {"kernel_events": len(kernels),
                      "closure_square_events": len(squares),
                      "closure_square_us": sum(e.get("dur", 0)
                                               for e in squares)}
    say(f"(e) torch.profiler over a {SMALL_RUNS}-run append sweep "
        f"({wall:.3f}s): {len(kernels)} CUDA kernel events, "
        f"{len(squares)} of them closure_square "
        f"({out['profile']['closure_square_us']} us)")
    dense_record.update(phase_peak())
    out["closure_stats"] = phase_closure_stats()
    return out


def phase_native(launches: dict, verdicts: dict) -> dict:
    """Phase 12: phase 4's and phase 5's stores swept cold (sidecars
    removed) and then warm. `launches` and `verdicts` hold each path's
    closure_square launches and verdict files from phases 4 and 5.
    Returns the paths' (launches, device ms) and the numbers PERF.md
    reads."""
    paths: dict = {}
    out: dict = {}
    smi = nvidia_smi()
    for kind, store, n_runs, sidecar in (
            ("append", WORK / "store", STORE_RUNS, "encoded.v2.bin"),
            ("wr", WORK / "wr", WR_RUNS, "encoded-wr.v1.bin")):
        for p in store.rglob("encoded*.bin"):
            p.unlink()
        for warmth in ("cold", "warm"):
            (rc, log, wall, _), n, ms = counted(lambda: sweep(
                store, kind, device=DEVICE, report=True))
            check(rc == 1, f"the {warmth} native {kind} sweep exited {rc}")
            check(run_files(store) == verdicts[kind],
                  f"the {warmth} native {kind} sweep's verdict files differ "
                  f"from phase {4 if kind == 'append' else 5}'s")
            check(n == launches[kind], f"the {warmth} native {kind} sweep "
                  f"launched closure_square {n} times, phase "
                  f"{4 if kind == 'append' else 5} {launches[kind]}")
            c = json.loads((store / "metrics.json").read_text())["counters"]
            hits, misses = c.get("cache_hits", 0), c.get("cache_misses", 0)
            check((hits, misses) == ((0, n_runs) if warmth == "cold"
                                     else (n_runs, 0)),
                  f"{warmth} {kind}: {hits} cache hits, {misses} misses "
                  f"of {n_runs} runs")
            check(not c.get("native_fallback"),
                  f"{warmth} {kind}: native fallbacks {c}")
            check(len(list(store.rglob(sidecar))) == n_runs,
                  f"{warmth} {kind}: not every run has its {sidecar}")
            if kind == "append" and warmth == "warm":
                check(not c.get("warm_copy_bytes"), "the warm append "
                      "sweep repacked cached histories on the host")
            rep = json.loads((store / "report.json").read_text())
            st = rep["stalls"]
            idle = st["device_idle_secs"] / rep["wall_secs"] \
                if rep["wall_secs"] else None
            parse = rep["shares"].get("parse")
            key = f"native-{kind}-{warmth}"
            paths[key] = (n, ms)
            out[key] = {"wall": wall, "histories_per_s": n_runs / wall,
                        "parse_share": parse, "idle_share": idle,
                        "report_wall": rep["wall_secs"], "launches": n,
                        "device_ms": ms, "buckets": len(log),
                        "counters": {k: c.get(k) for k in (
                            "cache_hits", "cache_misses", "h2d_bytes",
                            "warm_copy_bytes")}}
            say(f"{key}: {wall:.3f}s wall, {n_runs / wall:.3f} "
                f"histories/s; report.json: parse share {parse}, device "
                f"idle share {idle} (busy {st['device_busy_secs']}s over "
                f"{st['dispatches']} windows of a {rep['wall_secs']}s "
                f"timeline), shares {rep['shares']}; {n} closure_square "
                f"launches ({ms} ms); verdicts byte-identical to phase "
                f"{4 if kind == 'append' else 5}; counters "
                f"{out[key]['counters']}; card {smi}")
    return {"paths": paths, "numbers": out}


def clear_outputs(store: Path) -> None:
    """A store's verdicts and telemetry removed, its histories and
    encoded sidecars kept (the next sweep of it is warm)."""
    for p in list(store.rglob("results.*")) + list(store.rglob(".sweep-*")):
        p.unlink()
    for f in ("verdicts.jsonl", "trace.json", "metrics.json",
              "events.jsonl", "report.json", "report.md",
              "analytics.jsonl", "costdb.jsonl", "health.json"):
        (store / f).unlink(missing_ok=True)
    for p in store.glob("trace-*.jsonl"):
        p.unlink()


@contextlib.contextmanager
def serial_ingest():
    """The sweeps of this process ingest on the serial path, the pool's
    plain version: `ingest._spawn_safe` answers no, as it does where a
    spawned worker could not boot."""
    from jepsen_tpu_torch import ingest
    saved = ingest._spawn_safe
    ingest._spawn_safe = lambda: False
    try:
        yield
    finally:
        ingest._spawn_safe = saved


def pool_cli(store: Path, checker: str, pids: set, processes=None,
             **env) -> dict:
    """`python -m jepsen_tpu_torch.tools.pool_smoke cli analyze-store
    ... --report` on the card in a subprocess (spawn re-imports the main
    module in every worker: this one imports no torch), with the named
    gates in its environment; returns its `pool_smoke` record (exit
    code, wall, launches and device ms of each kernel, the ingest's
    `pooled`, parse spans and measured overlap) and its stderr under
    "stderr". Its pid joins `pids`. `processes` sizes the pool in place
    of the CLI's choice."""
    sized = [] if processes is None else ["--processes", str(processes)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.tools.pool_smoke", "cli",
         *sized, "analyze-store", "--store", str(store), "--checker", checker,
         "--device", DEVICE, "--report"],
        cwd=ROOT, env={**os.environ, **{k: str(v) for k, v in env.items()}},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pids.add(proc.pid)
    try:
        _out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"pooled {checker} sweep of {store} timed out")
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in err.splitlines()
            if ln.startswith("pool_smoke ")]
    check(len(recs) == 1, f"pooled {checker} sweep of {store} (exit "
          f"{proc.returncode}) reported nothing: {err[-3000:]}")
    return {**recs[0], "stderr": err}


def pool_tool(*args, **env) -> dict:
    """`python -m jepsen_tpu_torch.tools.pool_smoke ARGS` (encodings or
    load) in a subprocess; returns its JSON line."""
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.tools.pool_smoke",
         *map(str, args)], cwd=ROOT,
        env={**os.environ, **{k: str(v) for k, v in env.items()}},
        capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"pool_smoke {args} exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def sweep_numbers(store: Path, rec: dict, n_runs: int) -> dict:
    """What PERF.md reads of a pooled sweep: its wall, histories/s, the
    report's parse and device idle shares, the pool's counters, the
    workers' pid tracks and the measured overlap."""
    rep = json.loads((store / "report.json").read_text())
    c = json.loads((store / "metrics.json").read_text())["counters"]
    evs = json.loads((store / "trace.json").read_text())["traceEvents"]
    workers = {e["pid"] for e in evs if e["name"] == "process_name"
               and e["args"]["name"].startswith("ingest-worker")}
    st = rep["stalls"]
    return {"wall": rec["wall"], "histories_per_s": n_runs / rec["wall"],
            "parse_share": rep["shares"].get("parse"),
            "idle_share": st["device_idle_secs"] / rep["wall_secs"]
            if rep["wall_secs"] else None,
            "workers": len(workers), "pooled": rec.get("pooled"),
            "overlap_secs": rec.get("overlap_secs"),
            "parse_secs": rec.get("parse_secs"),
            "counters": {k: c.get(k) for k in (
                "shm_bytes", "worker_spans", "cache_hits", "cache_misses",
                "shm_stale_reclaimed", "quarantined")}}


def pool_ran(store: Path, rec: dict, what: str) -> None:
    """The sweep went through the pool, in full: `pooled`, a worker pid
    track in trace.json, no serial resume, no pool failure."""
    nums = sweep_numbers(store, rec, 1)
    check(rec.get("pooled") is True and nums["workers"] > 0,
          f"{what}: the pool did not run (pooled {rec.get('pooled')}, "
          f"{nums['workers']} worker tracks)")
    check("pool failed" not in rec["stderr"]
          and "falling back" not in rec["stderr"],
          f"{what}: the pool failed and the sweep resumed serially: "
          f"{rec['stderr'][-3000:]}")


def phase_pool(launches: dict, verdicts: dict) -> dict:
    """Phase 13: the pooled ingest on the card. `launches` and `verdicts`
    hold phase 4's, 5's and 8's launches and verdict files. Returns the
    paths' (launches, device ms) per kernel and the numbers PERF.md
    reads."""
    from jepsen_tpu_torch import shm, supervisor
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import synth

    smi = nvidia_smi()
    ncpu = os.cpu_count() or 1
    vfs = os.statvfs("/dev/shm")
    out: dict = {"shm_total": vfs.f_frsize * vfs.f_blocks,
                 "shm_free": vfs.f_frsize * vfs.f_bavail, "cpus": ncpu}
    say(f"/dev/shm: {out['shm_total']} bytes, {out['shm_free']} free; "
        f"{ncpu} CPUs")
    pids = {os.getpid()}
    square: dict = {}
    scan: dict = {}

    t0 = time.perf_counter()
    store = WORK / "pool"
    synth.write_synth_run_store(store, B=POOL_RUNS, T=STORE_T, K=STORE_K,
                                bad_every=BAD_EVERY)
    say(f"wrote {POOL_RUNS} runs x {2 * STORE_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")

    # (a) every pooled encoding equals the serial one, in run order: cold
    # (the cache read but never written, so both passes parse)
    enc = {}
    for kind, s in (("append", store), ("wr", WORK / "wr")):
        r = pool_tool("encodings", s, kind, ncpu,
                      JEPSEN_TPU_ENCODE_CACHE=0)
        check(r["pooled"] and not r["diffs"] and r["errors"] == 0,
              f"(a) {kind}: pooled encodings "
              f"differ from the serial ones: {r}")
        enc[kind] = r
        say(f"(a) {kind}: {r['runs']} runs, {r['processes']} workers: "
            f"every pooled encoding == the serial one, in run order; "
            f"ingest {r['pooled_secs']:.3f}s pooled, "
            f"{r['serial_secs']:.3f}s serial; counters {r['counters']}")
    out["encodings"] = enc

    # (b) the plain sweep (the plain squaring, the serial ingest), then
    # the pooled CLI cold and warm
    with serial_ingest():
        (rc_p, log_p, wall_p, _), n_p, _ = counted(lambda: sweep(
            store, device=DEVICE, square=cs.closure_square_ref))
    check(rc_p == 1 and n_p == 0, f"plain sweep: exit {rc_p}, {n_p} "
          "kernel launches")
    plain = store_outputs(store)
    enqueued = sum(b["launches"] for b in log_p)
    clear_outputs(store)
    for p in store.rglob("encoded*.bin"):
        p.unlink()
    say(f"(b) plain sweep of {POOL_RUNS} runs (plain squaring, serial "
        f"ingest): {wall_p:.3f}s, {enqueued} rounds enqueued")
    sweeps = {}
    for warmth in ("cold", "warm"):
        rec = pool_cli(store, "append", pids)
        check(rec["rc"] == 1, f"(b) pooled {warmth} sweep exited "
              f"{rec['rc']}: {rec['stderr'][-3000:]}")
        check(store_outputs(store) == plain, f"(b) the pooled {warmth} "
              "sweep's results, markers or journal differ from the plain "
              "version's")
        n = rec["closure_square"]["launches"]
        check(n == enqueued, f"(b) {warmth}: {n} closure_square launches, "
              f"the plain sweep enqueued {enqueued} rounds")
        pool_ran(store, rec, f"(b) {warmth}")
        nums = sweep_numbers(store, rec, POOL_RUNS)
        c = nums["counters"]
        check((c["cache_hits"] or 0, c["cache_misses"] or 0)
              == ((0, POOL_RUNS) if warmth == "cold" else (POOL_RUNS, 0)),
              f"(b) {warmth}: counters {c}")
        square[f"pool-append-{warmth}"] = (
            n, rec["closure_square"]["device_ms"])
        sweeps[f"append-{warmth}"] = nums
        say(f"(b) pooled append {warmth}: {nums['wall']:.3f}s wall, "
            f"{nums['histories_per_s']:.3f} histories/s, parse share "
            f"{nums['parse_share']}, device idle share {nums['idle_share']}, "
            f"{nums['workers']} workers, parse {nums['parse_secs']:.3f}s "
            f"over {rec['parse_spans']} spans in {rec['parse_range']}, "
            f"{rec['device_windows']} device windows in "
            f"{rec['device_range']} (s from the sweep's start; the CUDA "
            f"context made before it in {rec['cuda_init_s']}s), overlap "
            f"{nums['overlap_secs']:.6f}s; counters {c}; {n} launches "
            f"({rec['closure_square']['device_ms']:.3f} ms); verdicts == "
            f"the plain version's; card {smi}")
        clean = store_outputs(store)
        clear_outputs(store)

    # the same sweeps through the serial ingest, cold and warm; then cold
    # with one worker fewer than the cores, which leaves the parent a
    # core of its own
    for p in store.rglob("encoded*.bin"):
        p.unlink()
    for warmth in ("cold", "warm"):
        rec = pool_cli(store, "append", pids, processes=0)
        n = rec["closure_square"]["launches"]
        check(rec["rc"] == 1 and store_outputs(store) == plain
              and n == enqueued and rec.get("pooled") is False,
              f"(b) serial {warmth} sweep: exit {rec['rc']}, {n} launches, "
              f"pooled {rec.get('pooled')}: {rec['stderr'][-3000:]}")
        nums = sweep_numbers(store, rec, POOL_RUNS)
        sweeps[f"serial-append-{warmth}"] = nums
        square[f"serial-append-{warmth}"] = (
            n, rec["closure_square"]["device_ms"])
        say(f"(b) serial-ingest append {warmth}: {nums['wall']:.3f}s wall, "
            f"{nums['histories_per_s']:.3f} histories/s, parse share "
            f"{nums['parse_share']}, device idle share "
            f"{nums['idle_share']}; {n} launches "
            f"({rec['closure_square']['device_ms']:.3f} ms)")
        clear_outputs(store)
    for p in store.rglob("encoded*.bin"):
        p.unlink()
    fewer = max(1, ncpu - 1)
    rec = pool_cli(store, "append", pids, processes=fewer)
    check(rec["rc"] == 1 and store_outputs(store) == plain,
          f"(b) pooled cold sweep with {fewer} workers: exit {rec['rc']}")
    pool_ran(store, rec, f"(b) {fewer} workers")
    nums = sweep_numbers(store, rec, POOL_RUNS)
    sweeps[f"append-cold-{fewer}"] = nums
    square[f"pool-append-cold-{fewer}"] = (
        rec["closure_square"]["launches"], rec["closure_square"]["device_ms"])
    say(f"(b) pooled append cold, {fewer} workers: {nums['wall']:.3f}s "
        f"wall, {nums['histories_per_s']:.3f} histories/s, parse share "
        f"{nums['parse_share']}, device idle share {nums['idle_share']}, "
        f"parse spans in {rec['parse_range']}, device windows in "
        f"{rec['device_range']}, overlap {nums['overlap_secs']:.6f}s")

    # phase 5's wr store, cold, and phase 8's register store
    for kind, s in (("wr", WORK / "wr"), ("register", WORK / "reg")):
        clear_outputs(s)
        for p in s.rglob("encoded*.bin"):
            p.unlink()
        rec = pool_cli(s, kind, pids)
        check(rec["rc"] == 1 and run_files(s) == verdicts[kind],
              f"(b) pooled {kind} sweep: exit {rec['rc']}, verdict files "
              f"{'equal' if run_files(s) == verdicts[kind] else 'differ'}"
              f" (phase {5 if kind == 'wr' else 8}'s): "
              f"{rec['stderr'][-3000:]}")
        kern = "knossos_dense_scan" if kind == "register" \
            else "closure_square"
        n = rec[kern]["launches"]
        check(n == launches[kind], f"(b) pooled {kind}: {n} {kern} "
              f"launches, phase {5 if kind == 'wr' else 8} {launches[kind]}")
        (scan if kind == "register" else square)[f"pool-{kind}"] = (
            n, rec[kern]["device_ms"])
        if kind == "wr":
            pool_ran(s, rec, "(b) wr")
            sweeps["wr-cold"] = sweep_numbers(s, rec, WR_RUNS)
            check(bool(sweeps["wr-cold"]["counters"]["shm_bytes"]),
                  "(b) wr: no encoding rode shared memory")
            say(f"(b) pooled wr cold: {sweeps['wr-cold']}; {n} launches")
        else:
            load = rec.get("load") or {}
            check(load.get("pooled") is True, f"(c) the register load "
                  f"was not pooled: {load}")
            sweeps["register"] = {"wall": rec["wall"], "load": load}
            say(f"(b) pooled register: {rec['wall']:.3f}s wall, load "
                f"{load}; {n} knossos_dense_scan launches")
    out["sweeps"] = sweeps

    # (c) the register store's load, pooled against serial
    r = pool_tool("load", WORK / "reg", ncpu)
    check(r["equal"], f"(c) parallel_load != load_runs: {r}")
    out["register_load"] = r
    say(f"(c) register load of {r['runs']} runs: {r['pooled_secs']:.3f}s "
        f"pooled ({r['processes']} workers), {r['serial_secs']:.3f}s "
        "serial, histories equal")

    # (d) kill: a worker SIGKILLs itself on the selected runs; the sweep
    # resumes serially, the selected runs quarantined, the rest as clean
    kill = WORK / "pool-kill"
    shutil.copytree(store, kill)
    clear_outputs(kill)
    inj = supervisor._Injector(POOL_KILL)
    hit = {str(p.relative_to(kill)) for p in sorted(
        (kill / "synth").iterdir()) if inj.selects("kill", p.name)}
    check(0 < len(hit) < POOL_RUNS, f"(d) {POOL_KILL} selects {len(hit)}")
    rec = pool_cli(kill, "append", pids,
                   JEPSEN_TPU_FAULT_INJECT=POOL_KILL)
    check(rec["rc"] == 2, f"(d) the kill sweep exited {rec['rc']}, the "
          f"reference's code is 2: {rec['stderr'][-3000:]}")
    check("pool failed" in rec["stderr"], "(d) no worker died: the pool "
          "never failed")
    got = store_outputs(kill)
    for rel, want in clean.items():
        if rel == "verdicts.jsonl":
            continue
        run = str(Path(rel).parent)
        if run in hit:
            if rel.endswith("results.json"):
                res = json.loads(got[rel])
                check(res.get("quarantined") == "encode", f"(d) {run} "
                      f"was selected but not quarantined: {res}")
        else:
            check(got.get(rel) == want, f"(d) {rel} differs from the "
                  "clean sweep's")
    square["pool-kill"] = (rec["closure_square"]["launches"],
                           rec["closure_square"]["device_ms"])
    out["kill"] = {"selected": len(hit), "wall": rec["wall"],
                   "rc": rec["rc"]}
    say(f"(d) {POOL_KILL}: {len(hit)} runs selected, each quarantined "
        f"(encode), every other run == the clean sweep; exit 2; "
        f"{rec['wall']:.3f}s wall")
    left = [x for x in os.listdir("/dev/shm")
            if any(x.startswith(f"{shm.NAME_PREFIX}_{pid}_") for pid in pids)]
    check(not left, f"shared-memory segments left behind: {left}")
    say(f"/dev/shm holds no {shm.NAME_PREFIX}_<pid>_* segment of this "
        f"process or its {len(pids) - 1} sweeps")
    shutil.rmtree(kill)
    return {"closure_square": square, "knossos_dense_scan": scan,
            "numbers": out}


def store_files(store: Path) -> dict:
    """Every file under `store` (bytes, the store's own path replaced by
    `<store>`, so two stores' artifacts that record their paths compare)
    but the run's trace.json and metrics.json, and every link, by
    store-relative path."""
    out = {}
    for p in sorted(store.rglob("*")):
        rel = str(p.relative_to(store))
        if p.is_symlink():
            out[rel] = os.readlink(p)
        elif p.is_file() and p.name not in ("trace.json", "metrics.json"):
            out[rel] = p.read_bytes().replace(str(store).encode(),
                                              b"<store>")
    return out


def same_files(a: Path, b: Path, what: str) -> None:
    fa, fb = store_files(a), store_files(b)
    check(sorted(fa) == sorted(fb),
          f"{what}: files differ: {sorted(set(fa) ^ set(fb))}")
    for k in fa:
        check(fa[k] == fb[k], f"{what}: {k} differs between {a} and {b}")


def analyze(store: Path, run: str, checker, argv=()) -> tuple[int, float]:
    """`run_cli`'s analyze of one stored run in this process, its test
    map carrying `checker`; returns (exit code, wall seconds). analyze
    settles a race's losing side before it writes the verdict, and the
    card is synchronised before this returns, so every launch is
    counted and timed."""
    from jepsen_tpu_torch import cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.run_cli(lambda t, a: {**t, "checker": checker},
                         argv=["analyze", str(store / run), "--store",
                               str(store), *argv])
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0


@contextlib.contextmanager
def one_thread():
    """`independent.checker`'s fan-out and `compose` map in the calling
    thread for the block, one element after another."""
    from jepsen_tpu_torch import checker, independent

    def serial(f, coll, *_a, **_kw):
        return [f(x) for x in coll]
    saved = independent.bounded_pmap, checker.real_pmap
    independent.bounded_pmap = checker.real_pmap = serial
    try:
        yield
    finally:
        independent.bounded_pmap, checker.real_pmap = saved


def results_of(store: Path, run: str) -> dict:
    return json.loads((store / run / "results.json").read_text())


def phase_analyze(smi: str) -> dict:
    """Phase 14: `analyze` of one stored run on the card through the
    checkers a suite composes; returns per kernel, per path (launches,
    device milliseconds)."""
    from jepsen_tpu_torch import cli, independent
    from jepsen_tpu_torch import checker as jc
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import kernels, synth, wr
    from jepsen_tpu_torch.checker.elle import append_checker
    from jepsen_tpu_torch.checker.knossos import dense
    from jepsen_tpu_torch.checker.knossos import synth as ksynth

    t_phase = time.perf_counter()
    base = WORK / "analyze"
    cs_paths, dense_paths = {}, {}

    def copy(src: str, dst: str) -> Path:
        shutil.copytree(base / src, base / dst, symlinks=True)
        return base / dst

    # (a) list-append: a G1c run and a valid one at phase 4's width
    synth.write_synth_run_store(base / "append", B=2, T=STORE_T, K=STORE_K,
                                bad_every=2)
    copy("append", "append-plain")

    def append_suite(**kw):
        return jc.compose({"elle": append_checker(backend="tpu",
                                                  device=DEVICE, **kw),
                           "stats": jc.stats(),
                           "exceptions": jc.unhandled_exceptions()})
    log: list = []
    n_total, ms_total, walls = 0, 0.0, []
    for run, want in (("synth/run-00001", 1), ("synth/run-00000", 0)):
        (rc, wall), n, ms = counted(lambda: analyze(
            base / "append", run, append_suite(bucket_log=log)))
        check(rc == want, f"analyze {run} exited {rc}, expected {want}")
        n_total, ms_total = n_total + n, ms_total + ms
        walls.append(wall)
    active, skipped = launch_split(log, n_total)
    res = results_of(base / "append", "synth/run-00001")
    elle_res = res["elle"]
    check(res["valid?"] is False and elle_res["anomaly-types"] == ["G1c"]
          and elle_res["anomalies"]["G1c"][0]["cycle-txns"],
          f"the G1c run's verdict: {elle_res.get('anomaly-types')}")
    for f in ("G1c.txt", "anomalies.edn"):
        check((base / "append" / "synth/run-00001/elle" / f).is_file(),
              f"elle/{f} not written")
    check(results_of(base / "append", "synth/run-00000")["valid?"] is True,
          "the valid run")
    for run in ("synth/run-00001", "synth/run-00000"):
        (rc, _), relaunched, _ = counted(lambda: analyze(
            base / "append-plain", run,
            append_suite(square=cs.closure_square_ref)))
        check(relaunched == 0, "the plain-squaring analyze launched")
    same_files(base / "append", base / "append-plain", "analyze-append")
    cs_paths["analyze-append"] = (n_total, ms_total)
    say(f"analyze-append (compose of elle, stats, exceptions; {STORE_T} "
        f"txns): G1c run {walls[0]:.3f}s wall, valid run {walls[1]:.3f}s; "
        f"{n_total} closure_square launches ({active} active, {skipped} "
        f"skipped; {len(log)} dispatches at T_pad "
        f"{sorted({b['t_pad'] for b in log})}) taking {ms_total} ms of "
        f"device time ({smi}); results, elle/ and links byte-identical "
        "to the plain squaring's")

    # (b) rw-register: a write-skew run at phase 5's width
    synth.write_wr_run_store(base / "wr", B=2, T=WR_T, K=WR_K, bad_every=2)
    copy("wr", "wr-plain")
    (rc, wall), n, ms = counted(lambda: analyze(
        base / "wr", "wr/run-00001",
        wr.rw_register_checker(backend="tpu", device=DEVICE)))
    check(rc == 1 and results_of(base / "wr", "wr/run-00001")[
        "anomaly-types"] == ["G2-item"], f"wr analyze exited {rc}")
    steps = kernels.closure_steps(kernels.pad_to(WR_T + 2, 128))
    check(n > 0 and n % steps == 0,
          f"{n} closure_square launches, not whole closures of {steps}")
    (rc_p, _), relaunched, _ = counted(lambda: analyze(
        base / "wr-plain", "wr/run-00001", wr.rw_register_checker(
            backend="tpu", device=DEVICE, square=cs.closure_square_ref)))
    check(rc_p == rc and relaunched == 0, "the plain-squaring wr analyze")
    same_files(base / "wr", base / "wr-plain", "analyze-wr")
    cs_paths["analyze-wr"] = (n, ms)
    say(f"analyze-wr: {wall:.3f}s wall, {n} closure_square launches "
        f"({n // steps} closures of {steps} rounds) taking {ms} ms of "
        f"device time ({smi}); byte-identical to the plain squaring's")

    # (c)-(e) an etcd-shaped lifted CAS-register run, key 0 corrupt
    ksynth.write_register_run_store(base / "reg", runs=1, ops=REG_OPS,
                                    keys=REG_KEYS, bad_every=1)
    run = "register/run-00000"
    for d in ("reg-plain", "reg-fanout", "reg-fanout-1", "reg-race"):
        copy("reg", d)

    def linear(**kw):
        return jc.linearizable(backend=kw.pop("backend", "tpu"),
                               device=DEVICE, **kw)

    def keyed(store: Path) -> dict:
        return results_of(store, run)["results"]

    (rc, wall), n, ms = counted_dense(lambda: analyze(
        base / "reg", run, independent.checker(linear())))
    res = results_of(base / "reg", run)
    check(rc == 1 and res["failures"] == [0] and n > 0,
          f"register analyze: rc {rc}, failures {res['failures']}, "
          f"{n} launches")
    keys_dir = base / "reg" / run / "independent"
    for k in range(REG_KEYS):
        for f in ("results.edn", "history.edn"):
            check((keys_dir / str(k) / f).is_file(), f"key {k}: no {f}")
    check(sorted(p.parent.name for p in keys_dir.glob("*/linear.svg"))
          == ["0"], "linear.svg for key 0 only")
    (rc_p, _), relaunched, _ = counted_dense(lambda: analyze(
        base / "reg-plain", run, independent.checker(
            linear(dense_scan=dense.scan_dense_ref))))
    check(rc_p == rc and relaunched == 0, "the plain-scan analyze")
    same_files(base / "reg", base / "reg-plain", "analyze-register")
    dense_paths["analyze-register"] = (n, ms)
    say(f"analyze-register (batch route, {REG_KEYS} keys of "
        f"{REG_OPS // REG_KEYS} ops): {wall:.3f}s wall, {n} "
        f"knossos_dense_scan launches taking {ms} ms of device time "
        f"({smi}); byte-identical to scan_dense_ref's")

    def fanout():
        return independent.checker(jc.compose({
            "timeline": jc.timeline_checker(), "linear": linear()}))
    (rc, wall), n, _ = counted_dense(lambda: analyze(
        base / "reg-fanout", run, fanout()))
    check(rc == 1 and n == REG_KEYS,
          f"fan-out: rc {rc}, {n} launches for {REG_KEYS} keys")
    # 8 threads launch at once, and a thread's event pair also brackets
    # its wait for the GIL between the start and the launch; so the
    # fan-out's device time comes from a second pass of the same path on
    # one thread (the keys in turn, compose's checkers in turn)
    with one_thread():
        (rc_1, wall_1), n_1, ms = counted_dense(lambda: analyze(
            base / "reg-fanout-1", run, fanout()))
    check(rc_1 == rc and n_1 == n,
          f"the one-thread fan-out: rc {rc_1}, {n_1} launches")
    fan = keyed(base / "reg-fanout")
    check({k: r["linear"] for k, r in fan.items()} == keyed(base / "reg")
          == {k: r["linear"] for k, r in
              keyed(base / "reg-fanout-1").items()},
          "fan-out verdicts differ from the batch route's")
    check(all((base / "reg-fanout" / run / "independent" / str(k)
               / "timeline.html").is_file() for k in range(REG_KEYS)),
          "a key without its timeline.html")
    dense_paths["analyze-fanout"] = (n, ms)
    say(f"analyze-fanout (compose of timeline and linear a key, "
        f"{os.cpu_count()} threads): {wall:.3f}s wall, {n} "
        f"knossos_dense_scan launches (one a key); on one thread "
        f"({wall_1:.3f}s wall) they took {ms} ms of device time ({smi}); "
        "every key's verdict as the batch route's")

    (rc, wall), n, ms = counted_dense(lambda: analyze(
        base / "reg-race", run, independent.checker(linear(backend="race"))))
    def valid(store: Path) -> dict:
        return {k: r["valid?"] for k, r in keyed(store).items()}
    check(rc == 1 and valid(base / "reg-race") == valid(base / "reg"),
          "race verdicts differ from the batch route's")
    check(n > 0, "the race's device side never launched")
    won = json.loads((base / "reg-race" / run / "metrics.json")
                     .read_text())["counters"]
    winner = "device" if won.get("race_won_device") else "cpu"
    # the device side's own verdicts: they answered, or, as the loser,
    # they were held to the CPU side's, which equal the batch route's
    held = won.get("race_device_agree", 0)
    check(won.get(f"race_won_{winner}") == 1
          and held == (winner == "cpu")
          and not won.get("race_device_disagree")
          and not won.get("race_device_error"),
          f"the race's counters: {won}")
    dense_paths["analyze-race"] = (n, ms)
    say(f"analyze-race: {wall:.3f}s wall, the {winner} side won; {n} "
        f"knossos_dense_scan launches (the device side run to its end, "
        f"its verdicts {'held to the CPU side' if held else 'the answer'})"
        f" taking {ms} ms of device time ({smi}); verdicts as the batch "
        "route's")

    # (f) analyze-store --backend cpu: the host oracles, no launch
    for d in ("small-dev", "small-host"):
        synth.write_synth_run_store(base / d, B=8, T=300, K=16, bad_every=4)
    rc_d, _, _, _ = sweep(base / "small-dev", device=DEVICE)
    saved = os.environ.get("JEPSEN_TPU_BACKEND")
    with contextlib.redirect_stdout(io.StringIO()):
        rc_h, n, _ = counted(lambda: cli.main([
            "analyze-store", "--store", str(base / "small-host"),
            "--backend", "cpu"]))
    check(rc_h == rc_d == 1 and n == 0,
          f"--backend cpu: rc {rc_h} (device {rc_d}), {n} launches")
    check(os.environ.get("JEPSEN_TPU_BACKEND") == saved,
          "--backend outlived its call")
    journal = [(base / d / "verdicts.jsonl").read_text()
               for d in ("small-dev", "small-host")]
    check(journal[0] == journal[1], "--backend cpu's verdicts.jsonl differs")
    for p in sorted((base / "small-dev" / "synth").iterdir()):
        a, b = (json.loads((base / d / "synth" / p.name / "results.json")
                           .read_text()) for d in ("small-dev", "small-host"))
        check((a["valid?"], a["anomaly-types"])
              == (b["valid?"], b["anomaly-types"]),
              f"--backend cpu: {p.name}'s verdict differs")
    say("analyze-store --backend cpu: the same verdicts.jsonl and "
        "verdicts as the device sweep, no kernel launched")
    say(f"phase 14 in {time.perf_counter() - t_phase:.1f}s")
    return {"closure_square": cs_paths, "knossos_dense_scan": dense_paths}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def live_sweep(store: Path, checker: str) -> dict:
    """One sweep of `store` with all four gates on — the costdb, the
    health sampler (every 0.5 s), the metrics endpoint (a free port) and
    the planner (cold: the store has no plan.json) — and --report;
    /metrics is scraped from the sweep's start to its end. Returns its
    numbers and files."""
    import threading
    import urllib.request

    scrapes: list = []
    stop = threading.Event()
    threads: list = []

    def scrape(port: int) -> None:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            scrapes.append(r.read().decode())

    def hook(server, sampler):
        check(server is not None and sampler is not None,
              "the metrics endpoint or the health sampler did not start")
        scrape(server.port)

        def loop():
            while not stop.wait(0.02):
                try:
                    scrape(server.port)
                except OSError:
                    return          # the endpoint stopped with the sweep
        threads.append(threading.Thread(target=loop, daemon=True))
        threads[0].start()

    port = free_port()
    with gate_env(JEPSEN_TPU_COSTDB=1, JEPSEN_TPU_HEALTH_INTERVAL_S=0.5,
                  JEPSEN_TPU_METRICS_PORT=port, JEPSEN_TPU_PLANNER=1):
        try:
            (rc, log, wall, _), n, ms = counted(lambda: sweep(
                store, checker, device=DEVICE, report=True, obs_hook=hook))
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=10)
    check(bool(scrapes) and all("jepsen_tpu_" in p for p in scrapes),
          f"{checker}: /metrics answered {len(scrapes)} scrapes")
    metrics = json.loads((store / "metrics.json").read_text())
    return {"rc": rc, "log": log, "wall": wall, "launches": n,
            "square_ms": ms, "scrapes": len(scrapes), "port": port,
            "metrics": metrics,
            "health": json.loads((store / "health.json").read_text()),
            "report": json.loads((store / "report.json").read_text()),
            "bucket_secs": metrics["histograms"].get("device.bucket",
                                                     {}).get("sum", 0.0)}


def check_costdb(store: Path, name: str, what: str) -> list:
    """The store's costdb: every record measured on the card against the
    card's peak row, every roofline share at most 1.05."""
    from jepsen_tpu_torch.checker.elle import kernels
    from jepsen_tpu_torch.store import load_costdb

    recs = list(load_costdb(store))
    check(bool(recs), f"{what}: no costdb.jsonl records")
    row = kernels.device_peak(name)
    for r in recs:
        check(r["provenance"] == "measured" and r["peak"] == row
              and row["source"] == "table" and r["backend"] == "cuda"
              and r["formulation"] == "cuda-int8",
              f"{what}: record {r['geometry']} is {r['provenance']}, "
              f"{r['formulation']}, peak {r['peak']}")
        for k, v in r["roofline"].items():
            check(v is not None and 0 <= v <= 1.05,
                  f"{what}: {k} {v} for {r['geometry']}")
    return recs


def dispatch_parts(name: str) -> dict:
    """Row 5's missing cell: `kernels._edges_batched(with_counts=True)`
    timed apart from its bucket, at phase 4's bucket shape (2 of its
    histories at T_pad=5120), against the bytes it must move (the
    append and read tables read once, the three [B,T,T] bool matrices
    and the counts written once); the wr path's matrix build,
    `kernels.edge_batch_to_device` (its host-built edge lists copied and
    scattered), at phase 5's bucket shape; and one whole dispatch of
    that append bucket alone (`kernels.check_batch_device`): its
    CUDA-event window, as the cost observatory takes it, beside the
    device time of the kernels and copies torch.profiler sees in it —
    what of the window the card spent working."""
    from jepsen_tpu_torch import ingest
    from jepsen_tpu_torch.checker.elle import kernels
    from jepsen_tpu_torch.checker.elle import wr as wr_mod

    _, bw = peaks(name)
    runs = sorted((WORK / "store" / "synth").iterdir())[:MAIN_B]
    encs = [ingest.encode_run_dir(d, "append") for d in runs]
    shape = kernels.BatchShape.plan(encs)
    batch = kernels.batch_to_device(kernels.pack_batch(encs, shape), DEVICE)
    args = (batch["appends"], batch["reads"], shape.n_keys, shape.max_pos,
            shape.n_txns)
    ms = statistics.median(cuda_ms(
        lambda: kernels._edges_batched(*args, with_counts=True), 10))
    B, T = len(encs), shape.n_txns
    moved = (batch["appends"].nbytes + batch["reads"].nbytes
             + 3 * B * T * T + 3 * B * 8)
    wr_runs = sorted((WORK / "wr" / "wr").iterdir())[:WIDE_B]
    eds = [wr_mod.to_edge_dict(ingest.encode_run_dir(d, "wr"))
           for d in wr_runs]
    packed = kernels.pack_edge_matrices(eds)
    wr_ms = statistics.median(cuda_ms(
        lambda: kernels.edge_batch_to_device(packed, torch.device(DEVICE)),
        10, burst=1))

    def one():
        kernels.check_batch_device(batch, classify=True, fused=True)
    window = statistics.median(cuda_ms(one, 5, burst=1))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one()
        torch.cuda.synchronize()
    busy_us = sum(getattr(a, "self_device_time_total", 0)
                  for a in prof.key_averages())
    return {"ms": ms, "bound_ms": moved / bw * 1e3, "B": B, "T": T,
            "bytes": moved, "wr_ms": wr_ms, "wr_B": len(eds),
            "wr_T": packed["T"], "dispatch_window_ms": window,
            "dispatch_busy_ms": busy_us / 3e3 if busy_us else None}


#: Phase 15's planner store: PLAN_RUNS of phase 4's runs (T=5000) and
#: one run of each length here, so that the append sweep's buckets
#: compose differently at pad multiple 512 than at 128 (at 128 the
#: 3,300-txn bucket takes six histories; at 512, five, and the sixth
#: joins the shorter ones).
PLAN_RUNS = 8
PLAN_MIX = (3300, 2900, 2500, 2500, 2000, 2000, 1500, 1500)


def planner_store(base: Path) -> list[str]:
    """The planner store: phase 4's first PLAN_RUNS runs (with their
    sidecars) and the PLAN_MIX runs; returns phase 4's run names."""
    from jepsen_tpu_torch.checker.elle import synth

    src = WORK / "store" / "synth"
    runs = sorted(p.name for p in src.iterdir())[:PLAN_RUNS]
    copy_runs(src, base / "synth", runs)
    for i, t in enumerate(PLAN_MIX):
        synth.write_synth_run_store(base, B=1, T=t, K=STORE_K,
                                    bad_every=1 if i % 3 == 0 else 0,
                                    name=f"mix{i}")
    for p in list(base.rglob("results.*")) + list(base.rglob(".sweep-*")):
        p.unlink()
    return runs


def compositions(sizes: list[int], plan: dict | None) -> dict:
    """(histories, T_pad) of each bucket the append sweep composes for
    histories of `sizes`: by the planner with `plan`, and by
    bucket_by_length at each candidate multiple."""
    from jepsen_tpu_torch import parallel, planner
    from jepsen_tpu_torch.checker.elle import kernels

    class Sized:
        def __init__(self, n):
            self.n = n

    encs = [Sized(n) for n in sizes]
    budget = (1 << 27) // 2     # check_bucketed's, two buckets in flight

    def sig(buckets):
        return sorted((len(b), kernels.pad_to(max(sizes[i] for i in b), 128))
                      for b in buckets)
    out = {m: sig(parallel.bucket_by_length(encs, multiple=m,
                                            budget_cells=budget))
           for m in planner.GEOMETRY_CANDIDATES}
    with gate_env(JEPSEN_TPU_PLANNER=1):
        out["planner"] = sig(planner.Planner(plan, "plan").plan_buckets(
            encs, budget_cells=budget))
    return out


def phase_costdb(launches: dict, verdicts: dict, name: str) -> dict:
    """Phase 15: the device cost observatory, the live telemetry and the
    planner on the card. Returns the paths' (launches, device ms) and
    the numbers PERF.md reads."""
    from jepsen_tpu_torch import ingest, planner
    from jepsen_tpu_torch.store import load_costdb, plan_path

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    paths: dict = {}
    out: dict = {}
    for kind, store, n_runs in (("append", WORK / "store", STORE_RUNS),
                                ("wr", WORK / "wr", WR_RUNS)):
        clear_outputs(store)
        live = live_sweep(store, kind)
        what = f"costdb-{kind}"
        check(live["rc"] == 1, f"{what}: exit {live['rc']}")
        check(run_files(store) == verdicts[kind],
              f"{what}: verdict files differ from phase "
              f"{4 if kind == 'append' else 5}'s")
        check(live["launches"] == launches[kind],
              f"{what}: {live['launches']} closure_square launches, phase "
              f"{4 if kind == 'append' else 5} {launches[kind]}")
        h = live["health"]
        check(h["progress"]["runs_verdicted"] == n_runs
              and h["progress"]["runs_total"] == n_runs,
              f"{what}: health.json progress {h['progress']}")
        paths[what] = (live["launches"], live["square_ms"])
        row = {"wall": live["wall"], "launches": live["launches"],
               "square_ms": live["square_ms"], "scrapes": live["scrapes"],
               "bucket_secs": live["bucket_secs"],
               "health_device": h["device"]}
        if kind == "wr":
            # the reference observes no edge-batch dispatch: no costdb
            check(not (store / "costdb.jsonl").exists(),
                  f"{what}: a costdb was written for edge batches")
            out[what] = row
            say(f"{what}: {live['wall']:.3f}s wall, rc 1, verdicts as "
                f"phase 5's, {live['launches']} closure_square launches "
                f"({live['square_ms']} ms); /metrics scraped "
                f"{live['scrapes']} times on port {live['port']}; "
                f"health.json {h['progress']}; no costdb (edge batches "
                f"are not observed dispatches, as in the reference); "
                f"tracer bucket windows {live['bucket_secs']} s; card {smi}")
            continue
        recs = check_costdb(store, name, what)
        dev_s = sum(r["windows"]["device_secs"] for r in recs)
        sq_s = live["square_ms"] / 1e3
        check(dev_s >= sq_s, f"{what}: device_secs {dev_s} under the "
              f"closure_square event sum {sq_s}")
        g = live["metrics"]["gauges"]
        check(g.get("hbm_device_bytes", 0) > 0
              and (h["device"]["hbm_device_bytes"] or 0) > 0
              and g.get("resident_executables", 0) >= 1,
              f"{what}: residency gauges {g}, health {h['device']}")
        dev = live["report"].get("device") or {}
        check(dev.get("provenance") == "measured"
              and len(dev.get("records", [])) == len(recs),
              f"{what}: report.json device section {dev}")
        row.update(device_secs=dev_s, records=[{
            "geometry": r["geometry"], "windows": r["windows"],
            "cost": r["cost"], "memory": r["memory"],
            "roofline": r["roofline"]} for r in recs],
            ratio_bucket_to_device=live["bucket_secs"] / dev_s,
            ratio_device_to_square=dev_s / sq_s if sq_s else None)
        out[what] = row
        say(f"{what}: {live['wall']:.3f}s wall, rc 1, verdicts as phase "
            f"4's; costdb {len(recs)} record(s), measured against "
            f"{recs[0]['peak']}; sum device_secs {dev_s} s (CUDA events) "
            f"against {sq_s} s of closure_square (event pairs, "
            f"{live['launches']} launches) and {live['bucket_secs']} s of "
            f"tracer bucket windows (bucket / device_secs "
            f"{row['ratio_bucket_to_device']}); records "
            + "; ".join(f"B{r['geometry']['B']}xT{r['geometry']['n_txns']}"
                        f" x{r['windows']['dispatches']}: "
                        f"{r['windows']['device_secs']} s, flops util "
                        f"{r['roofline']['flops_utilization']}, bw util "
                        f"{r['roofline']['bandwidth_utilization']}, memory "
                        f"{r['memory']}" for r in recs)
            + f"; /metrics scraped {live['scrapes']} times; gauges "
            f"{ {k: g.get(k) for k in ('resident_executables', 'hbm_modeled_bytes', 'hbm_device_bytes')} }; "
            f"card {smi}")

    # the planner: a cold sweep fits plan.json, a warm one composes
    plan_base = WORK / "plan"
    runs = planner_store(plan_base)
    sizes = [ingest.encode_run_dir(d, "append").n
             for d in sorted(p for p in plan_base.glob("*/*") if p.is_dir())]
    cold_want = compositions(sizes, None)
    sweeps = {}
    for warmth in ("cold", "warm"):
        if warmth == "warm":
            plan = planner.load_plan(plan_path(plan_base))
            check(plan is not None, "the cold planner sweep fit no plan.json")
            want = compositions(sizes, plan)
            seeded = want["planner"] == want[128]
            if seeded:
                # the fit from this store's own costdb prices the 128
                # composition cheapest: seed plan.json from a costdb
                # whose per-history seconds grow as T_pad², measured at
                # this store's pads, as the planner's tests do
                pads = sorted({b for _, b in want[128]})
                recs = [{"kernel": {"classify": True, "realtime": False,
                                    "process_order": False, "fused": True},
                         "formulation": "cuda-int8",
                         "geometry": {"B": 2, "n_txns": t},
                         "windows": {"dispatches": 4, "histories": 8,
                                     "device_secs": 4 * (t / 128) ** 2
                                     * 1e-5, "min_secs": 1e-6},
                         "backend": "cuda", "device_kind": name,
                         "provenance": "measured"} for t in pads]
                plan = planner.fit_plan(recs, [])
                planner.save_plan(plan_path(plan_base), plan)
                want = compositions(sizes, plan)
            check(want["planner"] != want[128],
                  f"the warm planner composes as multiple 128: {want}")
        else:
            want = cold_want
        clear_outputs(plan_base)
        with gate_env(JEPSEN_TPU_PLANNER=1, JEPSEN_TPU_COSTDB=1):
            (rc, log, wall, _), n, ms = counted(lambda: sweep(
                plan_base, "append", device=DEVICE, report=True))
        got = sorted((b["histories"], b["t_pad"]) for b in log)
        what = f"planner-append-{warmth}"
        check(rc == 1, f"{what}: exit {rc}")
        check(got == want["planner"], f"{what}: buckets {got}, planned "
              f"{want['planner']}")
        if warmth == "cold":
            check(got == want[128], f"{what}: buckets {got} are not "
                  f"bucket_by_length's at 128 {want[128]}")
        launch_split(log, n)
        files = run_files(plan_base)
        for run in runs:
            for f in ("results.json", "results.edn"):
                k = f"synth/{run}/{f}"
                check(files[k] == verdicts["append"][k],
                      f"{what}: {k} differs from phase 4's")
        sweeps[warmth] = files
        rep = json.loads((plan_base / "report.json").read_text())
        paths[what] = (n, ms)
        chosen = [m for m in planner.GEOMETRY_CANDIDATES
                  if want[m] == want["planner"]]
        out[what] = {"wall": wall, "launches": n, "square_ms": ms,
                     "buckets": got, "multiples": chosen,
                     "planner": rep.get("planner"),
                     "seeded": warmth == "warm" and seeded,
                     "costdb_records": len(load_costdb(plan_base))}
        say(f"{what}: {wall:.3f}s wall, rc 1, buckets (histories, T_pad) "
            f"{got}, composed as multiple(s) {chosen} (128: {want[128]}); "
            + (f"plan.json seeded (the store's own fit chose 128): "
               if warmth == "warm" and seeded else "")
            + f"report planner section {rep.get('planner')}; {n} "
            f"closure_square launches ({ms} ms); card {smi}")
    check(sweeps["cold"] == sweeps["warm"],
          "the warm planner sweep's verdicts differ from the cold one's")

    out["edges"] = e = dispatch_parts(name)
    say(f"_edges_batched(with_counts=True) at B={e['B']}, T={e['T']}: "
        f"{e['ms']} ms (median of 10 event-timed samples) against a "
        f"{e['bound_ms']} ms bound ({e['bytes']} bytes at the card's "
        f"HBM rate); the wr path's edge_batch_to_device at B={e['wr_B']}, "
        f"T={e['wr_T']}: {e['wr_ms']} ms; one append dispatch alone: "
        f"{e['dispatch_window_ms']} ms event window, "
        f"{e['dispatch_busy_ms'] if e['dispatch_busy_ms'] else 'not measured (the profiler saw no device time)'}"
        f" ms of kernels and copies in it (torch.profiler); card {smi}")
    say(f"phase 15 took {time.perf_counter() - t_phase:.1f}s")
    return {"paths": paths, "numbers": out}


#: Phase 16: each tenant's fairness weight, and the acks after which
#: the subprocess daemon is SIGKILLed.
SERVE_WEIGHTS = {"A": 2.0, "B": 1.0, "C": 1.0}
SERVE_KILL_AFTER = 8
#: Phase 17: the fleet's size.
FLEET_DAEMONS = 3


class FoldMeter:
    """Stands in for a daemon's FoldDispatcher: forwards each fold to it
    and records, on the dispatch thread, the fold's checker and size,
    its buckets (the dispatcher's `bucket_log`) and the closure_square
    launches and event pairs the fold added. Only the dispatch thread
    launches kernels while the daemon serves, so the deltas are the
    fold's own."""

    def __init__(self, inner, kernel):
        self.inner, self.kernel = inner, kernel
        inner.bucket_log = []
        self.folds: list = []

    def verdicts(self, encs, checker, **kw):
        log, k = self.inner.bucket_log, self.kernel
        n0, e0, b0 = k.launches, len(k.events), len(log)
        out = self.inner.verdicts(encs, checker, **kw)
        self.folds.append({"checker": checker, "histories": len(encs),
                           "launches": k.launches - n0,
                           "events": k.events[e0:], "buckets": log[b0:]})
        return out


def history_ops(run: Path) -> list:
    return [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines() if ln]


def phase_result(verdicts: dict, checker: str, run: Path) -> dict:
    """Phase 4's (append) or phase 5's (wr) results.json of `run`."""
    kind = "wr" if checker == "wr" else "synth"
    return json.loads(verdicts[checker][f"{kind}/{run.name}/results.json"])


def same_as_phase(verdicts: dict, checker: str, run: Path, res: dict,
                  what: str) -> None:
    want = phase_result(verdicts, checker, run)
    check(json.dumps(res) == json.dumps(want),
          f"{what}: the verdict of {run.name} ({checker}) differs from "
          f"phase {4 if checker == 'append' else 5}'s: {res} vs {want}")
    h = int(run.name.split("-")[1])
    bad = BAD_EVERY if checker == "append" else WR_BAD_EVERY
    check(res["valid?"] is (h % bad != bad - 1),
          f"{what}: {run.name} ({checker}) valid? {res['valid?']}")


def serve_tenants(sock: str, plan: dict, resend: bool = False) -> tuple:
    """Every tenant of `plan` ({tenant: [(how, checker, run)]}) on its
    own thread and connection: submit its runs (by dir, inline or shm;
    with `resend`, every one by dir under the same ids) and collect.
    Returns ({tenant: {id: result}}, {tenant: client}, wall seconds)."""
    import threading
    from jepsen_tpu_torch import ingest
    from jepsen_tpu_torch.serve.client import ServeClient

    results, clients, errors = {}, {}, []

    def run(tenant: str, items: list) -> None:
        try:
            c = ServeClient(socket_path=sock, tenant=tenant,
                            weight=SERVE_WEIGHTS[tenant], timeout=600)
            c.connect()
            for how, checker, d in items:
                rid = f"{checker}/{d.name}"
                if how == "dir" or resend:
                    c.check_dir(d, checker=checker, rid=rid)
                elif how == "inline":
                    c.check_history(history_ops(d), rid, checker)
                else:
                    c.check_encoded(ingest.encode_run_dir(d, checker), rid,
                                    checker)
            results[tenant] = c.collect(timeout=600)
            clients[tenant] = c
            c.close()
        except Exception as e:        # noqa: BLE001 (reported below)
            errors.append(f"tenant {tenant}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(t, items))
               for t, items in plan.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors and len(results) == len(plan),
          f"serve tenants failed: {errors}")
    return results, clients, wall


def journal_counts(store: Path, tenant: str) -> dict:
    """{id: parsed lines} of a tenant's journal (a torn line skipped)."""
    from jepsen_tpu_torch.store import tenant_journal_path
    counts: dict = {}
    p = tenant_journal_path(store, tenant)
    for ln in (p.read_text().splitlines() if p.exists() else []):
        try:
            e = json.loads(ln)
        except json.JSONDecodeError:
            continue
        counts[e["dir"]] = counts.get(e["dir"], 0) + 1
    return counts


def start_proc(argv: list, key: str, log: Path, procs: list) -> tuple:
    """Start `argv` (its stderr to `log`) and read its stdout up to the
    JSON ready line holding `key`; returns (proc, that record)."""
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=open(log, "w"), text=True)
    procs.append(proc)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        with contextlib.suppress(json.JSONDecodeError):
            rec = json.loads(line)
            if isinstance(rec, dict) and key in rec:
                return proc, rec[key]
    proc.kill()
    proc.wait()
    raise SmokeFailure(f"{argv[3]} gave no ready line: "
                       f"{log.read_text()[-3000:]}")


def end_procs(procs: list) -> None:
    """End the daemons and routers a phase started: SIGTERM first (a
    router stops and reaps its members), SIGKILL after 60 s."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        p.wait()
        p.stdout.close()


def phase_serve(verdicts: dict) -> dict:
    """Phase 16: the verdict daemon on the card. Returns the paths'
    (launches, device ms) and the numbers PERF.md reads."""
    import urllib.request
    from jepsen_tpu_torch import trace
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.serve.client import ServeClient
    from jepsen_tpu_torch.serve.daemon import VerdictDaemon
    from jepsen_tpu_torch.store import Store, VerdictJournal, \
        tenant_journal_path

    t_phase = time.perf_counter()
    append_runs = sorted(p for p in (WORK / "store" / "synth").iterdir()
                         if p.is_dir())
    wr_runs = sorted(p for p in (WORK / "wr" / "wr").iterdir() if p.is_dir())
    half = len(append_runs) // 2
    plan = {"A": [("dir", "append", d) for d in append_runs[:half]],
            "B": [("inline" if i % 2 == 0 else "shm", "append", d)
                  for i, d in enumerate(append_runs[half:])],
            "C": [("dir", "wr", d) for d in wr_runs]}
    runs_of = {t: {f"{c}/{d.name}": (c, d) for _h, c, d in items}
               for t, items in plan.items()}
    base = WORK / "serve"
    base.mkdir()
    prev = trace.get_current()
    kernel = cs.closure_square
    out: dict = {}
    try:
        with gate_env(JEPSEN_TPU_METRICS_PORT=0,
                      JEPSEN_TPU_HEALTH_INTERVAL_S=0.5):
            d = VerdictDaemon(Store(base), device=DEVICE).start()
        try:
            meter = FoldMeter(d._dispatcher, kernel)
            d._dispatcher = meter
            info = d.ready_info()["serve"]
            (got, _c, wall), launches, square_ms = counted(
                lambda: serve_tenants(info["socket"], plan))
            torch.cuda.synchronize()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{info['metrics_port']}/metrics",
                    timeout=60) as r:
                page = r.read().decode()
            (again, clients, _w), relaunched, _ = counted(
                lambda: serve_tenants(info["socket"], plan, resend=True))
            spans = [e["dur"] / 1e3 for e in trace.get_current()
                     .chrome_events() if e.get("name") == "serve_request"]
        finally:
            rc = d.stop()
    finally:
        trace.set_current(prev)
    check(rc == 0, f"the daemon's drain returned {rc}")
    for t, res in got.items():
        check(set(res) == set(runs_of[t]), f"tenant {t}: ids {sorted(res)}")
        for rid, r in res.items():
            checker, run = runs_of[t][rid]
            same_as_phase(verdicts, checker, run, r, f"serve tenant {t}")
        check({k: json.dumps(v) for k, v in again[t].items()}
              == {k: json.dumps(v) for k, v in res.items()},
              f"tenant {t}: replayed verdicts differ")
        check(clients[t].replays == len(res),
              f"tenant {t}: {clients[t].replays} of {len(res)} replayed")
        counts = journal_counts(base, t)
        check(counts == {rid: 1 for rid in res},
              f"tenant {t}: journal lines per id {counts}")
    check(relaunched == 0, f"the resend launched {relaunched} kernels")
    check(len(spans) == sum(len(r) for r in got.values()),
          f"{len(spans)} serve_request spans")
    for t in plan:
        check(f"jepsen_tpu_serve_{t}_verdicts" in page,
              f"/metrics has no serve.{t}.* series")
    health = json.loads((base / "health.json").read_text())
    check(set(health.get("serve", {}).get("tenants", {})) == set(plan),
          f"health.json serve section: {health.get('serve')}")

    paths, folds = {}, meter.folds
    check(sum(f["launches"] for f in folds) == launches,
          f"{launches} launches, {sum(f['launches'] for f in folds)} in folds")
    for checker in ("append", "wr"):
        mine = [f for f in folds if f["checker"] == checker]
        n = sum(f["launches"] for f in mine)
        check(n > 0, f"serve-{checker}: closure_square never launched")
        active, skipped = launch_split(
            [b for f in mine for b in f["buckets"]], n)
        ms = sum(a.elapsed_time(b) for f in mine for a, b in f["events"])
        paths[f"serve-{checker}"] = (n, ms)
        out[f"serve-{checker}"] = {
            "folds": [f["histories"] for f in mine],
            "buckets": [[b["histories"] for b in f["buckets"]]
                        for f in mine],
            "t_pad": sorted({b["t_pad"] for f in mine
                             for b in f["buckets"]}),
            "launches": n, "active": active, "skipped": skipped,
            "device_ms": ms}
        say(f"serve-{checker}: {len(mine)} folds of "
            f"{out[f'serve-{checker}']['folds']} histories, buckets "
            f"{out[f'serve-{checker}']['buckets']} at T_pad "
            f"{out[f'serve-{checker}']['t_pad']}; {n} closure_square "
            f"launches ({active} active, {skipped} skipped) taking "
            f"{ms} ms of device time (CUDA event pairs)")
    n_verdicts = sum(len(r) for r in got.values())
    spans.sort()
    out["verdicts"] = n_verdicts
    out["wall"] = wall
    out["verdicts_per_s"] = n_verdicts / wall
    out["latency_ms"] = {"p50": spans[len(spans) // 2],
                         "p99": spans[min(len(spans) - 1,
                                          int(0.99 * len(spans)))]}
    say(f"serve: 3 tenants (A weight 2: {half} by dir; B: "
        f"{len(append_runs) - half} inline and shm; C: {len(wr_runs)} wr "
        f"by dir), {n_verdicts} verdicts in {wall:.3f}s wall "
        f"({out['verdicts_per_s']:.3f} verdicts/s), serve_latency_ms "
        f"(serve_request spans) p50 {out['latency_ms']['p50']} p99 "
        f"{out['latency_ms']['p99']}; every ack equal to phase 4's or "
        "5's results.json, exactly the corrupt runs invalid; /metrics "
        "per-tenant series and health.json's serve section present; "
        f"the resend replayed all {n_verdicts} with 0 launches")

    # the CLI daemon: SIGKILL after SERVE_KILL_AFTER acks, restart, resend
    pbase = WORK / "serve-proc"
    pbase.mkdir()
    argv = [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
            "--store", str(pbase), "--device", DEVICE]
    procs: list = []
    ids = {d.name: d for d in append_runs}
    try:
        t0 = time.perf_counter()
        proc, ready = start_proc(argv, "serve", WORK / "serve-1.log", procs)
        t_ready = time.perf_counter() - t0
        c = ServeClient(socket_path=ready["socket"], tenant="K", timeout=600)
        c.connect()
        for d in append_runs:
            c.check_dir(d, rid=d.name)
        acks = 0
        while acks < SERVE_KILL_AFTER:
            f = c.recv()
            check(f is not None, "the CLI daemon closed the connection")
            acks += f.get("op") == "verdict"
        proc.kill()
        proc.wait()
        c.sock.close()
        jp = tenant_journal_path(pbase, "K")
        journaled = len(VerdictJournal.load(jp))
        check(journaled >= SERVE_KILL_AFTER,
              f"{journaled} journaled after {acks} acks")
        proc2, ready2 = start_proc(argv, "serve", WORK / "serve-2.log",
                                   procs)
        c2 = ServeClient(socket_path=ready2["socket"], tenant="K",
                         timeout=600)
        c2.connect()
        check(c2.welcome["journaled"] == journaled,
              f"the restart saw {c2.welcome['journaled']} journaled, "
              f"not {journaled}")
        for d in append_runs:
            c2.check_dir(d, rid=d.name)
        res = c2.collect(timeout=600)
        c2.close()
        check(c2.replays == journaled,
              f"{c2.replays} replays of {journaled} journaled")
        for rid, r in res.items():
            same_as_phase(verdicts, "append", ids[rid], r, "serve CLI")
        counts = journal_counts(pbase, "K")
        check(counts == {d.name: 1 for d in append_runs},
              f"serve CLI: journal lines per id {counts}")
        proc2.send_signal(signal.SIGTERM)
        rc2 = proc2.wait(timeout=300)
        check(rc2 == 0, f"the CLI daemon's SIGTERM drain exited {rc2}")
    finally:
        end_procs(procs)
    say(f"serve CLI (--device {DEVICE}): ready in {t_ready:.1f}s, "
        f"SIGKILLed after {acks} acks with {journaled} journaled, the "
        f"restart replayed {journaled} and checked "
        f"{len(append_runs) - journaled}, every id journaled once, "
        f"verdicts as phase 4's; SIGTERM drained with exit 0")
    say(f"phase 16 in {time.perf_counter() - t_phase:.1f}s")
    return {"paths": paths, **out}


def phase_fleet(verdicts: dict) -> dict:
    """Phase 17: `python -m jepsen_tpu_torch.cli fleet` with
    FLEET_DAEMONS members on the one card and three tenants over phase
    4's runs by dir; tenant A's affine member is SIGKILLed once it has
    journaled A's first verdict. The members are other processes, so
    their closure_square launches are not counted here (as phase 4's
    CLI run); phase 16 shows the kernel path."""
    import threading
    from jepsen_tpu_torch.obs import events
    from jepsen_tpu_torch.serve.client import ServeClient
    from jepsen_tpu_torch.serve.fleet import load_reassignments
    from jepsen_tpu_torch.store import fleet_socket_path, shard_of, \
        tenant_journal_path

    class CountingClient(ServeClient):
        """Counts every verdict frame per id (a duplicate would show)."""

        def recv(self):
            f = super().recv()
            if f is not None and f.get("op") == "verdict":
                self.frames[f["id"]] = self.frames.get(f["id"], 0) + 1
            return f

    t_phase = time.perf_counter()
    runs = sorted(p for p in (WORK / "store" / "synth").iterdir()
                  if p.is_dir())
    third = -(-len(runs) // 3)
    shares = {"A": runs[:third], "B": runs[third:2 * third],
              "C": runs[2 * third:]}
    base = WORK / "fleet"
    base.mkdir()
    argv = [sys.executable, "-m", "jepsen_tpu_torch.cli", "fleet",
            "--store", str(base), "--daemons", str(FLEET_DAEMONS),
            "--device", DEVICE]
    procs: list = []
    results, errors, clients = {}, [], {}
    try:
        t0 = time.perf_counter()
        router, ready = start_proc(argv, "fleet", WORK / "fleet.log", procs)
        t_ready = time.perf_counter() - t0
        members = {int(k): m["pid"] for k, m in ready["members"].items()}
        GRANDCHILDREN.extend(members.values())
        check(len(members) == FLEET_DAEMONS and all(members.values()),
              f"fleet members {ready['members']}")
        victim = sorted(members)[shard_of("A", len(members))]

        def run(tenant: str, share: list) -> None:
            try:
                c = CountingClient(socket_path=fleet_socket_path(base),
                                   tenant=tenant, timeout=600)
                c.frames = {}
                c.connect(retry=True)
                for d in share:
                    c.check_dir(d, rid=d.name)
                results[tenant] = c.collect(timeout=600, reconnect=True)
                clients[tenant] = c
                c.close()
            except Exception as e:    # noqa: BLE001 (reported below)
                errors.append(f"tenant {tenant}: {e!r}")

        t1 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(t, s))
                   for t, s in shares.items()]
        for t in threads:
            t.start()
        ja = tenant_journal_path(base, "A")
        deadline = time.monotonic() + 300
        while not (ja.exists() and ja.read_text().count("\n") >= 1):
            check(time.monotonic() < deadline,
                  "tenant A's member journaled nothing")
            time.sleep(0.005)
        os.kill(members[victim], signal.SIGKILL)
        t_kill = time.perf_counter() - t1
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        check(not errors and len(results) == len(shares),
              f"fleet tenants failed: {errors}")
        router.send_signal(signal.SIGTERM)
        rc = router.wait(timeout=300)
    finally:
        end_procs(procs)
    check(rc == 0, f"the router's SIGTERM exit {rc}")
    for t, share in shares.items():
        ids = {d.name for d in share}
        check(set(results[t]) == ids, f"fleet tenant {t}: ids")
        check(clients[t].frames == {i: 1 for i in ids},
              f"fleet tenant {t}: verdict frames per id "
              f"{clients[t].frames}")
        for d in share:
            same_as_phase(verdicts, "append", d, results[t][d.name],
                          f"fleet tenant {t}")
        counts = journal_counts(base, t)
        check(counts == {i: 1 for i in ids},
              f"fleet tenant {t}: journal lines per id {counts}")
    moves = load_reassignments(base)
    check(any(m["dead"] == victim and m["tenant"] == "A" for m in moves),
          f"fleet-reassign.jsonl does not record A's move: {moves}")
    deadline = time.monotonic() + 10
    while any(alive(p) for p in members.values()):
        check(time.monotonic() < deadline,
              f"fleet members left running: {members}")
        time.sleep(0.05)
    failover = [e for e in events.load_events(base)
                if e.get("event") == "fleet_failover"]
    n = sum(len(r) for r in results.values())
    say(f"fleet: {FLEET_DAEMONS} members ready in {t_ready:.1f}s; tenant "
        f"A's member d{victim} SIGKILLed {t_kill:.3f}s into the stream; "
        f"{n} verdicts in {wall:.3f}s ({n / wall:.3f} verdicts/s), each "
        f"once and equal to phase 4's; reassign {moves}; failover "
        f"{[e.get('ms') for e in failover]} ms; the router's SIGTERM "
        f"exit 0, every member reaped (launches not counted here: the "
        f"members are other processes)")
    say(f"phase 17 in {time.perf_counter() - t_phase:.1f}s")
    return {"wall": wall, "verdicts": n, "verdicts_per_s": n / wall,
            "moves": moves, "victim": victim, "t_kill": t_kill,
            "failover_ms": [e.get("ms") for e in failover]}



def mesh_store(src: Path, dst: Path, sidecars: bool) -> None:
    """A copy of the first MESH_RUNS histories of a synth store (with
    their encoded sidecars when `sidecars`): no results, markers,
    journals or telemetry."""
    for run in sorted((src / "synth").iterdir())[:MESH_RUNS]:
        d = dst / "synth" / run.name
        d.mkdir(parents=True)
        for f in run.iterdir():
            if f.name == "history.jsonl" or (
                    sidecars and f.name.startswith(".encoded")):
                shutil.copy2(f, d / f.name)


def start_shard(store: Path, k: int, log: Path, *args, cwd: Path = ROOT,
                **env) -> subprocess.Popen:
    """Shard k of a MESH_SHARDS-shard `analyze-store --mesh --device
    cuda` (the CLI's own __main__ under RESUME_CMD, which reports its
    closure_square launches on stderr at exit), in a process group of
    its own: killing the group kills its ingest workers too, as a
    host's death would. Its pid goes to GRANDCHILDREN."""
    e = {**os.environ, "JEPSEN_TPU_MESH_SHARDS": str(MESH_SHARDS),
         "JEPSEN_TPU_MESH_SHARD": str(k),
         **{g: str(v) for g, v in env.items()}}
    for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        e.pop(v, None)
    proc = subprocess.Popen(
        [sys.executable, "-c", RESUME_CMD, "analyze-store", "--store",
         str(store), "--mesh", "--device", DEVICE, *args],
        cwd=cwd, env=e, stdout=subprocess.PIPE, stderr=open(log, "w"),
        text=True, start_new_session=True)
    GRANDCHILDREN.append(proc.pid)
    return proc


def end_shard(proc: subprocess.Popen, log: Path, what: str) -> dict:
    """Wait for a shard; returns its exit code, stdout JSON lines, the
    CLI's own sweep seconds and its closure_square launches and device
    milliseconds."""
    out, _ = proc.communicate(timeout=600)
    err = log.read_text()
    rep = [ln for ln in err.splitlines()
           if ln.startswith("chip_smoke-launches ")]
    check(len(rep) == 1, f"{what} reported no launches (exit "
                         f"{proc.returncode}): {err[-3000:]}")
    swept = [float(ln.split()[1].rstrip("s")) for ln in err.splitlines()
             if ln.startswith("analyze-store: ")]
    return {"rc": proc.returncode, "err": err,
            "lines": [json.loads(ln) for ln in out.splitlines()
                      if ln.startswith("{")],
            "swept": swept[-1] if swept else None,
            **json.loads(rep[0].split(" ", 1)[1])}


def kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL a shard's process group; check none of it is left 2 s on."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=60)
    deadline = time.monotonic() + 2
    while group_alive(proc.pid):
        check(time.monotonic() < deadline,
              f"shard {proc.pid}'s group outlived it: "
              f"{group_alive(proc.pid)}")
        time.sleep(0.05)


def group_alive(pgid: int) -> list[int]:
    """The live (not zombie) processes of process group `pgid`."""
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            stat = Path(f"/proc/{p}/stat").read_text()
        except OSError:
            continue
        state, _ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == pgid and state != "Z":
            out.append(int(p))
    return out


def mesh_summary(res: dict, what: str) -> dict:
    got = [e for e in res["lines"] if e.get("mesh") is True]
    check(len(got) == 1, f"{what}: no mesh summary line: "
                         f"{res['err'][-3000:]}")
    return got[0]


def own_worst(lines: list) -> int:
    """A shard's own exit code: the worst validity of its verdict lines."""
    return max((0 if e["valid?"] is True else 1 if e["valid?"] is False
                else 2) for e in lines if "dir" in e)


def shard_keys(lines: list) -> list[str]:
    """The run keys (`synth/run-NNNNN`) of a shard's verdict lines."""
    return sorted("/".join(Path(e["dir"]).parts[-2:]) for e in lines
                  if "dir" in e)


def journal_keys(store: Path, k: int) -> list[str]:
    """The runs of shard k's journal's whole lines (a torn tail skipped)."""
    from jepsen_tpu_torch.mesh import shard_journal_path
    keys = []
    for ln in shard_journal_path(store, k).read_text().splitlines():
        with contextlib.suppress(json.JSONDecodeError):
            keys.append(json.loads(ln)["dir"])
    return keys


def same_results(store: Path, verdicts: dict, what: str) -> None:
    """Every run's results.json/.edn byte-identical to phase 4's, and a
    run of phase 18's share of phase 4's store has them."""
    got = run_files(store)
    want = {f: b for f, b in verdicts["append"].items()
            if (store / f).parent.is_dir()}
    check(got.keys() == want.keys() and len(got) == 2 * MESH_RUNS,
          f"{what}: results files {sorted(set(got) ^ set(want))}")
    for f, b in got.items():
        check(b == want[f], f"{what}: {f} differs from phase 4's")


def phase_mesh(verdicts: dict, name: str, smi: str) -> dict:
    """Phase 18: `analyze-store --mesh`, two shard processes sharing the
    card over a copy of phase 4's store. Returns the paths' closure_square
    (launches, device ms) and the numbers PERF.md reads."""
    from jepsen_tpu_torch import supervisor
    from jepsen_tpu_torch.mesh import shard_journal_path
    from jepsen_tpu_torch.store import load_costdb, shard_of

    t_phase = time.perf_counter()
    runs = sorted(f"synth/{p.name}"
                  for p in (WORK / "store" / "synth").iterdir())[:MESH_RUNS]
    mine = {k: [r for r in runs if shard_of(r, MESH_SHARDS) == k]
            for k in range(MESH_SHARDS)}
    check(all(mine.values()), f"degenerate split {mine}")
    base = WORK / "mesh"
    paths, out = {}, {}

    # (a) both shards at once, cold, from this checkout
    store = base / "a"
    mesh_store(WORK / "store", store, sidecars=False)
    gates = {"JEPSEN_TPU_COSTDB": 1, "JEPSEN_TPU_MESH_WAIT_S": MESH_WAIT_S}
    t0 = time.perf_counter()
    procs = [start_shard(store, k, base / f"a{k}.log", "--report", **gates)
             for k in range(MESH_SHARDS)]
    res = [end_shard(p, base / f"a{k}.log", f"shard {k}")
           for k, p in enumerate(procs)]
    wall = time.perf_counter() - t0
    for k, r in enumerate(res):
        own = own_worst(r["lines"])
        check(shard_keys(r["lines"]) == mine[k],
              f"shard {k} verdicted {shard_keys(r['lines'])}")
        check(r["launches"] > 0, f"shard {k} launched no closure_square")
        # the coordinator's is the merged code: 8 runs carry G1c
        check(r["rc"] == (1 if k == 0 else own),
              f"shard {k} exited {r['rc']} (its own worst {own})")
        check(sorted(journal_keys(store, k)) == mine[k],
              f"shard {k}'s journal holds other runs than its own")
        paths[f"mesh-shard{k}"] = (r["launches"], r["device_ms"])
    s = mesh_summary(res[0], "the coordinator")
    check(s["runs_verdicted"] == MESH_RUNS
          and s["invalid"] == MESH_RUNS // BAD_EVERY
          and s["unaccounted"] == 0 and not s["lost_shards"],
          f"mesh summary {s}")
    same_results(store, verdicts, "mesh (a)")
    for k in range(MESH_SHARDS):
        recs = load_costdb(store / f"costdb-shard{k}.jsonl")
        check(any(r["formulation"] == "cuda-int8"
                  and r["windows"]["dispatches"] > 0 for r in recs),
              f"shard {k}'s costdb holds no closure_square dispatch")
    merged = check_costdb(store, name, "mesh (a)")
    per_shard = sum(r["windows"]["dispatches"] for k in range(MESH_SHARDS)
                    for r in load_costdb(store / f"costdb-shard{k}.jsonl"))
    check(sum(r["windows"]["dispatches"] for r in merged) == per_shard,
          "the merged costdb lost dispatches of a shard")
    rep = json.loads((store / "report.json").read_text())
    check(sorted(rep.get("per_shard", {})) == ["0", "1"],
          f"report.json per_shard {sorted(rep.get('per_shard', {}))}")
    buckets = [json.loads((store / f"metrics-shard{k}.json").read_text())[
        "counters"]["buckets_dispatched"] for k in range(MESH_SHARDS)]
    buckets_a1 = buckets[1]
    say(f"mesh (a): 2 shards at once on the card ({smi}): {wall:.3f}s "
        f"wall from both starts to both exits (phase 4's one process, in "
        f"process: {MAIN_WALL.get('wall', float('nan')):.3f}s); each "
        f"shard's own sweep {[r['swept'] for r in res]}s; runs "
        f"{[len(m) for m in mine.values()]}; closure_square launches "
        f"{[r['launches'] for r in res]}, device ms "
        f"{[round(r['device_ms'], 3) for r in res]}; buckets {buckets}; "
        f"summary {s}; results byte-identical to phase 4's; merged "
        f"costdb {len(merged)} record(s), {per_shard} dispatches")
    out["a"] = {"wall": wall, "swept": [r["swept"] for r in res],
                "launches": [r["launches"] for r in res],
                "device_ms": [r["device_ms"] for r in res],
                "runs": [len(m) for m in mine.values()],
                "buckets": buckets,
                "per_shard": {k: v.get("shares")
                              for k, v in rep["per_shard"].items()}}

    # (b) shard 1 killed once it has journaled two runs (one run fewer
    # can leave its buckets of two, and so its launches, as they were);
    # shard 0 alone finds it lost; shard 1 re-assigned with --resume;
    # shard 0 resumes and merges the complete fleet
    store = base / "b"
    mesh_store(base / "a", store, sidecars=True)
    jp = shard_journal_path(store, 1)
    p1 = start_shard(store, 1, base / "b1.log")
    deadline = time.monotonic() + 300
    while (jp.read_bytes().count(b"\n") if jp.exists() else 0) < 2 \
            and p1.poll() is None:
        check(time.monotonic() < deadline, "shard 1 journaled nothing")
        time.sleep(0.001)
    kill_group(p1)
    cut = journal_keys(store, 1)
    check(0 < len(cut) < len(mine[1])
          and not supervisor.shard_done_path(store, 1).exists(),
          f"the kill did not cut shard 1 ({len(cut)} of {len(mine[1])} "
          "journaled)")
    r0 = end_shard(start_shard(store, 0, base / "b0.log",
                               JEPSEN_TPU_MESH_WAIT_S=0),
                   base / "b0.log", "shard 0 alone")
    s = mesh_summary(r0, "shard 0 alone")
    check(r0["rc"] == 2 and s["lost_shards"] == [1] and r0["launches"] > 0,
          f"shard 0 alone exited {r0['rc']}: {s}")
    paths["mesh-lost-shard0"] = (r0["launches"], r0["device_ms"])
    # journal-only evidence: the kill may land between a run's marker
    # and its journal line
    for key in mine[1]:
        for f in ("results.json", ".sweep-append"):
            (store / key / f).unlink(missing_ok=True)
    r1 = end_shard(start_shard(store, 1, base / "b1r.log", "--resume"),
                   base / "b1r.log", "shard 1 --resume")
    buckets_r1 = json.loads((store / "metrics-shard1.json").read_text())[
        "counters"]["buckets_dispatched"]
    check(shard_keys(r1["lines"]) == sorted(set(mine[1]) - set(cut))
          and r1["rc"] in (0, 1) and 0 < r1["launches"] < res[1]["launches"]
          and buckets_r1 <= buckets_a1,
          f"shard 1 --resume re-checked {len(r1['lines'])} runs with "
          f"{r1['launches']} launches and {buckets_r1} buckets "
          f"(the whole shard: {len(mine[1])}, {res[1]['launches']}, "
          f"{buckets_a1}; journaled at the kill: {len(cut)})")
    paths["mesh-resume-shard1"] = (r1["launches"], r1["device_ms"])
    rc = end_shard(start_shard(store, 0, base / "b0r.log", "--resume",
                               "--report", JEPSEN_TPU_MESH_WAIT_S=0),
                   base / "b0r.log", "shard 0 --resume")
    s = mesh_summary(rc, "shard 0 --resume")
    check(rc["rc"] == 1 and s["runs_verdicted"] == MESH_RUNS
          and s["unaccounted"] == 0 and not s["lost_shards"]
          and not s["incomplete_shards"] and rc["launches"] == 0,
          f"shard 0 --resume exited {rc['rc']}: {s}")
    for k in range(MESH_SHARDS):
        got = journal_keys(store, k)
        check(sorted(got) == mine[k], f"shard {k}'s journal after the "
                                      f"resume: {len(got)} lines")
    check(sorted(json.loads((store / "report.json").read_text())[
        "per_shard"]) == ["0", "1"], "(b) report.json per_shard")
    say(f"mesh (b): shard 1 killed with {len(cut)} of {len(mine[1])} runs "
        f"journaled; shard 0 alone exit 2, shard 1 lost "
        f"({r0['launches']} launches); shard 1 --resume re-checked "
        f"{len(r1['lines'])} runs, {r1['launches']} launches "
        f"({r1['device_ms']:.3f} ms), {buckets_r1} buckets (the whole "
        f"shard: {res[1]['launches']}, {buckets_a1}); shard 0 --resume "
        f"merged {s['runs_verdicted']} runs, exit 1")
    out["b"] = {"journaled_at_kill": len(cut),
                "resume_runs": len(r1["lines"]),
                "resume_launches": r1["launches"],
                "resume_buckets": buckets_r1, "whole_buckets": buckets_a1}

    # (c) the pair again from a copy of the package with nothing built:
    # both shards' first builds race, and each must load a working .so
    fresh = base / "fresh"
    shutil.copytree(ROOT / "jepsen_tpu_torch", fresh / "jepsen_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    built = fresh / "jepsen_tpu_torch" / "_build"
    store = base / "c"
    mesh_store(base / "a", store, sidecars=True)
    t0 = time.perf_counter()
    procs = [start_shard(store, k, base / f"c{k}.log", cwd=fresh,
                         PYTHONPATH=fresh,
                         JEPSEN_TPU_MESH_WAIT_S=MESH_WAIT_S)
             for k in range(MESH_SHARDS)]
    res_c = [end_shard(p, base / f"c{k}.log", f"fresh shard {k}")
             for k, p in enumerate(procs)]
    wall_c = time.perf_counter() - t0
    for k, r in enumerate(res_c):
        check(r["launches"] > 0
              and r["rc"] == (1 if k == 0 else own_worst(r["lines"]))
              and shard_keys(r["lines"]) == mine[k],
              f"fresh shard {k} exited {r['rc']}, {r['launches']} launches")
        paths[f"mesh-fresh-shard{k}"] = (r["launches"], r["device_ms"])
    same_results(store, verdicts, "mesh (c)")
    libs = sorted(p.name for p in built.iterdir())
    check(len([n for n in libs if n.startswith("closure_square-")
               and n.endswith(".so")]) == 1
          and not any(".tmp." in n for n in libs),
          f"the fresh build dir holds {libs}")
    say(f"mesh (c): the pair from a copy with an empty _build/: "
        f"{wall_c:.3f}s wall, the first builds raced and left {libs}; "
        f"launches {[r['launches'] for r in res_c]}, results as phase 4's")
    out["c"] = {"wall": wall_c, "libs": libs}
    shutil.rmtree(fresh, ignore_errors=True)
    deadline = time.monotonic() + 2
    while any(alive(p) for p in GRANDCHILDREN):
        check(time.monotonic() < deadline, "mesh shards left running: "
              f"{[p for p in GRANDCHILDREN if alive(p)]}")
        time.sleep(0.05)
    say(f"phase 18 in {time.perf_counter() - t_phase:.1f}s")
    return {"paths": paths, **out}

#: Phase 19: BASELINE config #2 (one list-append history of 10,000 txns
#: at the suites' append defaults) and config #1 (register.test() at its
#: defaults: 2 threads a key, 10 keys, 100 ops a key), run by `test` at
#: concurrency 10; the broken list store's history is 2,000 txns, its
#: reads seeing a snapshot of the lists taken every TEST_STALE_EVERY
#: txns.
TEST_TXNS, TEST_BROKEN_TXNS, TEST_CONC, TEST_STALE_EVERY = \
    10_000, 2_000, 10, 10


def harness_clients():
    """The in-process stores phase 19's tests run against: a list store
    (serializable, or with stale snapshot reads) and CAS registers one a
    key (workloads.AtomRegister, nil at first as the model's register
    is, with AtomClient's 1 ms window)."""
    import threading
    from jepsen_tpu_torch import client as jclient, independent, workloads

    def list_client(stale_every: int = 0):
        lists: dict = {}
        snap: dict = {}
        lock = threading.Lock()
        count = [0]

        class ListClient(jclient.Client):
            def invoke(self, test, op):
                out = []
                with lock:
                    count[0] += 1
                    if stale_every and count[0] % stale_every == 1:
                        snap.clear()
                        snap.update({k: list(v) for k, v in lists.items()})
                    view = snap if stale_every else lists
                    for mf, k, v in op["value"]:
                        if mf == "append":
                            lists.setdefault(k, []).append(v)
                            out.append([mf, k, v])
                        else:
                            out.append(["r", k, list(view.get(k, []))])
                return {**op, "type": "ok", "value": out}

        return ListClient()

    def register_client():
        regs: dict = {}
        lock = threading.Lock()

        def reg(k):
            with lock:
                return regs.setdefault(k, workloads.AtomRegister(None))

        class KeyedAtomClient(jclient.Client):
            def invoke(self, test, op):
                time.sleep(0.001)
                k, v = op["value"]
                r = reg(k)
                if op["f"] == "read":
                    return {**op, "type": "ok",
                            "value": independent.tuple_(k, r.read())}
                if op["f"] == "write":
                    r.write(v)
                    return {**op, "type": "ok"}
                return {**op, "type": "ok" if r.cas(*v) else "fail"}

        return KeyedAtomClient()

    return list_client, register_client


def workers_ended(what: str) -> None:
    """Fails if an interpreter worker thread outlived its test."""
    import threading
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("jepsen-worker-")]
    check(not left, f"{what}: interpreter workers left: {left}")


def per_key(res: dict) -> dict:
    """{key: valid?} of an independent checker's results."""
    return {str(k): r["valid?"] for k, r in res["results"].items()}


def span_secs(run: Path) -> dict:
    """Seconds of the run's "generator.run" and "analyze" trace spans
    (its trace.json)."""
    evs = json.loads((run / "trace.json").read_text())["traceEvents"]
    out = {}
    for e in evs:
        if e.get("ph") == "X" and e["name"] in ("generator.run", "analyze"):
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    check(set(out) == {"generator.run", "analyze"},
          f"{run}: trace.json lacks a span: {sorted(out)}")
    return out


def phase_test(smi: str) -> dict:
    """Phase 19: `test` and `test-all` through `run_cli`, as a suite's
    main calls it: the generator, the interpreter's worker threads, the
    dummy remote, the nemesis, the store, then the checker on the card.
    Returns per kernel, per path (launches, device ms)."""
    from jepsen_tpu_torch import cli, generator as gen, net
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.workloads import append, register

    t_phase = time.perf_counter()
    base = WORK / "test"
    list_client, register_client = harness_clients()
    cs_paths, dense_paths = {}, {}

    def append_fn(name: str, n: int, stale: int = 0, log=None):
        def test_fn(t, args):
            wl = append.test(device=DEVICE, bucket_log=log)
            return {**t, "name": name, "net": net.noop(),
                    "client": list_client(stale),
                    "generator": gen.limit(n, wl["generator"]),
                    "checker": wl["checker"]}
        return test_fn

    def register_fn(t, args):
        wl = register.test(device=DEVICE)
        return {**t, "name": "test-register", "net": net.noop(),
                "client": register_client(), "generator": wl["generator"],
                "checker": wl["checker"]}

    def run(test_fn, store: Path, command: str = "test", **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.run_cli(test_fn, argv=[
                command, "--dummy", "--store", str(store),
                "--concurrency", str(TEST_CONC)], **kw)
        torch.cuda.synchronize()
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        return rc, lines

    def recheck(line: dict, dst: str, checker, argv=()) -> dict:
        """`analyze` of a copy of the test's run dir with `checker`;
        returns the copy's results.json bytes and parse."""
        run = Path(line["dir"])
        store = base / dst
        copy = store / run.parent.name / run.name
        shutil.copytree(run, copy)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.run_cli(lambda t, a: {**t, "checker": checker},
                             argv=["analyze", str(copy), "--store",
                                   str(store), *argv])
        torch.cuda.synchronize()
        raw = (copy / "results.json").read_bytes()
        return {"rc": rc, "raw": raw, "res": json.loads(raw)}

    # (a) config #2: one list-append history of 10,000 txns
    log: list = []
    (rc, lines), n, ms = counted(lambda: run(
        append_fn("test-append", TEST_TXNS, log=log), base / "a"))
    workers_ended("test-append")
    check(rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True,
          f"test-append: rc {rc}, {lines}")
    run_a = Path(lines[0]["dir"])
    hist = (run_a / "history.jsonl").read_text().splitlines()
    txns = sum(1 for ln in hist if '"type": "invoke"' in ln)
    check(txns == TEST_TXNS, f"test-append: {txns} txns in the history")
    active, skipped = launch_split(log, n)
    t_pads = sorted({b["t_pad"] for b in log})
    check(n > 0, "test-append launched no closure_square")
    res_a = json.loads((run_a / "results.json").read_text())
    plain = {}
    _, relaunched, _ = counted(lambda: plain.update(recheck(
        lines[0], "a-plain", append.checker(
            device=DEVICE, square=cs.closure_square_ref))))
    check(relaunched == 0 and plain["rc"] == 0,
          f"the plain re-check: rc {plain['rc']}, {relaunched} launches")
    check(plain["raw"] == (run_a / "results.json").read_bytes(),
          "test-append: the plain squaring's results.json differs")
    secs = span_secs(run_a)
    cs_paths["test-append"] = (n, ms)
    say(f"test-append (BASELINE config #2: {TEST_TXNS} txns at "
        f"concurrency {TEST_CONC}, {len(hist)} ops): valid, "
        f"generator.run {secs['generator.run']:.3f}s, analyze "
        f"{secs['analyze']:.3f}s; {n} closure_square launches ({active} "
        f"active, {skipped} skipped; T_pad {t_pads}) taking {ms} ms of "
        f"device time ({smi}); results.json byte-identical to the plain "
        f"squaring's; txn-count {res_a.get('txn-count')}")

    # (b) the broken list store: stale snapshot reads
    (rc, lines), n, ms = counted(lambda: run(
        append_fn("test-append-broken", TEST_BROKEN_TXNS,
                  stale=TEST_STALE_EVERY), base / "b"))
    workers_ended("test-append-broken")
    check(rc == 1 and len(lines) == 1 and lines[0]["valid?"] is False,
          f"test-append-broken: rc {rc}, {lines}")
    run_b = Path(lines[0]["dir"])
    res_b = json.loads((run_b / "results.json").read_text())
    host = {}
    _, relaunched, _ = counted(lambda: host.update(recheck(
        lines[0], "b-host", append.checker(), argv=["--backend", "cpu"])))
    check(relaunched == 0 and host["rc"] == 1,
          f"the host oracle: rc {host['rc']}, {relaunched} launches")
    check(res_b["anomaly-types"] == host["res"]["anomaly-types"],
          f"test-append-broken: {res_b['anomaly-types']} on the card, "
          f"{host['res']['anomaly-types']} from the host oracle")
    check(n > 0, "test-append-broken launched no closure_square")
    secs_b = span_secs(run_b)
    cs_paths["test-append-broken"] = (n, ms)
    say(f"test-append-broken ({TEST_BROKEN_TXNS} txns, reads of a "
        f"snapshot every {TEST_STALE_EVERY} txns): invalid with "
        f"{res_b['anomaly-types']}, as the host oracle's; generator.run "
        f"{secs_b['generator.run']:.3f}s, analyze {secs_b['analyze']:.3f}s;"
        f" {n} closure_square launches taking {ms} ms of device time")

    # (c) config #1: register.test() at its defaults
    (rc, lines), n, ms = counted_dense(lambda: run(register_fn, base / "c"))
    workers_ended("test-register")
    check(rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True,
          f"test-register: rc {rc}, {lines}")
    run_c = Path(lines[0]["dir"])
    res_c = json.loads((run_c / "results.json").read_text())
    ops = sum(1 for ln in (run_c / "history.jsonl").read_text().splitlines()
              if '"type": "invoke"' in ln)
    check(ops == 1000, f"test-register: {ops} ops, not config #1's 1,000")
    check(n > 0, "test-register launched no knossos_dense_scan")
    wgl = {}
    _, relaunched, _ = counted_dense(lambda: wgl.update(recheck(
        lines[0], "c-host", register.checker(), argv=["--backend", "cpu"])))
    check(relaunched == 0, "the CPU WGL re-check launched")

    check(per_key(res_c) == per_key(wgl["res"]) and len(per_key(res_c))
          == 10, f"test-register: per-key verdicts {per_key(res_c)} vs "
          f"the CPU WGL's {per_key(wgl['res'])}")
    secs_c = span_secs(run_c)
    dense_paths["test-register"] = (n, ms)
    say(f"test-register (BASELINE config #1: 10 keys x 100 ops, 2 threads "
        f"a key, concurrency {TEST_CONC}): valid, every key's verdict as "
        f"the CPU WGL's; generator.run "
        f"{secs_c['generator.run']:.3f}s, analyze {secs_c['analyze']:.3f}s;"
        f" {n} knossos_dense_scan launches taking {ms} ms of device time "
        f"({smi})")

    # (d) test-all over the three tests: the worst code, a line each
    def tests_fn(t, args):
        return [append_fn("test-append", TEST_TXNS)(dict(t), args),
                append_fn("test-append-broken", TEST_BROKEN_TXNS,
                          stale=TEST_STALE_EVERY)(dict(t), args),
                register_fn(dict(t), args)]
    ((rc, lines), n_d, ms_d), n, ms = counted(lambda: counted_dense(
        lambda: run(None, base / "d", "test-all", tests_fn=tests_fn)))
    workers_ended("test-all")
    check(rc == 1 and [ln.get("name") for ln in lines] == [
        "test-append", "test-append-broken", "test-register"],
        f"test-all: rc {rc}, {lines}")
    check([ln["valid?"] for ln in lines] == [True, False, True],
          f"test-all verdicts: {lines}")
    check(n > 0 and n_d > 0, f"test-all: {n} closure_square and {n_d} "
          "knossos_dense_scan launches")
    cs_paths["test-all"] = (n, ms)
    dense_paths["test-all"] = (n_d, ms_d)
    say(f"test-all over the three tests: exit 1, one line each; {n} "
        f"closure_square launches ({ms} ms) and {n_d} knossos_dense_scan "
        f"launches ({ms_d} ms) of device time ({smi})")
    say(f"phase 19 in {time.perf_counter() - t_phase:.1f}s")
    return {"closure_square": cs_paths, "knossos_dense_scan": dense_paths}


#: Phase 20: the suites against tests/fake_sql.py's in-process servers,
#: through each suite's `run_cli` as its main calls it: (a) tidb append
#: (BASELINE config #4's suite and workload) under every fault family,
#: (b) cockroach register (config #3's suite) under partitions and clock
#: faults, (c) cockroach `test-all` over its seven workloads. Time limits
#: (s), the nemesis interval (s: the suites' default is 10, which a short
#: run never reaches) and the concurrency.
SUITE_LIMIT, SUITE_ALL_LIMIT, SUITE_INTERVAL, SUITE_CONC = 8, 3, 1, 10
SUITE_A_FAULTS, SUITE_B_FAULTS = "partition,kill,pause,clock", \
    "partition,clock"
#: The nemesis ops of each fault family (nemesis.combined's packages).
FAMILY_FS = {"partition": ("start-partition", "stop-partition"),
             "kill": ("start-kill", "stop-kill"),
             "pause": ("start-pause", "stop-pause"),
             "clock": ("bump", "strobe", "reset")}


def load_fake(name: str):
    """`tests/<name>.py` (standard library only), loaded by its path and
    registered under its name (tests/fake_cql.py imports fake_sql by
    name); fails if loading it imported anything of the JAX package."""
    import importlib.util
    if name in sys.modules:
        return sys.modules[name]
    before = set(sys.modules)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    new = sorted(m for m in set(sys.modules) - before
                 if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
    check(not new, f"loading tests/{name}.py imported {new}")
    return mod


#: The results entries that draw plots with matplotlib: `perf` (the
#: latency and rate graphs) and bank's balance `plot`.
PLOT_ENTRIES = {"perf": ("latency-raw.png", "latency-quantiles.png",
                         "rate.png"),
                "plot": ("bank.png",)}


def has_matplotlib() -> bool:
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def plots_as_expected(res: dict, run: Path, what: str) -> None:
    """Each plot entry of a results map: `{"valid?": true}` with its PNGs
    in the run dir where matplotlib is installed; where it is not,
    `"unknown"` with an error naming it (the reference's `check_safe`
    on a failed import), the whole verdict then at most unknown."""
    for key, pngs in PLOT_ENTRIES.items():
        if key not in res:
            continue
        entry = res[key]
        if has_matplotlib():
            check(entry.get("valid?") is True and all(
                (run / f).is_file() for f in pngs),
                f"{what}: the {key} entry {entry} or its files {pngs}")
            continue
        errors = [e.get("error") for e in [entry, *entry.values()]
                  if isinstance(e, dict) and e.get("error")]
        check(entry.get("valid?") == "unknown" and errors
              and all("matplotlib" in e for e in errors)
              and res["valid?"] in ("unknown", False),
              f"{what}: without matplotlib the {key} entry is "
              f"{str(entry)[:300]}, the verdict {res['valid?']}")


def verdict_tree(x):
    """The verdicts of a results map: every "valid?" and
    "anomaly-types", by path (dicts without one dropped)."""
    if not isinstance(x, dict):
        return x
    out = {}
    for k, v in x.items():
        if k in ("valid?", "anomaly-types"):
            out[k] = v
        elif isinstance(v, dict) and verdict_tree(v):
            out[k] = verdict_tree(v)
    return out


def same_entries(res: dict, host: dict, what: str,
                 device: bool = False) -> None:
    """Each entry but the plots as the host oracle's: equal where a host
    checker made it; where a kernel did (`device`), its verdicts (every
    valid? and anomaly-types, per key too)."""
    a = {k: v for k, v in res.items() if k not in PLOT_ENTRIES}
    b = {k: v for k, v in host.items() if k not in PLOT_ENTRIES}
    if device:
        a, b = verdict_tree(a), verdict_tree(b)
    a.pop("valid?", None)
    b.pop("valid?", None)
    check(a == b, f"{what}: the entries {str(a)[:400]} differ from the "
                  f"host oracle's {str(b)[:400]}")


def phase_suites(smi: str) -> dict:
    """Phase 20: the `cockroach` and `tidb` suites, each driven through
    its `run_cli` with the argv a user gives its main (`test --dummy
    --faults ...`), against the fake SQL servers, with the nemesis: the
    suite layer, the combined fault bundle, the SQL wire drivers, then
    the checkers on the card. The test_fn adds the fakes' hosts, the
    time limit and the nemesis interval; the built map then loses db
    and os (the fakes have no daemons; the fault package still holds the
    suite's DB), gets the iptables net (with --dummy the default net
    records no command) and a DummyRemote (what --dummy makes) this
    phase reads. Returns per kernel, per path (launches, device ms)."""
    import threading
    from jepsen_tpu_torch import cli, control, net
    from jepsen_tpu_torch.suites import cockroach, resolve_workload, tidb

    t_phase = time.perf_counter()
    fake_sql = load_fake("fake_sql")
    base = WORK / "suites"
    dev_args = [] if DEVICE == "cuda" else ["--device", DEVICE]
    native = (ROOT / "jepsen_tpu_torch" / "native").resolve()
    threads_before = set(threading.enumerate())
    cs_paths, dense_paths = {}, {}

    def run(suite, srv, argv: list, limit: float) -> tuple:
        """The suite's main's run_cli call; returns (exit code, JSON
        lines, the dummy remote)."""
        mod = cockroach if suite == "cockroach" else tidb
        make = cockroach.cockroach_test if suite == "cockroach" \
            else tidb.tidb_test
        default = "register" if suite == "cockroach" else "append"
        remote = control.DummyRemote()
        extra = {"db-hosts": {n: ("127.0.0.1", srv.port) for n in
                              ("n1", "n2", "n3", "n4", "n5")},
                 "time-limit": limit, "nemesis-interval": SUITE_INTERVAL}

        def on_the_fakes(t):
            t.pop("db", None)
            t.pop("os", None)
            t["net"] = net.iptables()
            t["remote"] = remote
            return t

        def test_fn(tmap, args):
            return on_the_fakes(make({**tmap, **extra, "workload":
                                      resolve_workload(args, tmap,
                                                       default)}))

        def tests_fn(tmap, args):
            return [on_the_fakes(make({**tmap, **extra, "workload": w}))
                    for w in sorted(mod.workloads())]

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.run_cli(
                test_fn, name=suite, tests_fn=tests_fn,
                opt_fn=lambda p: p.add_argument(
                    "--workload", default=None,
                    choices=sorted(mod.workloads())),
                argv=[*argv, "--dummy", *dev_args, "--concurrency",
                      str(SUITE_CONC)])
        torch.cuda.synchronize()
        return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                    if ln.startswith("{")], remote

    def recheck(run: Path, suite: str, workload: str) -> dict:
        """`analyze --backend cpu` (the host oracles) of a copy of a
        stored run with the suite's checker for its workload."""
        mod = cockroach if suite == "cockroach" else tidb
        store = base / "host"
        copy = store / run.parent.name / run.name
        shutil.copytree(run, copy)
        check_ = mod.workloads({})[workload]()["checker"]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.run_cli(lambda t, a: {**t, "checker": check_},
                             argv=["analyze", str(copy), "--store",
                                   str(store), "--backend", "cpu"])
        return {"rc": rc,
                "res": json.loads((copy / "results.json").read_text())}

    def nemesis_fs(run: Path) -> dict:
        out: dict = {}
        for ln in (run / "history.jsonl").read_text().splitlines():
            o = json.loads(ln)
            if o["process"] == "nemesis" and o["type"] == "info":
                out[o["f"]] = out.get(o["f"], 0) + 1
        return out

    # (a) tidb append under every fault family
    srv = fake_sql.FakeMySQLServer()
    try:
        (rc, lines, remote), n, ms = counted(lambda: run(
            "tidb", srv, ["test", "--faults", SUITE_A_FAULTS, "--store",
                          str(base / "a")], SUITE_LIMIT))
    finally:
        srv.close()
    workers_ended("suite-tidb-append")
    check(rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True,
          f"suite-tidb-append: rc {rc}, {lines}")
    run_a = Path(lines[0]["dir"])
    fs = nemesis_fs(run_a)
    for family, ops in FAMILY_FS.items():
        seen = [f for f in ops if fs.get(f)]
        want = ops if family != "clock" else ()
        check(seen and set(want) <= set(seen),
              f"suite-tidb-append: the {family} family's ops {ops} are "
              f"not all in the history's nemesis ops {fs}")
    check(fs.get("bump", 0) + fs.get("strobe", 0) > 0,
          f"suite-tidb-append: no bump or strobe in {fs}")
    cmds = [p for _n, k, p in remote.actions if k == "execute"]
    hist = [json.loads(ln) for ln in
            (run_a / "history.jsonl").read_text().splitlines()]
    clock_targets = {f: sum(len(o["value"][1]) for o in hist
                            if o["process"] == "nemesis"
                            and o["type"] == "info" and o["f"] == f
                            and isinstance(o.get("value"), list))
                     for f in ("bump", "strobe")}
    # (the helpers' build lines name their binaries too: not counted)
    n_cmd = {k: sum(k in c and "g++" not in c for c in cmds)
             for k in ("iptables -A INPUT", "/opt/jepsen/bump-time",
                       "/opt/jepsen/strobe-time", "grep /opt/tidb/bin",
                       "kill -KILL", "kill -STOP", "kill -CONT")}
    check(n_cmd["iptables -A INPUT"] > 0 and n_cmd["kill -KILL"] > 0
          and n_cmd["kill -STOP"] > 0 and n_cmd["kill -CONT"] > 0
          and n_cmd["grep /opt/tidb/bin"] == n_cmd["kill -KILL"]
          + n_cmd["kill -STOP"] + n_cmd["kill -CONT"],
          f"suite-tidb-append: the remote's commands {n_cmd}")
    check(n_cmd["/opt/jepsen/bump-time"] == clock_targets["bump"]
          and n_cmd["/opt/jepsen/strobe-time"] == clock_targets["strobe"],
          f"suite-tidb-append: clock commands {n_cmd} for the history's "
          f"targets {clock_targets}")
    ups = [p[0] for _n, k, p in remote.actions if k == "upload"]
    check(ups and all(Path(u).resolve().parent == native
                      and Path(u).name in ("bump_time.cc", "strobe_time.cc")
                      for u in ups),
          f"suite-tidb-append: uploads {sorted(set(ups))}")
    check(n > 1, f"suite-tidb-append: {n} closure_square launches")
    host = recheck(run_a, "tidb", "append")
    res_a = json.loads((run_a / "results.json").read_text())
    check((host["res"]["valid?"], host["res"].get("anomaly-types"))
          == (res_a["valid?"], res_a.get("anomaly-types"))
          and host["rc"] == rc,
          f"suite-tidb-append: the host oracle says {host}")
    secs = span_secs(run_a)
    cs_paths["suite-tidb-append"] = (n, ms)
    say(f"suite-tidb-append (tidb append, --faults {SUITE_A_FAULTS}, "
        f"{SUITE_LIMIT}s, interval {SUITE_INTERVAL}s, concurrency "
        f"{SUITE_CONC}, FakeMySQLServer): valid as the host oracle's, "
        f"txn-count {res_a.get('txn-count')}; nemesis ops {fs}; remote "
        f"{n_cmd}, {len(ups)} helper uploads; generator.run "
        f"{secs['generator.run']:.3f}s, analyze {secs['analyze']:.3f}s; "
        f"{n} closure_square launches taking {ms} ms of device time "
        f"({smi})")

    # (b) cockroach register under partitions and clock faults
    srv = fake_sql.FakePGServer()
    try:
        (rc, lines, remote), n, ms = counted_dense(lambda: run(
            "cockroach", srv, ["test", "--faults", SUITE_B_FAULTS,
                               "--store", str(base / "b")], SUITE_LIMIT))
    finally:
        srv.close()
    workers_ended("suite-cockroach-register")
    check(rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True,
          f"suite-cockroach-register: rc {rc}, {lines}")
    run_b = Path(lines[0]["dir"])
    fs_b = nemesis_fs(run_b)
    check(fs_b.get("start-partition") and set(fs_b) <= {
        *FAMILY_FS["partition"], *FAMILY_FS["clock"]},
        f"suite-cockroach-register: nemesis ops {fs_b}")
    check(n > 0, "suite-cockroach-register launched no knossos_dense_scan")
    host = recheck(run_b, "cockroach", "register")
    res_b = json.loads((run_b / "results.json").read_text())

    check(per_key(res_b) == per_key(host["res"]) and per_key(res_b),
          f"suite-cockroach-register: per-key verdicts {per_key(res_b)} "
          f"vs the CPU WGL's {per_key(host['res'])}")
    secs_b = span_secs(run_b)
    dense_paths["suite-cockroach-register"] = (n, ms)
    say(f"suite-cockroach-register (cockroach register, --faults "
        f"{SUITE_B_FAULTS}, FakePGServer): valid, {len(per_key(res_b))} "
        f"keys each as the CPU WGL's; nemesis ops {fs_b}; generator.run "
        f"{secs_b['generator.run']:.3f}s, analyze "
        f"{secs_b['analyze']:.3f}s; {n} knossos_dense_scan launches "
        f"taking {ms} ms of device time ({smi})")

    # (c) cockroach test-all over its seven workloads
    srv = fake_sql.FakePGServer()
    try:
        ((rc, lines, _), n_d, ms_d), n, ms = counted(lambda: counted_dense(
            lambda: run("cockroach", srv, ["test-all", "--store",
                                           str(base / "c")],
                        SUITE_ALL_LIMIT)))
    finally:
        srv.close()
    workers_ended("suite-test-all")
    names = sorted(cockroach.workloads())
    check([ln.get("name") for ln in lines] == [f"cockroach {w}"
                                               for w in names],
          f"suite-test-all: lines {lines}")
    codes, spans = [], {}
    for w, ln in zip(names, lines):
        run_c = Path(ln["dir"])
        res = json.loads((run_c / "results.json").read_text())
        host = recheck(run_c, "cockroach", w)
        # bank and sequential compose plots (bank's "plot", sequential's
        # "perf"): each other entry as the host oracle's, each plot
        # entry by the matplotlib rule, the whole verdict and exit code
        # from all of them
        same_entries(res, host["res"], f"suite-test-all {w}",
                     device=w == "register")
        plots_as_expected(res, run_c, f"suite-test-all {w}")
        check(res["valid?"] == host["res"]["valid?"] == ln["valid?"],
              f"suite-test-all {w}: {res['valid?']} on the card, "
              f"{host['res']['valid?']} from the host oracle")
        codes.append(cli.validity_exit_code(res))
        spans[w] = span_secs(run_c)
    check(rc == max(codes), f"suite-test-all: rc {rc}, codes {codes}")
    check(n_d > 0, "suite-test-all launched no knossos_dense_scan")
    dense_paths["suite-test-all"] = (n_d, ms_d)
    say(f"suite-test-all (cockroach test-all, {SUITE_ALL_LIMIT}s each): "
        f"exit {rc}, verdicts "
        f"{ {w: ln['valid?'] for w, ln in zip(names, lines)} } as the host "
        f"oracles'; generator.run/analyze s "
        f"{ {w: (round(s['generator.run'], 3), round(s['analyze'], 3)) for w, s in spans.items()} }; "
        f"{n_d} knossos_dense_scan launches ({ms_d} ms) and {n} "
        f"closure_square launches ({ms} ms) of device time ({smi})")

    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads_before:
        check(time.monotonic() < deadline, "phase 20: threads left: "
              f"{[t.name for t in set(threading.enumerate()) - threads_before]}")
        time.sleep(0.05)
    took = time.perf_counter() - t_phase
    check(took < 90, f"phase 20 took {took:.1f}s")
    say(f"phase 20 in {took:.1f}s")
    return {"closure_square": cs_paths, "knossos_dense_scan": dense_paths}


def suite_main(mod, make_name: str, extra: dict, argv: list,
               remote=None) -> tuple:
    """`mod.main(argv)`, a suite's own entry point (with `--dummy`, and
    `--device` unless DEVICE is cuda), with `mod.<make_name>` wrapped
    for the fakes: `extra` added to its opts, db and os dropped (the
    fakes have no daemons; a fault package keeps the suite's DB), the
    iptables net and `remote` (a fake that plays the nodes' commands;
    default a DummyRemote) set. Returns (exit code, JSON lines, the
    remote)."""
    from jepsen_tpu_torch import control, net
    if remote is None:
        remote = control.DummyRemote()
    real = getattr(mod, make_name)
    dev_args = [] if DEVICE == "cuda" else ["--device", DEVICE]

    def make(opts=None):
        t = real({**(opts or {}), **extra})
        t.pop("db", None)
        t.pop("os", None)
        t["net"] = net.iptables()
        t["remote"] = remote
        return t

    setattr(mod, make_name, make)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main([*argv, "--dummy", *dev_args])
    finally:
        setattr(mod, make_name, real)
    torch.cuda.synchronize()
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")], remote


def suite_recheck(base: Path, run_dir: Path, checker_,
                  backend: str = "cpu") -> dict:
    """`analyze` (`--backend cpu`: the host oracles; "device": the
    checker's own device) of a copy of a stored run under
    `base/host-<backend>` with the suite's checker."""
    from jepsen_tpu_torch import cli
    store = base / f"host-{backend}"
    copy_ = store / run_dir.parent.name / run_dir.name
    shutil.copytree(run_dir, copy_)
    argv = ["analyze", str(copy_), "--store", str(store)]
    if backend != "device":
        argv += ["--backend", backend]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.run_cli(lambda t, a: {**t, "checker": checker_},
                         argv=argv)
    return {"rc": rc, "dir": copy_,
            "res": json.loads((copy_ / "results.json").read_text())}


def nemesis_ops(run_dir: Path) -> dict:
    """{f: count} of a stored run's nemesis info ops."""
    out: dict = {}
    for ln in (run_dir / "history.jsonl").read_text().splitlines():
        o = json.loads(ln)
        if o["process"] == "nemesis" and o["type"] == "info":
            out[o["f"]] = out.get(o["f"], 0) + 1
    return out


def suite_verdict(what: str, rc: int, lines: list, host: dict,
                  device: bool, mpl: bool) -> tuple:
    """The one stored run's results against the host oracle's: each
    entry as the host's (its verdicts where a kernel made it), the plot
    entries by the matplotlib rule, the exit code the whole verdict's;
    no fault reaches the fakes, so every verdict but a plot's holds.
    Returns (the run dir, its results)."""
    from jepsen_tpu_torch import cli
    check(len(lines) == 1 and "dir" in lines[0],
          f"{what}: rc {rc}, lines {lines}")
    run_dir = Path(lines[0]["dir"])
    res = json.loads((run_dir / "results.json").read_text())
    same_entries(res, host["res"], what, device=device)
    plots_as_expected(res, run_dir, what)
    plots_as_expected(host["res"], host["dir"], f"{what} (host)")
    valid = res["valid?"]
    check(valid == host["res"]["valid?"] == lines[0]["valid?"]
          and rc == cli.validity_exit_code(res) == host["rc"],
          f"{what}: verdict {valid} (exit {rc}) on the card, "
          f"{host['res']['valid?']} (exit {host['rc']}) from the host")
    # a plot's verdict is unknown only without matplotlib
    inner = [v.get("valid?") for k, v in res.items()
             if isinstance(v, dict) and "valid?" in v
             and k not in PLOT_ENTRIES]
    want = "unknown" if not mpl and set(res) & set(PLOT_ENTRIES) \
        else True
    check(all(v is True for v in inner) and valid == want,
          f"{what}: verdicts {inner}, whole {valid}, want {want}")
    return run_dir, res


#: Phase 21: the BASELINE suites. etcd (config #1's suite) at its
#: published shape (10 threads a key, 300 ops a key, values 0-4,
#: stagger 1/30 s) for about 10 s at a concurrency of three keys at
#: once; the yugabyte and dgraph runs' time limit; the nemesis interval
#: (s) and the concurrency of those runs.
BASE_ETCD_LIMIT, BASE_ETCD_CONC = 10, 30
BASE_LIMIT, BASE_INTERVAL, BASE_CONC = 5, 1, 10
BASE_ETCD_FAULTS = "partition,kill,pause,clock"


def phase_baseline(smi: str) -> dict:
    """Phase 21: the suites of BASELINE.json's configs #1 and #5, each
    through its own `main` with the argv a user gives it, against the
    fake servers of tests/ (loaded by path), on the card: (a) etcd
    `test --faults partition,kill,pause,clock` against tests/fake_etcd.py
    (knossos_dense_scan, one launch a key); (b) yugabyte YSQL `append`
    against FakePGServer (closure_square) and YCQL `register` against
    FakeCQLServer (knossos_dense_scan), each `--nemesis partition`; (c)
    dgraph `register` (knossos_dense_scan) and `bank` (host checkers
    only) against FakeDgraphServer. The suite's `<db>_test` is wrapped
    for the run to add the fakes' hosts, the time limit and the nemesis
    interval, to drop db and os (the fakes have no daemons; a fault
    package keeps the suite's DB) and to set the iptables net and a
    DummyRemote. Every stored run re-checked by `analyze --backend cpu`
    (the host oracles): each entry as the host's (per key for the
    registers), the plot entries by the matplotlib rule, the exit code
    the whole verdict's. Returns per kernel, per path (launches, device
    ms)."""
    import threading
    from jepsen_tpu_torch.suites import dgraph, etcd, yugabyte

    t_phase = time.perf_counter()
    fakes = {n: load_fake(n) for n in ("fake_sql", "fake_cql",
                                       "fake_dgraph", "fake_etcd")}
    base = WORK / "baseline"
    threads_before = set(threading.enumerate())
    cs_paths, dense_paths = {}, {}
    mpl = has_matplotlib()
    say("phase 21: matplotlib is "
        + ("installed: each plot entry must be valid with its PNGs"
           if mpl else "not installed: each plot entry must be unknown "
           "with an error naming matplotlib, as the reference's"))

    # (a) etcd under all four fault families
    srv = fakes["fake_etcd"].FakeEtcdServer()
    real_url = etcd.client_url
    etcd.client_url = lambda node: srv.url()
    try:
        (rc, lines, remote), n, ms_run = counted_dense(lambda: suite_main(
            etcd, "etcd_test",
            {"time-limit": BASE_ETCD_LIMIT,
             "nemesis-interval": BASE_INTERVAL},
            ["test", "--faults", BASE_ETCD_FAULTS, "--store",
             str(base / "etcd"), "--concurrency", str(BASE_ETCD_CONC)]))
    finally:
        etcd.client_url = real_url
        srv.close()
    workers_ended("suite-etcd-register")
    check(len(lines) == 1, f"suite-etcd-register: rc {rc}, {lines}")
    run_e = Path(lines[0]["dir"])
    host = suite_recheck(base, run_e, etcd.etcd_test({})["checker"])
    run_e, res_e = suite_verdict("suite-etcd-register", rc, lines, host,
                                 device=True, mpl=mpl)
    keys = per_key(res_e["indep"])
    check(keys and keys == per_key(host["res"]["indep"])
          and all(v is True for v in keys.values()),
          f"suite-etcd-register: per-key verdicts {keys} vs the CPU "
          f"WGL's {per_key(host['res']['indep'])}")
    tiers_e: dict = {}
    for r in res_e["indep"]["results"].values():
        a = r["linear"].get("analyzer")
        tiers_e[a] = tiers_e.get(a, 0) + 1
    check(0 < n == tiers_e.get("tpu-dense", 0),
          f"suite-etcd-register: {n} knossos_dense_scan launches for "
          f"{len(keys)} keys of tiers {tiers_e} (one a dense key)")
    hist = [json.loads(ln) for ln in
            (run_e / "history.jsonl").read_text().splitlines()]
    ops_a_key: dict = {}
    for o in hist:
        if isinstance(o["process"], int) and o["type"] == "invoke":
            k = o["value"][0]
            ops_a_key[k] = ops_a_key.get(k, 0) + 1
    check(ops_a_key and max(ops_a_key.values()) <= 300
          and {o["f"] for o in hist if isinstance(o["process"], int)}
          <= {"read", "write", "cas"},
          f"suite-etcd-register: ops a key {ops_a_key}")
    fs = nemesis_ops(run_e)
    for family, ops in FAMILY_FS.items():
        check(any(fs.get(f) for f in ops),
              f"suite-etcd-register: no op of the {family} family in {fs}")
    cmds = [p for _n, k, p in remote.actions if k == "execute"]
    n_cmd = {k: sum(k in c and "g++" not in c for c in cmds)
             for k in ("iptables -A INPUT", "kill -KILL", "kill -STOP",
                       "kill -CONT", "/opt/jepsen/bump-time",
                       "/opt/jepsen/strobe-time")}
    check(n_cmd["iptables -A INPUT"] > 0 and n_cmd["kill -KILL"] > 0
          and n_cmd["kill -STOP"] > 0 and n_cmd["kill -CONT"] > 0
          and n_cmd["/opt/jepsen/bump-time"]
          + n_cmd["/opt/jepsen/strobe-time"] > 0,
          f"suite-etcd-register: the remote's commands {n_cmd}")
    # the device time from a second pass on one thread: the fan-out's
    # threads launch at once and each event pair also brackets a GIL
    # wait (phase 14)
    with one_thread():
        again, n_1, ms = counted_dense(lambda: suite_recheck(
            base, run_e, etcd.etcd_test({"device": DEVICE})["checker"],
            backend="device"))
    check(n_1 == n and again["res"]["indep"] == res_e["indep"],
          f"suite-etcd-register: the one-thread re-check launched {n_1} "
          "times or differs from the run's per-key results")
    secs = span_secs(run_e)
    dense_paths["suite-etcd-register"] = (n, ms)
    say(f"suite-etcd-register (etcd, --faults {BASE_ETCD_FAULTS}, "
        f"{BASE_ETCD_LIMIT}s, interval {BASE_INTERVAL}s, concurrency "
        f"{BASE_ETCD_CONC}: 10 threads a key, fake etcd): exit {rc}, "
        f"{res_e['valid?']}; {len(keys)} keys each valid as the CPU "
        f"WGL's, tiers {tiers_e}, ops a key "
        f"{sorted(ops_a_key.values())}; nemesis ops "
        f"{fs}; remote {n_cmd}; generator.run "
        f"{secs['generator.run']:.3f}s, analyze {secs['analyze']:.3f}s; "
        f"{n} knossos_dense_scan launches, {ms} ms of device time on one "
        f"thread ({ms_run} ms of event pairs in the run's fan-out) "
        f"({smi})")

    # (b) yugabyte: YSQL append and YCQL register, --nemesis partition
    def yuga(api: str, workload: str, fake, counter) -> tuple:
        srv_ = fake()
        try:
            got = counter(lambda: suite_main(
                yugabyte, "yugabyte_test",
                {"db-hosts": {n: ("127.0.0.1", srv_.port) for n in
                              ("n1", "n2", "n3", "n4", "n5")},
                 "time-limit": BASE_LIMIT,
                 "nemesis-interval": BASE_INTERVAL},
                ["test", "--api", api, "--workload", workload,
                 "--nemesis", "partition", "--store",
                 str(base / f"{api}-{workload}"), "--concurrency",
                 str(BASE_CONC)]))
        finally:
            srv_.close()
        return got

    for api, workload, fake, counter, paths in (
            ("ysql", "append", fakes["fake_sql"].FakePGServer, counted,
             cs_paths),
            ("ycql", "register", fakes["fake_cql"].FakeCQLServer,
             counted_dense, dense_paths)):
        what = f"suite-{api}-{workload}"
        (rc, lines, remote), n, ms = yuga(api, workload, fake, counter)
        workers_ended(what)
        check(len(lines) == 1, f"{what}: rc {rc}, {lines}")
        host = suite_recheck(base, Path(lines[0]["dir"]), yugabyte.workloads(
            {}, api)[workload]()["checker"])
        run_y, res_y = suite_verdict(what, rc, lines, host, device=True,
                                     mpl=mpl)
        if workload == "register":
            check(per_key(res_y) == per_key(host["res"]) and per_key(res_y),
                  f"{what}: per-key verdicts {per_key(res_y)} vs the CPU "
                  f"WGL's {per_key(host['res'])}")
        fs_y = nemesis_ops(run_y)
        check(fs_y.get("start") and set(fs_y) <= {"start", "stop"} and any(
            "iptables -A INPUT" in p for _n, k, p in remote.actions
            if k == "execute"),
            f"{what}: nemesis ops {fs_y} or no iptables command")
        check(n > 0, f"{what}: no kernel launch")
        secs = span_secs(run_y)
        paths[what] = (n, ms)
        size = (f"txn-count {res_y.get('txn-count')}"
                if workload == "append"
                else f"{len(per_key(res_y))} keys each as the CPU WGL's")
        say(f"{what} (yugabyte {api.upper()} {workload}, --nemesis "
            f"partition, {BASE_LIMIT}s, concurrency {BASE_CONC}, "
            f"{fake.__name__}): exit {rc}, {res_y['valid?']} as the host "
            f"oracle's; {size}; nemesis ops {fs_y}; generator.run "
            f"{secs['generator.run']:.3f}s, analyze "
            f"{secs['analyze']:.3f}s; {n} "
            f"{'closure_square' if workload == 'append' else 'knossos_dense_scan'}"
            f" launches taking {ms} ms of device time ({smi})")

    # (c) dgraph register and bank
    for workload in ("register", "bank"):
        what = f"suite-dgraph-{workload}"
        srv = fakes["fake_dgraph"].FakeDgraphServer()
        try:
            ((rc, lines, remote), n_d, ms_d), n_c, _ = counted(
                lambda: counted_dense(lambda: suite_main(
                    dgraph, "dgraph_test",
                    {"db-hosts": {n: ("127.0.0.1", srv.port) for n in
                                  ("n1", "n2", "n3", "n4", "n5")},
                     "time-limit": BASE_LIMIT,
                     "nemesis-interval": BASE_INTERVAL},
                    ["test", "--workload", workload, "--store",
                     str(base / f"dgraph-{workload}"), "--concurrency",
                     str(BASE_CONC)])))
        finally:
            srv.close()
        workers_ended(what)
        check(len(lines) == 1, f"{what}: rc {rc}, {lines}")
        host = suite_recheck(base, Path(lines[0]["dir"]),
                             dgraph.workloads({})[workload]()["checker"])
        run_d, res_d = suite_verdict(what, rc, lines, host,
                                     device=workload == "register",
                                     mpl=mpl)
        check(n_c == 0, f"{what}: {n_c} closure_square launches")
        if workload == "register":
            check(per_key(res_d) == per_key(host["res"]) and per_key(res_d)
                  and n_d > 0,
                  f"{what}: per-key verdicts {per_key(res_d)} vs the CPU "
                  f"WGL's {per_key(host['res'])}, {n_d} launches")
            dense_paths[what] = (n_d, ms_d)
            size = f"{len(per_key(res_d))} keys each as the CPU WGL's"
        else:
            check(n_d == 0 and res_d["bank"]["read-count"] > 0,
                  f"{what}: {n_d} launches, {res_d['bank']}")
            size = (f"{res_d['bank']['read-count']} reads, the balance "
                    f"entry equal to the host's, plot "
                    f"{res_d['plot']['valid?']}")
        fs_d = nemesis_ops(run_d)
        check(fs_d.get("start"), f"{what}: nemesis ops {fs_d}")
        secs = span_secs(run_d)
        say(f"{what} (dgraph {workload}, {BASE_LIMIT}s, concurrency "
            f"{BASE_CONC}, FakeDgraphServer): exit {rc}, "
            f"{res_d['valid?']} as the host oracle's; {size}; nemesis "
            f"ops {fs_d}; generator.run {secs['generator.run']:.3f}s, "
            f"analyze {secs['analyze']:.3f}s; {n_d} knossos_dense_scan "
            f"launches taking {ms_d} ms of device time ({smi})")

    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads_before:
        check(time.monotonic() < deadline, "phase 21: threads left: "
              f"{[t.name for t in set(threading.enumerate()) - threads_before]}")
        time.sleep(0.05)
    took = time.perf_counter() - t_phase
    check(took < 75, f"phase 21 took {took:.1f}s")
    say(f"phase 21 in {took:.1f}s")
    return {"closure_square": cs_paths, "knossos_dense_scan": dense_paths}


#: Phase 22: the suites of the mongodb family, zookeeper and consul over
#: their own wire drivers, and the SQL suites that ride the SQL layer,
#: each through its own main against a fake of tests/ under its own
#: nemesis (the partitioner; postgres_rds's is the noop, as the
#: reference's): the time limit (s), the nemesis interval (s) and the
#: concurrency of each run. Phase 23 runs the same shape.
MORE_LIMIT, MORE_INTERVAL, MORE_CONC = 2, 0.5, 10
#: A run whose generator.run outlasts its limit by more than this (s)
#: prints its slowest client op.
SLOW_RUN = 2
#: path -> (suite, (fake module, class), --workload or None, the kernel
#: its checker launches: "dense" (knossos_dense_scan), "closure"
#: (closure_square) or None (host checkers alone), options the suite's
#: `<db>_test` gets besides the fake's hosts and the time limit)
MORE_RUNS = {
    "suite-mongodb-register": ("mongodb", ("fake_torch_mongo",
                                           "FakeMongoServer"),
                               "register", "dense", {}),
    "suite-mongodb_rocks-register": ("mongodb_rocks", (
        "fake_torch_mongo", "FakeMongoServer"), "register", "dense", {}),
    "suite-zookeeper-register": ("zookeeper", ("fake_misc",
                                               "FakeZKServer"),
                                 None, "dense", {}),
    "suite-consul-register": ("consul", ("fake_misc", "FakeConsulServer"),
                              None, "dense", {}),
    "suite-galera-dirty-reads": ("galera", ("fake_sql", "FakeMySQLServer"),
                                 "dirty-reads", None, {}),
    "suite-percona-dirty-reads": ("percona", ("fake_sql",
                                              "FakeMySQLServer"),
                                  "dirty-reads", None, {}),
    "suite-mysql_cluster-bank": ("mysql_cluster", ("fake_sql",
                                                   "FakeMySQLServer"),
                                 "bank", None, {}),
    "suite-postgres_rds-append": ("postgres_rds", ("fake_sql",
                                                   "FakePGServer"),
                                  "append", "closure", {}),
    "suite-postgres_rds-wr": ("postgres_rds", ("fake_sql", "FakePGServer"),
                              "wr", "closure", {}),
}
#: Phase 23: the RESP, ReQL and AMQP suites and robustirc. Their
#: registers' model is the plain read/write `register`, which
#: `Linearizable` (as the reference's) gives the host WGL engine: only a
#: fresh CAS register takes the device tiers. So no path here launches
#: a kernel; the queues drain after the limit.
QUEUE_RUNS = {
    "suite-raftis-register": ("raftis", ("fake_misc", "FakeRedisServer"),
                              None, None, {}),
    "suite-rethinkdb-register": ("rethinkdb", ("fake_misc",
                                               "FakeReqlServer"),
                                 "register", None, {}),
    "suite-rethinkdb-set": ("rethinkdb", ("fake_misc", "FakeReqlServer"),
                            "set", None, {}),
    "suite-disque-queue": ("disque", ("fake_misc", "FakeDisqueServer"),
                           None, None, {}),
    "suite-rabbitmq-queue": ("rabbitmq", ("fake_misc", "FakeAMQPServer"),
                             None, None, {}),
    "suite-robustirc-set": ("robustirc", ("fake_misc",
                                          "FakeRobustIRCServer"),
                            "set", None, {"tls": False}),
}
#: Phase 24: the aerospike, ignite, hazelcast and faunadb suites over
#: their own wire drivers. aerospike, ignite and faunadb take
#: `standard_workloads`' register (a fresh CAS register: the device
#: tiers, one knossos_dense_scan launch for all keys); hazelcast's lock
#: is the mutex, which the host WGL engine checks.
WIRE_RUNS = {
    "suite-aerospike-register": ("aerospike", ("fake_torch_aerospike",
                                               "FakeAerospikeServer"),
                                 "register", "dense", {}),
    "suite-aerospike-counter": ("aerospike", ("fake_torch_aerospike",
                                              "FakeAerospikeServer"),
                                "counter", None, {}),
    "suite-ignite-register": ("ignite", ("fake_torch_ignite",
                                         "FakeIgniteServer"),
                              "register", "dense", {}),
    "suite-ignite-bank": ("ignite", ("fake_torch_ignite",
                                     "FakeIgniteServer"),
                          "bank", None, {}),
    "suite-hazelcast-queue": ("hazelcast", ("fake_torch_hazelcast",
                                            "FakeHazelcastServer"),
                              "queue", None, {}),
    "suite-hazelcast-lock": ("hazelcast", ("fake_torch_hazelcast",
                                           "FakeHazelcastServer"),
                             "lock", None, {}),
    "suite-faunadb-register": ("faunadb", ("fake_fauna", "FakeFaunaServer"),
                               "register", "dense", {}),
    "suite-faunadb-set": ("faunadb", ("fake_fauna", "FakeFaunaServer"),
                          "set", None, {}),
}
#: Phase 25: the last five suites. crate's register (`standard_workloads`'
#: fresh CAS register: one knossos_dense_scan launch for all keys) and wr
#: (the rw-register checker: closure_square; crate's menu has no append)
#: over the pg wire, its `_version` workloads (host checkers); logcabin's
#: register through the TreeOps remote of tests/fake_torch_treeops.py
#: (one dense launch for all keys); elasticsearch's set and dirty-read;
#: chronos's schedule and jobs against tests/fake_torch_chronos.py (the
#: scheduler over HTTP, the run files over the control plane); and
#: charybdefs's file faults on the dummy remote. A fake of None: the
#: dummy remote alone.
LAST_RUNS = {
    "suite-crate-register": ("crate", ("fake_sql", "FakePGServer"),
                             "register", "dense", {}),
    "suite-crate-wr": ("crate", ("fake_sql", "FakePGServer"), "wr",
                       "closure", {}),
    "suite-crate-version-divergence": ("crate", ("fake_sql",
                                                 "FakePGServer"),
                                       "version-divergence", None,
                                       {"keys-concurrent": 5,
                                        "readers": 2}),
    # each key's adds, quiescence and final read inside the limit
    "suite-crate-lost-updates": ("crate", ("fake_sql", "FakePGServer"),
                                 "lost-updates", None,
                                 {"time-limit": 3, "quiesce": 0.5,
                                  "keys-concurrent": 5, "key-count": 2}),
    "suite-logcabin-register": ("logcabin", ("fake_torch_treeops",
                                             "FakeTreeOpsRemote"),
                                None, "dense", {}),
    # 100 adds (the suite's default is 500): all acknowledged and the
    # set read well inside the limit
    "suite-elasticsearch-set": ("elasticsearch", ("fake_misc",
                                                  "FakeESServer"),
                                "set", None, {"set-size": 100}),
    "suite-elasticsearch-dirty-read": ("elasticsearch", (
        "fake_misc", "FakeESServer"), "dirty-read", None, {"quiesce": 0.2}),
    "suite-chronos-schedule": ("chronos", ("fake_torch_chronos",
                                           "FakeChronos"),
                               "schedule", None,
                               {"time-limit": 50}),
    "suite-chronos-jobs": ("chronos", ("fake_torch_chronos",
                                       "FakeChronos"), "jobs", None, {}),
    "suite-charybdefs-file-faults": ("charybdefs", None, None, None, {}),
}
#: How long each phase may take (s): 90 but for phase 25, whose chronos
#: schedule run alone takes 50 s. A job's first target is 10 s after it
#: is added (at the run's start) and is due by the final read only once
#: its epsilon (up to 29 s) and duration (up to 9 s) have passed: a 50 s
#: limit makes at least one target due whatever the draw.
PHASE_LIMIT_S = {25: 160}
#: The suites whose clients connect to the node's name at a class
#: attribute's port (suite -> the client class): their runs take
#: `--node 127.0.0.1`, with the class's port set to the fake's.
CLASS_PORTS = {"aerospike": "_AsClient", "ignite": "_IgClient",
               "hazelcast": "_HzClient"}
#: The suites whose register checker fans out a thread a key (compose of
#: timeline and linear inside independent.checker): one dense launch a
#: dense key, device ms from a one-thread re-check (phase 21's etcd).
FANOUT = ("zookeeper", "consul")
#: Each suite's default workload (its `main` without --workload).
DEFAULT_WORKLOAD = {"disque": "queue", "rabbitmq": "queue",
                    "charybdefs": "file-faults"}


def slowest_op(run_dir: Path) -> str:
    """The stored history's slowest client op: its f, latency, completion
    type and error (an op never completed counts to the history's end)."""
    hist = [json.loads(ln) for ln in
            (run_dir / "history.jsonl").read_text().splitlines()]
    end = max((o.get("time", 0) for o in hist), default=0)
    open_: dict = {}
    worst = None
    for o in hist:
        if not isinstance(o["process"], int):
            continue
        if o["type"] == "invoke":
            open_[o["process"]] = o
            continue
        inv = open_.pop(o["process"], None)
        if inv is not None:
            lat = (o["time"] - inv["time"]) / 1e9
            if worst is None or lat > worst[0]:
                worst = (lat, inv["f"], o["type"], o.get("error"))
    for inv in open_.values():
        lat = (end - inv["time"]) / 1e9
        if worst is None or lat > worst[0]:
            worst = (lat, inv["f"], "never completed", None)
    if worst is None:
        return "no client op"
    lat, f, typ, err = worst
    return f"f {f}, latency {lat:.3f}s, {typ}, error {err!r}"


def host_entry(res: dict, run_dir: Path, what: str) -> str:
    """Checks a host-checked run's main entry (dirty reads and bank: a
    read; the queues: no acknowledged enqueue lost, a drain after the
    last enqueue; set: adds acknowledged, none lost) and says it."""
    if "target-count" in res:
        # chronos's schedule: every target due by the final read met
        check(res["target-count"] >= 1 and res["missed-count"] == 0,
              f"{what}: schedule {str(res)[:300]}")
        return ", ".join(f"{k} {res[k]}" for k in (
            "target-count", "missed-count", "extra-count")) + \
            f", {len(res['jobs'])} jobs"
    if "stats" in res and "exceptions" in res:
        check(res["stats"]["count"] > 0,
              f"{what}: stats {str(res)[:300]}")
        return f"stats count {res['stats']['count']}"
    if "results" in res:
        # crate's _version workloads: a verdict a key
        per = res["results"]
        check(per and all(v["valid?"] is True for v in per.values()),
              f"{what}: per-key {str(per)[:300]}")
        if any("version-count" in v for v in per.values()):
            return (f"{len(per)} keys, versions read "
                    f"{sum(v['version-count'] for v in per.values())}")
        check(all(v["lost-count"] == 0 for v in per.values())
              and any(v["ok-count"] > 0 for v in per.values()),
              f"{what}: per-key sets {str(per)[:300]}")
        return (f"{len(per)} keys, ok-count "
                f"{sum(v['ok-count'] for v in per.values())}, none lost")
    if "dirty-read" in res:
        dr = res["dirty-read"]
        check(dr["strong-read-count"] >= 1 and dr["dirty-count"] == 0
              and dr["lost-count"] == 0,
              f"{what}: dirty-read {str(dr)[:300]}")
        return ", ".join(f"{k} {dr[k]}" for k in (
            "strong-read-count", "read-count", "on-all-count",
            "dirty-count", "lost-count"))
    if "set" in res:
        res = res["set"]
    if "analyzer" in res:
        # the mutex: a linearizability verdict of the host WGL engine
        check(res["analyzer"] == "wgl" and res["valid?"] is True,
              f"{what}: lock {str(res)[:300]}")
        return f"analyzer {res['analyzer']}, valid {res['valid?']}"
    if "reads" in res and "errors" in res:
        check(res["reads"] and not res["errors"],
              f"{what}: counter {str(res)[:300]}")
        return f"{len(res['reads'])} counter reads in bounds"
    if "queue" in res or "duplicated-count" in res:
        q = res.get("queue", res)
        hist = [json.loads(ln) for ln in
                (run_dir / "history.jsonl").read_text().splitlines()]
        drains = [i for i, o in enumerate(hist)
                  if o["f"] == "drain" and o["type"] == "ok"]
        enqueues = [i for i, o in enumerate(hist) if o["f"] == "enqueue"]
        check(q["lost-count"] == 0 and q["acknowledged-count"] > 0
              and drains and enqueues and drains[-1] > enqueues[-1],
              f"{what}: queue {str(q)[:300]}, drains at {drains[-3:]}, "
              f"last enqueue {enqueues[-1:]}")
        return ", ".join(f"{k} {q[k]}" for k in (
            "attempt-count", "acknowledged-count", "ok-count",
            "recovered-count", "lost-count")) + \
            f", {len(drains)} ok drains"
    if "ok-count" in res:
        check(res["ok-count"] > 0 and res["lost-count"] == 0,
              f"{what}: set {str(res)[:300]}")
        return ", ".join(f"{k} {res[k]}" for k in (
            "attempt-count", "ok-count", "lost-count", "unexpected-count")
            if k in res)
    entry = res.get("dirty-reads") or res.get("bank")
    check(entry is not None and entry["read-count"] > 0,
          f"{what}: no read in {str(entry)[:300]}")
    return ", ".join(f"{k} {entry[k]}" for k in (
        "read-count", "failed-write-count", "dirty-count",
        "inconsistent-count") if k in entry)


def drive_suites(n: int, runs: dict, smi: str) -> dict:
    """Phases 22 to 25: each suite of `runs` through its own `main`
    with the argv a user gives it, against the fakes of tests/ (loaded
    by path), for MORE_LIMIT s (or the run's own "time-limit") under the
    suite's own nemesis, each path with both kernels' counts set to 0
    just before it and read just after. A suite of CLASS_PORTS runs on
    `--node 127.0.0.1` with its client class's port set to the fake's,
    and restored after; a fake that is a remote (it plays the nodes'
    commands) is the run's remote. Every stored run re-checked by
    `analyze --backend cpu` (the host oracles) with its test map's
    checker: each entry as the host's (per key for the registers), the
    plot entries by the matplotlib rule, the exit code the whole
    verdict's. A run whose generator.run outlasts its limit by more than
    SLOW_RUN s prints its slowest client op. Phase 25 then serves its
    runs through `serve --web` (`web_check`). Returns per kernel, per
    path (launches, device ms).
    """
    import importlib
    import threading

    t_phase = time.perf_counter()
    base = WORK / f"suites-{n}"
    threads_before = set(threading.enumerate())
    cs_paths, dense_paths = {}, {}
    mpl = has_matplotlib()
    say(f"phase {n}: matplotlib is "
        + ("installed: each plot entry must be valid with its PNGs"
           if mpl else "not installed: each plot entry must be unknown "
           "with an error naming matplotlib, as the reference's"))

    if n == 24:
        import hashlib
        say(f"phase {n}: hashlib has ripemd160: "
            f"{'ripemd160' in hashlib.algorithms_available}")
    run_dirs = {}
    for what, (suite, fake, workload, kernel, extra) in runs.items():
        fake_mod, fake_cls = fake or (None, "DummyRemote")
        limit = extra.get("time-limit", MORE_LIMIT)
        mod = importlib.import_module(f"jepsen_tpu_torch.suites.{suite}")
        make_name = f"{suite}_test"
        argv = ["test", "--store", str(base / what), "--concurrency",
                str(MORE_CONC)]
        if workload:
            argv += ["--workload", workload]
        port_cls = getattr(mod, CLASS_PORTS[suite]) \
            if suite in CLASS_PORTS else None
        if port_cls is not None:
            argv += ["--node", "127.0.0.1"]
        with (getattr(load_fake(fake_mod), fake_cls)() if fake_mod
              else contextlib.nullcontext()) as srv:
            if port_cls is not None:
                saved_port = port_cls.port
                port_cls.port = srv.port
            hosts = {n: ("127.0.0.1", srv.port) for n in
                     ("n1", "n2", "n3", "n4", "n5")} \
                if getattr(srv, "port", None) else {}
            try:
                ((rc, lines, remote), n_d, ms_d), n_c, ms_c = counted(
                    lambda: counted_dense(lambda: suite_main(
                        mod, make_name,
                        {"db-hosts": hosts, "time-limit": MORE_LIMIT,
                         "nemesis-interval": MORE_INTERVAL, **extra},
                        argv, remote=srv if hasattr(srv, "execute")
                        else None)))
            finally:
                if port_cls is not None:
                    port_cls.port = saved_port
        workers_ended(what)
        check(len(lines) == 1, f"{what}: rc {rc}, lines {lines}")
        name = workload or DEFAULT_WORKLOAD.get(suite, "register")
        host = suite_recheck(base, Path(lines[0]["dir"]), getattr(
            mod, make_name)({"workload": name, **extra})["checker"])
        run_dir, res = suite_verdict(what, rc, lines, host,
                                     device=kernel is not None, mpl=mpl)
        run_dirs[what] = run_dir
        hist = [json.loads(ln) for ln in
                (run_dir / "history.jsonl").read_text().splitlines()]
        n_ops = sum(1 for o in hist if isinstance(o["process"], int)
                    and o["type"] == "invoke")
        check(n_ops > 0, f"{what}: no client op in the history")
        fs = nemesis_ops(run_dir)
        iptables = sum("iptables -A INPUT" in p for _n, k, p in
                       remote.actions if k == "execute")
        if suite == "charybdefs":
            # the fault flips follow a 5 s sleep: none in a short run,
            # but the nemesis's setup and teardown write faultfs's ctl
            ctl = sum(".faultfs-ctl" in p for _n, k, p in remote.actions
                      if k == "execute")
            check(set(fs) <= {"break-pct", "clear"} and ctl > 0,
                  f"{what}: nemesis ops {fs}, {ctl} faultfs ctl commands")
        else:
            # postgres_rds's nemesis is the noop; one node cuts no link
            check(fs.get("start") and set(fs) <= {"start", "stop"}
                  and (iptables > 0) == (suite != "postgres_rds"
                                         and port_cls is None),
                  f"{what}: nemesis ops {fs}, {iptables} iptables "
                  "commands")
        if kernel == "dense":
            keys = per_key(res)
            check(keys and keys == per_key(host["res"])
                  and all(v is True for v in keys.values()),
                  f"{what}: per-key verdicts {keys} vs the CPU WGL's "
                  f"{per_key(host['res'])}")
            check(n_c == 0 and n_d > 0,
                  f"{what}: {n_d} knossos_dense_scan and {n_c} "
                  "closure_square launches")
            detail = f"{len(keys)} keys each valid as the CPU WGL's"
            tiers: dict = {}
            for r in res["results"].values():
                a = (r["linear"] if suite in FANOUT else r).get("analyzer")
                tiers[a] = tiers.get(a, 0) + 1
            if suite in FANOUT:
                check(n_d == tiers.get("tpu-dense", 0),
                      f"{what}: {n_d} launches for tiers {tiers} (one "
                      "a dense key)")
            if n == 25:
                # the batch route: one launch a pending-slot bucket (the
                # keys' slot peaks rounded up to even), so one for all
                # keys when their peaks agree; logcabin's indeterminate
                # conditional writes hold their slots to the end
                check(1 <= n_d <= len(keys)
                      and tiers == {"tpu-dense": len(keys)},
                      f"{what}: {n_d} launches for tiers {tiers} (one a "
                      "pending-slot bucket, every key tpu-dense)")
            if suite in FANOUT or n >= 24:
                # the fan-out's event pairs also bracket waits on the
                # interpreter lock: the device time from one thread (for
                # phase 24's batch route too, to compare like with like)
                with one_thread():
                    again, n_1, ms_d1 = counted_dense(lambda: suite_recheck(
                        base, run_dir, mod.workloads(
                            {"device": DEVICE})[name]()["checker"],
                        backend="device"))
                check(n_1 == n_d and again["res"]["results"]
                      == res["results"],
                      f"{what}: the one-thread re-check launched {n_1} "
                      "times or differs from the run's per-key results")
                detail += (f", tiers {tiers}; {ms_d1} ms of device time "
                           f"on one thread ({ms_d} ms of event pairs in "
                           "the run)")
                ms_d = ms_d1
            dense_paths[what] = (n_d, ms_d)
            launched = f"{n_d} knossos_dense_scan launches ({ms_d} ms)"
        elif kernel == "closure":
            check(n_c > 0 and n_d == 0,
                  f"{what}: {n_c} closure_square and {n_d} "
                  "knossos_dense_scan launches")
            cs_paths[what] = (n_c, ms_c)
            detail = f"txn-count {res.get('txn-count')}"
            launched = f"{n_c} closure_square launches ({ms_c} ms)"
        else:
            check(n_c == 0 and n_d == 0,
                  f"{what}: {n_c} closure_square and {n_d} "
                  "knossos_dense_scan launches")
            if name == "register":
                # a plain register: the host WGL engine, as the
                # reference's, for every key
                keys = per_key(res)
                engines = {r["analyzer"] for r in res["results"].values()}
                check(keys and keys == per_key(host["res"])
                      and all(v is True for v in keys.values())
                      and engines == {"wgl"},
                      f"{what}: per-key verdicts {keys} ({engines}) vs the "
                      f"CPU WGL's {per_key(host['res'])}")
                detail = (f"{len(keys)} keys each valid on the host WGL "
                          "engine as the re-check's")
            else:
                detail = host_entry(res, run_dir, what)
            launched = "no launch"
        secs = span_secs(run_dir)
        say(f"{what} ({suite} {name}, {limit}s, interval "
            f"{MORE_INTERVAL}s, concurrency {MORE_CONC}, {fake_cls}): "
            f"exit {rc}, {res['valid?']} as the host oracle's; {n_ops} "
            f"ops; {detail}; nemesis ops {fs}, {iptables} iptables "
            f"commands; generator.run {secs['generator.run']:.3f}s, "
            f"analyze {secs['analyze']:.3f}s; {launched} ({smi})")
        if secs["generator.run"] > limit + SLOW_RUN:
            say(f"{what}: generator.run {secs['generator.run']:.3f}s for a "
                f"{limit}s limit; slowest client op: "
                f"{slowest_op(run_dir)}")

    if n == 25:
        web_check(base, run_dirs)

    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - threads_before:
        check(time.monotonic() < deadline, f"phase {n}: threads left: "
              f"{[t.name for t in set(threading.enumerate()) - threads_before]}")
        time.sleep(0.05)
    took = time.perf_counter() - t_phase
    check(took < PHASE_LIMIT_S.get(n, 90), f"phase {n} took {took:.1f}s")
    say(f"phase {n} in {took:.1f}s")
    return {"closure_square": cs_paths, "knossos_dense_scan": dense_paths}


def web_get(url: str) -> tuple:
    """(status, content type, body) of a GET; an HTTP error's too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def web_check(base: Path, run_dirs: dict) -> None:
    """Phase 25's store browser: its runs copied into one store, served
    by `python -m jepsen_tpu_torch.cli serve --web` as a user starts it;
    the run table names every run with its verdict, a run's listing
    names its files, a file and the run's zip hold the store's bytes,
    and a path with `..` is refused (404). The server is stopped
    after."""
    import html
    import re
    import urllib.error
    import zipfile
    from urllib.parse import quote
    t0 = time.perf_counter()
    store = base / "web"
    for d in run_dirs.values():
        shutil.copytree(d, store / d.parent.name / d.name)
    port = free_port()
    log = base / "web.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve", "--web",
         "--store", str(store), "--host", "127.0.0.1", "--port",
         str(port)], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=open(log, "w"))
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, _, home = web_get(url + "/")
                break
            except (urllib.error.URLError, ConnectionError):
                check(proc.poll() is None and time.monotonic() < deadline,
                      f"serve --web did not answer: {log.read_text()[-2000:]}")
                time.sleep(0.2)
        up = time.perf_counter() - t0
        home = home.decode()
        check(status == 200, f"serve --web: / gave {status}")
        for d in run_dirs.values():
            res = json.loads((d / "results.json").read_text())
            word = {True: "valid", False: "INVALID"}.get(res["valid?"],
                                                         "unknown")
            check(f"<td>{html.escape(d.name)}</td><td>{word}</td>" in home,
                  f"serve --web: no row for {d.parent.name}/{d.name} "
                  f"({word})")
        links = re.findall(r"href='/files/([^']+)'", home)
        check(len(links) == len(run_dirs),
              f"serve --web: {len(links)} run links, {len(run_dirs)} runs")
        d = next(iter(run_dirs.values()))
        (rel,) = [ln for ln in links
                  if ln == quote(f"{d.parent.name}/{d.name}")]
        status, _, listing = web_get(f"{url}/files/{rel}")
        names = sorted(p.name for p in d.iterdir())
        check(status == 200 and all(
            f">{html.escape(nm)}" in listing.decode() for nm in names),
            f"serve --web: the listing of {rel} lacks one of {names}")
        status, ctype, body = web_get(f"{url}/files/{rel}/results.json")
        check((status, ctype, body) == (
            200, "application/json", (d / "results.json").read_bytes()),
            f"serve --web: results.json of {rel} differs")
        status, ctype, body = web_get(f"{url}/zip/{rel}")
        zf = zipfile.ZipFile(io.BytesIO(body))
        files = {str(p.relative_to(d.parent)): p.read_bytes()
                 for p in sorted(d.rglob("*")) if p.is_file()}
        check(status == 200 and ctype == "application/zip"
              and sorted(zf.namelist()) == sorted(files)
              and all(zf.read(k) == v for k, v in files.items()),
              f"serve --web: the zip of {rel} differs from the store's "
              f"{len(files)} files")
        refused = [web_get(f"{url}{p}")[0] for p in (
            "/files/../../etc/passwd", "/files/%2e%2e/%2e%2e/etc/passwd",
            "/zip/..%2f..")]
        check(refused == [404, 404, 404],
              f"serve --web: the traversal guard answered {refused}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    say(f"serve --web over phase 25's {len(run_dirs)} runs: answered in "
        f"{up:.1f}s; the run table (a row each, its verdict), the "
        f"listing, results.json and the zip ({len(files)} files, "
        f"{len(body)} bytes) of {rel} as the store's; '..' refused 404 "
        f"three ways; stopped with exit {proc.returncode}; "
        f"{time.perf_counter() - t0:.1f}s")


#: Phase 26's scripts: (path name, module, the line its success prints).
SCRIPTS = (("obs-smoke", "jepsen_tpu_torch.obs.smoke", "obs-smoke: OK"),
           ("serve-smoke", "jepsen_tpu_torch.serve.smoke",
            "serve-smoke: PASS"),
           ("fleet-smoke", "jepsen_tpu_torch.serve.fleet_smoke",
            "fleet-smoke: PASS"),
           ("warm-bench", "jepsen_tpu_torch.warm_bench", "bench-warm: OK"))

#: The `sitecustomize` phase 26 puts on its scripts' PYTHONPATH: every
#: Python process of a script's tree times its closure_square launches
#: with CUDA event pairs (the hook list the wrapper fills) and, at exit,
#: writes its launches and their device milliseconds to
#: $CHIP_SMOKE_LAUNCH_DIR/<pid>.json. A process that never imports the
#: kernel's module (an ingest worker, the lint) writes nothing, and it
#: imports no torch for it. Any sitecustomize it shadows runs after it.
SCRIPT_SITE = """\
import atexit, importlib.util, json, os, sys
_MOD = "jepsen_tpu_torch.checker.elle.closure_square"
_HERE = os.path.dirname(os.path.abspath(__file__))


class _Hook:
    def find_spec(self, name, path=None, target=None):
        if name != _MOD:
            return None
        sys.meta_path.remove(self)
        spec = importlib.util.find_spec(name)
        if spec is None:
            return None
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            module.closure_square.events = []
        spec.loader.exec_module = exec_module
        return spec


def _report():
    cs = sys.modules.get(_MOD)
    if cs is None or not cs.closure_square.launches:
        return
    import torch
    torch.cuda.synchronize()
    rec = {"pid": os.getpid(), "argv": sys.argv[:3],
           "launches": cs.closure_square.launches,
           "device_ms": sum(a.elapsed_time(b)
                            for a, b in cs.closure_square.events)}
    with open(os.path.join(os.environ["CHIP_SMOKE_LAUNCH_DIR"],
                           f"{os.getpid()}.json"), "w") as f:
        json.dump(rec, f)


if os.environ.get("CHIP_SMOKE_LAUNCH_DIR"):
    sys.meta_path.insert(0, _Hook())
    atexit.register(_report)
for _d in sys.path:
    _p = os.path.join(_d, "sitecustomize.py")
    if _d and os.path.abspath(_d) != _HERE and os.path.isfile(_p):
        _spec = importlib.util.spec_from_file_location("_shadowed_site", _p)
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
"""


def run_script(name: str, module: str, ok_line: str, site: Path,
               base: Path) -> tuple[int, float, float]:
    """One phase-26 script with `--device cuda`, in a process group of
    its own; it must exit 0 with its success line, leave no process of
    its group behind and have launched closure_square. Returns (its
    tree's launches, their device ms, its wall s)."""
    launch_dir = base / f"{name}-launches"
    launch_dir.mkdir(parents=True)
    env = {**os.environ, "CHIP_SMOKE_LAUNCH_DIR": str(launch_dir),
           "PYTHONPATH": os.pathsep.join(
               [str(site), str(ROOT)]
               + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--device", DEVICE], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    GRANDCHILDREN.append(proc.pid)
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        kill_group(proc)
        raise SmokeFailure(f"{name} took over 300 s")
    wall = time.perf_counter() - t0
    (base / f"{name}.log").write_text(out)
    check(proc.returncode == 0 and ok_line in out,
          f"{name} exited {proc.returncode}: {out[-4000:]}")
    deadline = time.monotonic() + 10
    while group_alive(proc.pid):
        check(time.monotonic() < deadline,
              f"{name} left processes behind: {group_alive(proc.pid)}")
        time.sleep(0.1)
    recs = [json.loads(p.read_text()) for p in launch_dir.glob("*.json")]
    launches = sum(r["launches"] for r in recs)
    ms = sum(r["device_ms"] for r in recs)
    check(launches > 0, f"{name} never launched closure_square: {recs}")
    say(f"{name}: exit 0 in {wall:.1f}s, {launches} closure_square "
        f"launches ({ms:.3f} ms) in {len(recs)} process(es): "
        + ", ".join(f"{' '.join(r['argv'][1:3])} {r['launches']}"
                    for r in sorted(recs, key=lambda r: r['pid'])))
    return launches, ms, wall


def native_split_check(store: Path) -> tuple[int, int]:
    """(f): every run's native per-key split equals the Python split,
    key for key, and took the native path. Returns (runs, keys)."""
    from jepsen_tpu_torch import independent
    runs = sorted({p.resolve().parent for p in store.rglob("history.jsonl")})
    check(bool(runs), f"no register runs under {store}")
    keys = 0
    for run in runs:
        hist = history_ops(run)
        stats: dict = {}
        nat = independent.subhistories_path(hist, run / "history.jsonl",
                                            stats=stats)
        pure = independent.subhistories(independent.relift_history(hist))
        check(stats == {"native": 1},
              f"{run.name}: the native split did not run ({stats})")
        check(list(nat) == list(pure) and all(nat[k] == pure[k]
                                              for k in pure),
              f"{run.name}: the native split differs from the Python one")
        keys += len(pure)
    return len(runs), keys


def phase_scripts(reg_store: Path) -> dict:
    """Phase 26: the four scripts on the card, the lint, the native split
    of `reg_store`'s runs. Returns the paths' closure_square
    (launches, device ms) and each part's wall."""
    t_phase = time.perf_counter()
    base = WORK / "scripts"
    site = base / "site"
    site.mkdir(parents=True)
    (site / "sitecustomize.py").write_text(SCRIPT_SITE)
    # the lint is CPU only: it runs beside the scripts, a thread noting
    # when it ends (its output is one line: the pipe never fills)
    t_lint = time.perf_counter()
    lint = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "lint"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lint_end: list = []
    waiter = threading.Thread(target=lambda: (
        lint.wait(), lint_end.append(time.perf_counter())), daemon=True)
    waiter.start()
    paths, walls = {}, {}
    # warm_bench (three one-process sweeps, no timing contract) runs
    # beside the serve smoke; the fleet smoke, whose failover rides 2 s
    # of beacon staleness, runs alone
    beside = {"serve-smoke": "warm-bench"}
    scripts = {name: (module, ok_line) for name, module, ok_line in SCRIPTS}
    with ThreadPoolExecutor(max_workers=1) as pool:
        for name in ("obs-smoke", "serve-smoke", "fleet-smoke"):
            other = beside.get(name)
            fut = other and pool.submit(run_script, other, *scripts[other],
                                        site, base)
            n, ms, walls[name] = run_script(name, *scripts[name], site,
                                            base)
            paths[name] = (n, ms)
            if fut:
                n, ms, walls[other] = fut.result()
                paths[other] = (n, ms)
    out, _ = lint.communicate(timeout=300)
    waiter.join()
    walls["lint"] = lint_end[0] - t_lint
    check(lint.returncode == 0, f"lint exited {lint.returncode}: "
                                f"{out[-4000:]}")
    say(f"lint: exit 0 on Python {sys.version.split()[0]} "
        f"({out.strip().splitlines()[-1]}), {walls['lint']:.1f}s "
        "beside the scripts")
    t0 = time.perf_counter()
    runs, keys = native_split_check(reg_store)
    walls["split"] = time.perf_counter() - t0
    say(f"native split: {runs} register runs, {keys} keys, equal to the "
        f"Python split key for key, in {walls['split']:.1f}s")
    took = time.perf_counter() - t_phase
    check(took < 240, f"phase 26 took {took:.1f}s")
    say(f"phase 26 in {took:.1f}s; parts (s): "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    return {"closure_square": paths, "walls": walls}


def store_encodings(store: Path, checker: str) -> list:
    """(run dir, encoding) of every run of a phase's store, read
    serially (its sidecars are warm)."""
    from jepsen_tpu_torch import ingest
    from jepsen_tpu_torch.store import Store
    dirs = sorted(Store(store).iter_run_dirs())
    return [p for chunk in ingest.iter_encode_chunks(
        dirs, checker=checker, processes=0) for p in chunk]


def rendered(checker: str, enc, cycles) -> dict:
    """A verdict as the sweep writes it into results.json."""
    from jepsen_tpu_torch.checker import elle
    from jepsen_tpu_torch.checker.elle import wr
    res = wr.render_wr_verdict(enc, cycles, wr.WR_PROHIBITED) \
        if checker == "wr" \
        else elle.render_verdict(enc, cycles, elle.APPEND_PROHIBITED)
    res["checker"] = checker
    return json.loads(json.dumps(res))


def mesh_paths(tag: str, mesh, wr_devs: list, reg_devs: list, sp,
               encs: dict, verdicts: dict, config1: list) -> tuple:
    """Phase 27 (a) over `mesh` (and the dp lists and `sp` for the other
    paths); returns the closure_square, knossos_dense_scan and
    knossos_frontier_scan paths (launches, device ms) and each part's
    wall."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.elle import encode, kernels, synth, wr
    from jepsen_tpu_torch.checker.knossos import dense
    from jepsen_tpu_torch.checker.knossos import kernels as kkernels
    from jepsen_tpu_torch.parallel import folding

    paths, dpaths, walls = {}, {}, {}

    def part(key: str, fn, kernel=None):
        t0 = time.perf_counter()
        out, n, ms = counted(fn, kernel)
        torch.cuda.synchronize()
        walls[key] = round(time.perf_counter() - t0, 3)
        (dpaths if kernel is not None else paths)[f"{tag}-{key}"] = (n, ms)
        check(n > 0, f"phase 27 {tag}-{key} never launched its kernel")
        return out, n

    pairs = encs["append"]
    log: list = []
    got, n = part("append", lambda: parallel.check_bucketed(
        [e for _, e in pairs], mesh=mesh, bucket_log=log))
    for (d, enc), cyc in zip(pairs, got):
        same_as_phase(verdicts, "append", Path(d), rendered(
            "append", enc, cyc), f"phase 27 {tag} append")
    launch_split(log, n)
    say(f"27 {tag}: phase 4's {len(pairs)} runs over {mesh}: "
        f"{walls['append']}s, {len(log)} dispatches of "
        f"{sorted({b['histories'] for b in log})} histories at T_pad "
        f"{sorted({b['t_pad'] for b in log})}, {n} closure_square "
        f"launches; verdicts equal to phase 4's")

    wpairs = encs["wr"]
    got, n = part("wr", lambda: kernels.check_edge_batch(
        [wr.to_edge_dict(e) for _, e in wpairs], devices=wr_devs))
    for (d, enc), cyc in zip(wpairs, got):
        same_as_phase(verdicts, "wr", Path(d), rendered("wr", enc, cyc),
                      f"phase 27 {tag} wr")
    say(f"27 {tag}: phase 5's {len(wpairs)} wr runs through "
        f"check_edge_batch over {len(wr_devs)} devices: {walls['wr']}s, "
        f"{n} closure_square launches; verdicts equal to phase 5's")

    dencs = [dense.encode_dense_history(h) for h in config1]
    one = dense.check_encoded_dense_batch(dencs, device=DEVICE)
    got, n = part("register", lambda: dense.check_encoded_dense_batch(
        dencs, devices=reg_devs), dense.knossos_dense_scan)
    check(got == one and all(r["valid?"] is True for r in got),
          f"phase 27 {tag}: the dense tier over {len(reg_devs)} devices "
          "differs from one device's")
    from jepsen_tpu_torch.checker.knossos import encode as kenc
    kencs = [kenc.encode_register_history(h) for h in config1[:PACKED_CUT]]
    mark = frontier_mark()
    one = kkernels.check_encoded_batch(kencs, device=DEVICE, packed=True)
    fpaths = {f"{tag}-packed-one": frontier_since(mark)}
    t0 = time.perf_counter()
    mark = frontier_mark()
    pk = kkernels.check_encoded_batch(kencs, device=DEVICE, packed=True,
                                      devices=reg_devs)
    n_f, ms_f = frontier_since(mark)
    walls["packed"] = round(time.perf_counter() - t0, 3)
    fpaths[f"{tag}-packed"] = (n_f, ms_f)
    check(pk == one, f"phase 27 {tag}: the packed frontier over "
          f"{len(reg_devs)} devices differs from one device's")
    check(n_f == len(reg_devs), f"phase 27 {tag}: {n_f} "
          f"knossos_frontier_scan launches for {len(reg_devs)} dp slices")
    say(f"27 {tag}: config #1's {len(dencs)} histories, dense tier over "
        f"{len(reg_devs)} devices {walls['register']}s ({n} "
        f"knossos_dense_scan launches), packed frontier on "
        f"{len(kencs)} {walls['packed']}s ({n_f} knossos_frontier_scan "
        f"launches, {ms_f} ms; {[r['valid?'] for r in pk]}); equal to one "
        "device")

    h = synth.synth_append_history(LONG_MESH_T, 64, seed=27, g1c=True)
    enc = encode.encode_history(h)
    want = parallel.check_long_history(enc, DEVICE)
    got, n = part("long", lambda: parallel.check_long_history(enc,
                                                             mesh=sp))
    check(got == want and "G1c" in got,
          f"phase 27 {tag}: the {LONG_MESH_T}-txn history over {sp} gave "
          f"{got}, one device {want}")
    say(f"27 {tag}: one {LONG_MESH_T}-txn history over {sp}: "
        f"{walls['long']}s, {n} closure_square launches, {got} as on one "
        "device")

    for checker, src in (("append", pairs), ("wr", wpairs)):
        fold = src[:FOLD_RUNS]
        got, n = part(f"fold-{checker}", lambda: folding.FoldDispatcher(
            mesh=mesh).verdicts([e for _, e in fold], checker))
        for (d, _e), res in zip(fold, got):
            same_as_phase(verdicts, checker, Path(d),
                          json.loads(json.dumps(res)),
                          f"phase 27 {tag} fold")
    say(f"27 {tag}: FoldDispatcher(mesh=) folds of {FOLD_RUNS} append and "
        f"{FOLD_RUNS} wr runs: {walls['fold-append']}s, "
        f"{walls['fold-wr']}s; verdicts equal to phases 4 and 5")
    return paths, dpaths, fpaths, walls


def phase_devices(name: str, verdicts: dict) -> dict:
    """Phase 27: several devices (module doc). Returns the paths of the
    three kernels, the column blocks' timings and each part's wall."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.knossos import synth as ksynth
    from jepsen_tpu_torch.devices import default_devices
    from jepsen_tpu_torch.tools import closure_square_cols as cols
    from jepsen_tpu_torch.tools import multihost_dryrun as mh

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(
        DEVICE)
    t0 = time.perf_counter()
    encs = {"append": store_encodings(WORK / "store", "append"),
            "wr": store_encodings(WORK / "wr", "wr")}
    config1 = ksynth.synth_register_batch(B=KN_B, n_ops=KN_OPS,
                                          n_procs=KN_CONC, info_prob=0.0,
                                          seed=1)
    walls = {"load": round(time.perf_counter() - t0, 3)}
    paths, dpaths, fpaths, w = mesh_paths(
        "mesh", parallel.make_mesh([dev] * MESH_N), [dev] * WR_DP,
        [dev] * REG_DP, parallel.sp_mesh([dev] * SP_MP), encs, verdicts,
        config1)
    walls.update(w)

    t0 = time.perf_counter()
    for ln in cols.check_cases(dev, [(MAIN_B, MAIN_T, 2),
                                     (MAIN_B, MAIN_T, 4)]):
        say(f"27 (b) {ln}")
    blocks = cols.time_blocks(dev, name, [(MAIN_B, MAIN_T, 2),
                                          (MAIN_B, MAIN_T, 4)])
    walls["blocks"] = round(time.perf_counter() - t0, 3)
    for rec in blocks:
        say(f"27 (b) B={rec['B']} T={rec['T']} mp={rec['mp']}: full "
            f"launch {rec['full_ms']} ms (bound {rec['full_bound_ms']}); "
            + "; ".join(f"cols {b['cols']} {b['ms']} ms (bound "
                        f"{b['bound_ms']}, {b['bound_by']})"
                        for b in rec["blocks"]))

    real = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if real > 1:
        devs = default_devices()
        p, dp, fp, w = mesh_paths("real", parallel.make_mesh(devs), devs,
                                  devs, parallel.sp_mesh(devs), encs,
                                  verdicts, config1)
        paths.update(p)
        dpaths.update(dp)
        fpaths.update(fp)
        walls.update({f"real-{k}": v for k, v in w.items()})
        say(f"27 (c) {real} devices visible: (a) ran over the real cards "
            f"({parallel.make_mesh(devs)})")
    else:
        say("27 (c) one device visible: the real several-device part did "
            "not run")

    # (d): the joined processes report their closure_square launches
    # and device ms through phase 26's sitecustomize
    site = WORK / "multihost-site"
    site.mkdir(parents=True)
    (site / "sitecustomize.py").write_text(SCRIPT_SITE)

    def joined(key: str, fn):
        launch_dir = WORK / f"multihost-{key}-launches"
        launch_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        out = fn({"CHIP_SMOKE_LAUNCH_DIR": str(launch_dir),
                  "PYTHONPATH": os.pathsep.join(
                      [str(site), str(ROOT)]
                      + [p for p in [os.environ.get("PYTHONPATH")] if p])})
        walls[key] = round(time.perf_counter() - t0, 3)
        recs = [json.loads(p.read_text()) for p in launch_dir.glob("*.json")]
        n = sum(r["launches"] for r in recs)
        ms = sum(r["device_ms"] for r in recs)
        check(n > 0 and ms > 0, f"27 (d) {key}: the joined processes "
              f"launched no closure_square: {recs}")
        paths[f"mesh-{key}"] = (n, ms)
        return out, f"{n} closure_square launches ({ms:.3f} ms) in " \
            f"{len(recs)} process(es): " + ", ".join(
                str(r["launches"]) for r in sorted(recs,
                                                   key=lambda r: r["pid"]))

    want = parallel.check_bucketed(mh.global_batch(), dev)
    lines, said = joined("joined-global", lambda env: mh.global_dp(
        2, f"{dev},{dev}", timeout=300, extra=env))
    for ln in lines:
        check(json.loads(ln.split("flags=", 1)[1]) == want,
              f"27 (d) the gathered flags differ from one process's: {ln}")
        say(f"27 (d) {ln.split(' flags=')[0]}: flags equal to one process's")
    say(f"27 (d) global dp: {walls['joined-global']}s, {said}")
    res, said = joined("joined-sweep", lambda env: mh.mesh_sweep(
        2, DEVICE, work=WORK / "multihost", timeout=300, extra=env))
    check(res["rcs"][0] == res["rc"] == 1 and res["compared"] == 12,
          f"27 (d) the joined sweep: {res}")
    say(f"27 (d) analyze-store --mesh, 2 joined processes, no shard count: "
        f"{res['runs']} runs, {res['compared']} files byte-identical to "
        f"one process's sweep, exits {res['rcs']} (one process "
        f"{res['rc']}), {walls['joined-sweep']}s, {said}")
    took = time.perf_counter() - t_phase
    say(f"phase 27 in {took:.1f}s; parts (s): {json.dumps(walls)}")
    check(took < 150, f"phase 27 took {took:.1f}s")
    return {"closure_square": paths, "knossos_dense_scan": dpaths,
            "knossos_frontier_scan": fpaths, "blocks": blocks,
            "walls": walls}


#: knossos_frontier_scan's median ms on conc-20's 13 frontier histories
#: with the walk before the register walk (a block bitonic sort a round,
#: a barrier a stage; NVIDIA H100 80GB HBM3, 700 W), printed beside this
#: run's.
BLOCK_SORT_FRONTIER_MS = {"packed": 38.573, "pairs": 60.087,
                          "stats": 60.164}


def phase_frontier(name: str, encs: list) -> dict:
    """Phase 28: knossos_frontier_scan against its plain versions on
    the card over the shape sweep, then conc-20's frontier histories
    (`encs`, from phase 8) timed in each variant. Returns the kernel's
    record for the kernels line (launches filled in by main)."""
    from jepsen_tpu_torch.tools import knossos_frontier_check as kfc

    t0 = time.perf_counter()
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(
        DEVICE)
    lines = kfc.check_cases(dev)
    for ln in lines:
        say(f"28 (a) {ln}")
    t_cases = time.perf_counter() - t0
    say(f"28 (a) knossos_frontier_scan == its plain versions on {len(lines)}"
        f" case variants ({len(kfc.CASES) + 1} batches), valid, overflow, "
        f"rounds, peak and explored exact; {t_cases:.1f}s")
    timed = kfc.time_variants(dev, name, encs)
    for label, rec in timed.items():
        say(f"28 (b) conc-20's {rec['B']} frontier histories (F={rec['F']}, "
            f"S={rec['S']}, E={rec['E']}), {label}, {rec['tier']} tier "
            f"({rec['threads']} threads x {rec['keys']} keys): "
            f"kernel median {rec['ms']} ms [block-sort walk: "
            f"{BLOCK_SORT_FRONTIER_MS[label]} ms], plain {rec['plain_ms']} "
            f"ms, "
            f"{rec['rounds']} rounds (equal), the slowest history's "
            f"{rec['slowest_rounds']} at {rec['us_per_round']:.3f} us a "
            f"round, ptxas {rec.get('registers')} registers "
            f"{rec.get('spill_bytes')} spill bytes, bound {rec['bound_ms']} "
            f"ms ({rec['bound_by']}: {rec['compares']} compares, "
            f"{rec['bytes']} B); every output equal")
    many = {label: kfc.throughput(dev, encs, label == "packed")
            for label in ("packed", "pairs") if label in timed}
    for label, ms in many.items():
        say(f"28 (b) conc-20's frontier histories repeated to "
            f"{kfc.THROUGHPUT_B}, {label}: one kernel launch {ms} ms, "
            f"outputs equal to the {len(encs)}-history launch's repeated")
    took = time.perf_counter() - t0
    say(f"phase 28 in {took:.1f}s")
    check(took < 60, f"phase 28 took {took:.1f}s")
    main = timed["packed"] if "packed" in timed else timed["pairs"]
    return {"name": "knossos_frontier_scan", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/knossos_frontier.cu",
            "replaces": "jepsen_tpu/checker/knossos/packed.py:99",
            "also_replaces": "jepsen_tpu/checker/knossos/kernels.py:172",
            "launches": None, "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "variants": timed, "throughput_ms": many}


def main() -> int:
    global torch
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (ROOT / "jepsen_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no jepsen_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import _build

    t_start = time.perf_counter()
    with phase_wall(1):
        smi = nvidia_smi()
        name = torch.cuda.get_device_name(0)
        say(f"device {name} ({smi}); torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    with phase_wall(2):
        t0 = time.perf_counter()
        # the CUDA kernels, the CPU oracle (wgl) and the history encoder
        libs = _build.build_all()
        say(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
        for lib in libs:
            print(_build.build_log(lib).strip(), flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        with phase_wall(3):
            record = phase_kernels(name)
        paths = {}
        verdicts = {}
        frontier_start()
        with phase_wall(4):
            paths["append"] = phase_main()
            verdicts["append"] = run_files(WORK / "store")
            phase_cli()
        with phase_wall(5):
            paths["wr"] = phase_wr()
            verdicts["wr"] = run_files(WORK / "wr")
        with phase_wall(6):
            paths["long"] = phase_long()
        with phase_wall(7):
            dense_record = phase_knossos(name)
        with phase_wall(8):
            reg = phase_register()
        dense_paths, front_paths = reg["dense"], reg["frontier"]
        with phase_wall(9):
            store_paths = phase_store()
            paths.update(store_paths["closure_square"])
            dense_paths.update(store_paths["knossos_dense_scan"])
        with phase_wall(10):
            paths.update(phase_supervisor(WORK / "mixed-pristine",
                                          store_paths["append_full"]))
        with phase_wall(11):
            tele = phase_telemetry(
                {"append": paths["append"][0], "wr": paths["wr"][0],
                 "long": paths["long"][0],
                 "register": dense_paths["register"][0]}, dense_record)
        for kind in ("append", "wr", "long", "register"):
            (dense_paths if kind == "register" else paths)[
                f"stats-{kind}"] = (tele[kind]["launches"],
                                    tele[kind]["device_ms"])
        with phase_wall(12):
            paths.update(phase_native(
                {"append": paths["append"][0], "wr": paths["wr"][0]},
                verdicts)["paths"])
        verdicts["register"] = run_files(WORK / "reg")
        with phase_wall(13):
            pool = phase_pool({"append": paths["append"][0],
                               "wr": paths["wr"][0],
                               "register": dense_paths["register"][0]},
                              verdicts)
        paths.update(pool["closure_square"])
        dense_paths.update(pool["knossos_dense_scan"])
        with phase_wall(14, say_it=False):
            single = phase_analyze(smi)
        paths.update(single["closure_square"])
        dense_paths.update(single["knossos_dense_scan"])
        with phase_wall(15, say_it=False):
            paths.update(phase_costdb(
                {"append": paths["append"][0], "wr": paths["wr"][0]},
                verdicts, name)["paths"])
        with phase_wall(16, say_it=False):
            paths.update(phase_serve(verdicts)["paths"])
        with phase_wall(17, say_it=False):
            phase_fleet(verdicts)
        with phase_wall(18, say_it=False):
            paths.update(phase_mesh(verdicts, name, smi)["paths"])
        with phase_wall(19, say_it=False):
            tested = phase_test(smi)
        paths.update(tested["closure_square"])
        dense_paths.update(tested["knossos_dense_scan"])
        with phase_wall(20, say_it=False):
            suites = phase_suites(smi)
        paths.update(suites["closure_square"])
        dense_paths.update(suites["knossos_dense_scan"])
        with phase_wall(21, say_it=False):
            baseline = phase_baseline(smi)
        paths.update(baseline["closure_square"])
        dense_paths.update(baseline["knossos_dense_scan"])
        for n, runs in ((22, MORE_RUNS), (23, QUEUE_RUNS),
                        (24, WIRE_RUNS), (25, LAST_RUNS)):
            with phase_wall(n, say_it=False):
                more = drive_suites(n, runs, smi)
            paths.update(more["closure_square"])
            dense_paths.update(more["knossos_dense_scan"])
        with phase_wall(26, say_it=False):
            paths.update(phase_scripts(WORK / "reg")["closure_square"])
        with phase_wall(27, say_it=False):
            several = phase_devices(name, verdicts)
        paths.update(several["closure_square"])
        dense_paths.update(several["knossos_dense_scan"])
        front_paths.update(several["knossos_frontier_scan"])
        record["column_blocks"] = several["blocks"]
        # every other frontier launch of phases 4-27 (a frontier key of
        # a sweep, a fan-out or a suite)
        total, total_ms = frontier_stop()
        check(total > 0, "phases 4-27 never launched knossos_frontier_scan")
        front_paths["phases 4-27 other"] = (
            total - sum(n for n, _ in front_paths.values()),
            total_ms - sum(ms for _, ms in front_paths.values()))
        with phase_wall(28, say_it=False):
            front_record = phase_frontier(name, reg["frontier_encs"])
        for rec, ps in ((record, paths), (dense_record, dense_paths),
                        (front_record, front_paths)):
            rec["launches"] = sum(n for n, _ in ps.values())
            rec["paths"] = {k: {"launches": n, "device_ms": ms}
                            for k, (n, ms) in ps.items()}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        killed = stop_children()
    if killed:
        say(f"killed what would not end by itself: {killed}")
    check(not child_pids(), f"children left running: {child_pids()}")
    deadline = time.monotonic() + 10
    while any(alive(p) for p in GRANDCHILDREN):
        check(time.monotonic() < deadline, "grandchildren left running: "
              f"{[p for p in GRANDCHILDREN if alive(p)]}")
        time.sleep(0.05)
    say(f"phase walls (s): {json.dumps(WALLS)}")
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [record, dense_record, front_record]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
