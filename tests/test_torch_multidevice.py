"""The port's several devices against the reference's, on the CPU.

The reference runs on the conftest's 8 virtual XLA CPU devices; the
port on meshes of the CPU device repeated (`parallel.Mesh` may repeat a
device), which take every path a mesh of distinct cards takes but the
copies between them. The same inputs, made from a seed, go through both:

  * the mesh builders (`factor2`, `make_mesh`, `sp_mesh`,
    `host_local_mesh`): shapes and axis names for 1 to 8 devices;
  * `check_bucketed` over `make_mesh([cpu]*8)` (4×2) against the
    reference's over `make_mesh()` and the port's one-device result,
    ragged buckets, a bucket whose dp padding passes the budget (the
    unsharded branch), the two-pass strategy, and `stats_out`;
  * `closure_square_ref`'s column blocks at mp=2 and mp=4 stitched into
    the full round, `changed` and the active word ORed across the row;
  * `check_long_history` over `sp_mesh([cpu]*4)`, dense and condensed;
  * `check_edge_batch`/`_bucketed`, the elle `check_encoded_batch`, the
    register tiers (dense, frontier, packed) and `check_condensed` with
    `devices=[cpu]*3` (a ragged split) against the reference's 3
    devices;
  * `FoldDispatcher(mesh=)` against the reference's;
  * `tools/multihost_dryrun.py`'s one-process part over a repeated
    mesh;
  * the distributed route: `init_distributed` and two processes joined
    through it (`tools/multihost_dryrun.py`): shard identity 0/2 and
    1/2, the global-dp flags, and `analyze-store --mesh` with no shard
    count byte-identical to the reference's one-process sweep of the
    same store. Each job is bounded by its own 55 s timeout.

Tolerance: exact equality of flags, verdict dicts, stats rows, shapes
and file bytes."""

import os
import shutil
import socket

import jax
import numpy as np
import pytest
import torch

import jepsen_tpu.parallel as r_parallel
from jepsen_tpu.checker.elle import condense as r_condense
from jepsen_tpu.checker.elle import encode as r_encode
from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.checker.knossos import dense as rdense
from jepsen_tpu.checker.knossos import encode as renc
from jepsen_tpu.checker.knossos import kernels as rker
from jepsen_tpu.parallel import folding as r_folding
from jepsen_tpu_torch import convert, devices, mesh, parallel
from jepsen_tpu_torch.checker.elle import closure_square as cs
from jepsen_tpu_torch.checker.elle import condense
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.checker.knossos import dense as pdense
from jepsen_tpu_torch.checker.knossos import kernels as pker
from jepsen_tpu_torch.parallel import folding
from jepsen_tpu_torch.tools import multihost_dryrun as mh
from test_torch_knossos import dense_population, frontier_population
from test_torch_wr import edge_dicts

CPU = torch.device("cpu")
#: Each joined job's bound, seconds.
JOB_TIMEOUT_S = 55.0


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path / "aot"))
    monkeypatch.setenv("JEPSEN_TPU_DONATE_BUFFERS", "0")
    # the joined jobs' CLI processes ingest serially: no spawned pool of
    # a worker a core beside the rest of the suite
    monkeypatch.setenv("JEPSEN_TPU_PIPELINE", "0")


def port_encs(ref_encs):
    return [convert.encoded_from_arrays(
        **{f: getattr(e, f) for f in convert.ENCODED_FIELDS})
        for e in ref_encs]


@pytest.fixture(scope="module")
def encodings():
    """Reference encodings of ragged lengths, every third one cyclic."""
    hists = [synth.synth_append_history(T, 8, seed=i, g1c=i % 3 == 0)
             for i, T in enumerate((40, 90, 150, 60, 200, 300, 260, 500,
                                    30))]
    return [r_encode.encode_history(h) for h in hists]


# -- the mesh builders ---------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_are_the_reference_s(n, monkeypatch):
    assert parallel.factor2(n) == r_parallel.factor2(n)
    devs = jax.devices()[:n]
    got, want = parallel.make_mesh([CPU] * n), r_parallel.make_mesh(devs)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert parallel.sp_mesh([CPU] * n).devices.shape == \
        r_parallel.sp_mesh(devs).devices.shape
    monkeypatch.setattr(devices, "default_devices",
                        lambda requested=None: [CPU] * n)
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: devs)
    assert parallel.host_local_mesh("cpu").devices.shape == \
        r_parallel.host_local_mesh().devices.shape


def test_mesh_rows_and_default_devices():
    m = parallel.make_mesh([CPU] * 6)
    assert [len(r) for r in m.rows()] == [2, 2, 2]
    assert m.distinct() == [CPU] and m.size == 6
    assert parallel.sp_mesh([CPU] * 6).devices.shape == (1, 6)
    assert devices.default_devices("cpu") == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(devices.DeviceUnavailable):
            devices.default_devices()
        with pytest.raises(devices.DeviceUnavailable):
            parallel.make_mesh()
    with pytest.raises(ValueError):
        parallel.Mesh([[CPU, CPU], [CPU]])


def test_dp_mesh_is_a_row_for_each_distinct_device():
    """The mesh the port's own sweeps and folds build: dp alone, each
    device once (a repeated list is the single-device path)."""
    m = parallel.dp_mesh(["cuda:0", "cuda:1", "cuda:0", "cuda:2"])
    assert m.shape == {"dp": 3, "mp": 1}
    assert m.rows() == [[torch.device(f"cuda:{k}")] for k in range(3)]
    assert parallel.dp_mesh([CPU] * 8).devices.shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(devices.DeviceUnavailable):
            parallel.dp_mesh()


def test_a_sweep_makes_its_copy_streams_up_front():
    """The pack-h2d thread and the calling thread only look the copy
    streams up; the CPU has none."""
    sw = parallel._Sweep([], CPU, {}, None, mesh=parallel.make_mesh(
        [CPU] * 4))
    assert sw.streams == {} and sw.copy_stream(CPU) is None


# -- the bucketed dispatch over a dp×mp mesh ----------------------------------

@pytest.mark.parametrize("budget_cells, fused", [
    (1 << 27, True),            # one bucket, padded to 12
    (4 * 512 * 512, True),      # ragged buckets and oversized singletons
    (2 * 384 * 384, True),      # a singleton whose padding passes the budget
    (4 * 512 * 512, False),     # the two-pass strategy
], ids=["one-bucket", "ragged", "unsharded", "two-pass"])
def test_check_bucketed_over_a_mesh_is_the_reference_s(
        encodings, budget_cells, fused):
    rs: list = []
    want = r_parallel.check_bucketed(encodings, r_parallel.make_mesh(),
                                     budget_cells=budget_cells,
                                     fused=fused, stats_out=rs)
    ps: list = []
    log: list = []
    encs = port_encs(encodings)
    got = parallel.check_bucketed(encs, mesh=parallel.make_mesh([CPU] * 8),
                                  budget_cells=budget_cells, fused=fused,
                                  stats_out=ps, bucket_log=log)
    assert got == want
    assert ps == rs
    assert got == parallel.check_bucketed(encs, CPU,
                                          budget_cells=budget_cells,
                                          fused=fused)
    assert [bool(c) for c in got] == [i % 3 == 0 for i in range(len(got))]
    assert sum(b["histories"] for b in log) >= len(encs)
    # 4 rows × (2 column blocks where T_pad has two tiles, else 1)
    steps = {b["t_pad"]: K.closure_steps(b["t_pad"]) for b in log}
    assert all(b["launches"] % steps[b["t_pad"]] == 0 for b in log)


def test_a_mesh_of_one_device_is_the_single_device_path(encodings):
    one = parallel.Mesh([[CPU]])
    log_m: list = []
    log_d: list = []
    encs = port_encs(encodings)
    assert parallel.check_bucketed(encs, mesh=one, bucket_log=log_m) == \
        parallel.check_bucketed(encs, CPU, bucket_log=log_d)
    assert [(b["histories"], b["t_pad"], b["launches"]) for b in log_m] == \
        [(b["histories"], b["t_pad"], b["launches"]) for b in log_d]


def test_mesh_dispatch_counts_its_launches(encodings, monkeypatch):
    """Each row launches `closure_steps` rounds of every closure, once a
    column block: the bucket log's launches are the squarings made."""
    calls: list = []
    real = cs.closure_square

    def counting(m, mT, active=None, cols=None):
        calls.append(cols)
        return real(m, mT, active, cols)

    monkeypatch.setattr(cs, "closure_square", counting)
    log: list = []
    parallel.check_bucketed(port_encs(encodings)[:4],
                            mesh=parallel.make_mesh([CPU] * 4),
                            bucket_log=log)
    assert sum(b["launches"] for b in log) == len(calls)
    assert {c for c in calls} <= {(0, 256), (256, 512), (0, 128), None}
    assert any(c is not None for c in calls)


def test_mesh_costdb_window_is_keyed_as_a_mesh(encodings, monkeypatch,
                                               tmp_path):
    from jepsen_tpu_torch.obs import device as obs_device
    monkeypatch.setenv("JEPSEN_TPU_COSTDB", "1")
    obs_device.reset()
    try:
        parallel.check_bucketed(port_encs(encodings)[:3],
                                mesh=parallel.make_mesh([CPU] * 8))
        recs = obs_device.records()
    finally:
        obs_device.reset()
    assert recs and all(r["windows"]["dispatches"] >= 1 for r in recs)
    assert {r["geometry"]["B"] % 4 for r in recs} == {0}   # padded batch
    # the reference's mesh key: the hand kernel, never use_pallas
    shape = K.BatchShape(128, 8, 8, 8, 8)
    cuda = torch.device("cuda")
    assert obs_device.dispatch_cost_key({}, shape, False, cuda,
                                        single_device=False)[4:6] == \
        (False, True)
    assert obs_device.dispatch_cost_key({}, shape, False, cuda)[4:6] == \
        (True, True)


# -- the column-range squaring ------------------------------------------------

@pytest.mark.parametrize("T, mp", [(384, 2), (640, 2), (640, 4),
                                   (1280, 4), (128, 2)])
@pytest.mark.parametrize("word", [None, 1, 0], ids=["none", "on", "off"])
def test_column_blocks_stitch_into_the_full_round(T, mp, word):
    g = torch.Generator().manual_seed(T * 10 + mp)
    m = (torch.rand((2, T, T), generator=g) < 3.0 / T) | torch.eye(
        T, dtype=torch.bool)
    mT = m.transpose(1, 2).contiguous()

    def pair():
        return None if word is None else torch.tensor([word, 0],
                                                      dtype=torch.int32)

    full_act = pair()
    full, fullT, fch = cs.closure_square_ref(m, mT, full_act)
    blocks = cs.column_blocks(T, mp)
    assert blocks[0][0] == 0 and blocks[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    out, outT = torch.zeros_like(m), torch.zeros_like(m)
    ch = torch.zeros(2, dtype=torch.bool)
    act_or = 0
    for c0, c1 in blocks:
        if c0 == c1:
            continue
        act = pair()
        o, oT, c = cs.closure_square(m, mT, act, cols=(c0, c1))
        out[:, :, c0:c1] = o[:, :, c0:c1]
        outT[:, c0:c1] = oT[:, c0:c1]
        ch |= c
        if act is not None:
            assert int(act[0]) == word
            act_or |= int(act[1])
    assert torch.equal(out, full) and torch.equal(outT, fullT)
    assert torch.equal(ch, fch)
    if word is not None:
        assert act_or == int(full_act[1])


def test_a_bad_column_range_raises():
    m = torch.eye(384, dtype=torch.bool)[None]
    for cols in [(0, 128), (128, 384), (256, 256), (0, 512)]:
        with pytest.raises(ValueError, match="column"):
            cs.closure_square(m, m.clone(), cols=cols)
    assert K.mp_parts(384, 4) == 2 and K.mp_parts(5120, 4) == 4


# -- long histories over sp_mesh ------------------------------------------------

@pytest.mark.parametrize("g1c", [False, True])
def test_check_long_history_over_sp_mesh(g1c):
    h = synth.synth_append_history(700, 16, seed=3, g1c=g1c)
    renc_ = r_encode.encode_history(h)
    (enc,) = port_encs([renc_])
    rs: list = []
    want = r_parallel.check_long_history(renc_, r_parallel.sp_mesh(),
                                         stats_out=rs)
    ps: list = []
    got = parallel.check_long_history(enc, mesh=parallel.sp_mesh([CPU] * 4),
                                      stats_out=ps)
    assert got == want == parallel.check_long_history(enc, CPU)
    assert ps == rs
    assert bool(got) == g1c


@pytest.mark.parametrize("seed", range(4))
def test_check_long_history_condensed_over_devices(seed):
    """Past the dense limit the SCCs go over the mesh's devices."""
    from test_torch_condense import corrupted
    renc_ = corrupted(seed, n_txns=120)
    (enc,) = port_encs([renc_])
    want = r_parallel.check_long_history(renc_, r_parallel.sp_mesh(
        jax.devices()[:3]), dense_limit=64)
    got = parallel.check_long_history(enc, mesh=parallel.sp_mesh([CPU] * 3),
                                      dense_limit=64)
    assert got == want
    assert got == condense.check_condensed(enc, CPU,
                                           devices=[CPU] * 3)
    assert got == r_condense.check_condensed(renc_,
                                             devices=jax.devices()[:3])


# -- 1-D dp splits: edge batches, encoded batches, registers ---------------------

@pytest.mark.parametrize("seed", range(2))
def test_check_edge_batch_over_devices(seed):
    hists = edge_dicts(seed, n=7)
    rs: list = []
    want = RK.check_edge_batch(hists, devices=jax.devices()[:3],
                               stats_out=rs)
    ps: list = []
    got = K.check_edge_batch(hists, devices=[CPU] * 3, stats_out=ps)
    assert got == want == K.check_edge_batch(hists, CPU)
    assert ps == rs


@pytest.mark.parametrize("budget_cells", [1 << 27, 1 << 17])
def test_check_edge_batch_bucketed_over_devices(budget_cells):
    hists = edge_dicts(5, n=8)
    rs: list = []
    want = RK.check_edge_batch_bucketed(hists, devices=jax.devices()[:3],
                                        budget_cells=budget_cells,
                                        stats_out=rs)
    ps: list = []
    got = K.check_edge_batch_bucketed(hists, devices=[CPU] * 3,
                                      budget_cells=budget_cells,
                                      stats_out=ps)
    assert got == want
    assert ps == rs


def test_check_encoded_batch_over_devices(encodings):
    rs: list = []
    want = RK.check_encoded_batch(encodings, devices=jax.devices()[:3],
                                  stats_out=rs)
    ps: list = []
    got = K.check_encoded_batch(port_encs(encodings), devices=[CPU] * 3,
                                stats_out=ps)
    assert got == want
    assert ps == rs
    assert K.check_encoded_batch(port_encs(encodings), CPU) == want


def test_dense_register_tier_over_devices():
    hs = (dense_population(1, 3, n_procs=2, n_values=4)
          + dense_population(2, 4, n_procs=5, n_values=4, max_pending=5))
    rs: list = []
    want = rdense.check_encoded_dense_batch(
        [rdense.encode_dense_history(h) for h in hs],
        devices=jax.devices()[:3], stats_out=rs)
    ps: list = []
    got = pdense.check_encoded_dense_batch(
        [pdense.encode_dense_history(h) for h in hs], devices=[CPU] * 3,
        stats_out=ps)
    assert got == want and ps == rs


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_register_tier_over_devices(packed):
    hs = frontier_population()
    ref_encs = [renc.encode_register_history(h) for h in hs]
    encs = [convert.register_from_fields(
        **{f: getattr(e, f) for f in convert.REGISTER_FIELDS})
        for e in ref_encs]
    got = pker.check_encoded_batch(encs, frontier=64, devices=[CPU] * 3,
                                   packed=packed)
    assert got == rker.check_encoded_batch(
        ref_encs, frontier=64, devices=jax.devices()[:3], packed=packed)
    assert got == pker.check_encoded_batch(encs, frontier=64, device="cpu",
                                           packed=packed)


# -- serve's fold dispatcher ----------------------------------------------------

@pytest.mark.parametrize("checker", ["append", "wr"])
def test_fold_dispatcher_over_a_mesh(checker, encodings, monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_BACKEND", raising=False)
    if checker == "append":
        rencs = encodings
        pencs = port_encs(encodings)
    else:
        from jepsen_tpu.checker.elle import wr as RW
        from jepsen_tpu_torch.checker.elle import wr
        from test_torch_wr import fuzz_history
        hs = [fuzz_history(40 + i) for i in range(7)]
        rencs = [RW.encode_wr_history(h) for h in hs]
        pencs = [wr.encode_wr_history(h) for h in hs]
    want = r_folding.FoldDispatcher(mesh=r_parallel.make_mesh()).verdicts(
        rencs, checker)
    got = folding.FoldDispatcher(
        mesh=parallel.make_mesh([CPU] * 8)).verdicts(pencs, checker)
    assert got == want
    assert got == folding.FoldDispatcher(CPU).verdicts(pencs, checker)


# -- the distributed route ------------------------------------------------------

def test_init_distributed_without_an_address(monkeypatch):
    for v in mh.JOB_VARS:
        monkeypatch.delenv(v, raising=False)
    assert parallel.init_distributed() is False
    assert r_parallel.init_distributed() is False
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="JAX_NUM_PROCESSES"):
        parallel.init_distributed()


def test_multichip_dryrun_over_a_repeated_mesh():
    """The tool's one-process part (the reference's dryrun_multichip):
    every device path over `make_mesh([cpu]*6)` equal to one device."""
    got = mh.multichip("cpu,cpu,cpu,cpu,cpu,cpu")
    assert len(got) == 6 and all(ln.endswith(" ok") for ln in got)


@pytest.mark.parametrize("what", ["chip", "global"])
def test_the_dryrun_tool_runs_on_the_card_unless_told(what, monkeypatch):
    """Every device argument of the tool defaults to cuda: with no card
    it raises before any process starts, never the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(devices.DeviceUnavailable):
        mh.main(["--what", what])
    import inspect
    assert inspect.signature(mh.mesh_sweep).parameters[
        "device"].default == "cuda"


def test_an_unsharded_sweep_joins_no_job(tmp_path, monkeypatch):
    """Without `--mesh` a sweep leaves a coordinator address alone: a
    process holds only its own devices, so a joined job spreads a sweep
    through `--mesh` (a job of one would have joined at once)."""
    from jepsen_tpu_torch import cli
    for v in mh.JOB_VARS + mh.SHARD_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    mh.write_store(tmp_path / "s")
    try:
        rc = cli.main(["analyze-store", "--store", str(tmp_path / "s"),
                       "--device", "cpu"])
        assert not torch.distributed.is_initialized()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert rc == 1
    assert len(list((tmp_path / "s").glob("*/*/results.json"))) == 6


def test_two_joined_processes_take_shards_0_and_1():
    assert mh.identity(2, timeout=JOB_TIMEOUT_S) == ["SHARD_OK 0/2",
                                                     "SHARD_OK 1/2"]


def test_global_dp_flags_equal_one_process(encodings):
    lines = mh.global_dp(2, "cpu,cpu,cpu,cpu", timeout=JOB_TIMEOUT_S)
    assert [ln.split()[1] for ln in lines] == ["rank=0/2", "rank=1/2"]
    want = parallel.check_bucketed(mh.global_batch(), CPU)
    import json
    for ln in lines:
        assert "mesh=(2, 2)" in ln
        assert json.loads(ln.split("flags=", 1)[1]) == want


def test_joined_mesh_sweep_is_the_reference_one_process_sweep(
        tmp_path, monkeypatch):
    """Two processes joined through the coordinator variables run
    `analyze-store --mesh --device cpu` with no shard count: every run's
    results.json and results.edn are byte-identical to the reference's
    one-process sweep of the same store, and the coordinator exits as
    it does (the counterpart of tests/test_multihost.py::
    test_mesh_sweep_cli_two_process)."""
    from test_torch_stored import sweep
    pristine = tmp_path / "pristine"
    mh.write_store(pristine)
    ref = tmp_path / "ref"
    shutil.copytree(pristine, ref)
    for v in mh.JOB_VARS + mh.SHARD_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    one = r_parallel.make_mesh(jax.devices()[:1])
    monkeypatch.setattr(r_parallel, "make_mesh", lambda *a, **k: one)
    rc_ref = sweep("ref", ref, [])
    res = mh.mesh_sweep(2, "cpu", store=pristine, work=tmp_path / "work",
                        timeout=JOB_TIMEOUT_S)
    assert res["runs"] == 6 and res["compared"] == 12
    assert res["rcs"][0] == res["rc"] == rc_ref == 1
    for d in sorted(ref.glob("*/*")):
        if (d / "history.jsonl").is_file():
            rel = d.relative_to(ref)
            for art in ("results.json", "results.edn"):
                assert (res["mesh"] / rel / art).read_bytes() == \
                    (d / art).read_bytes(), (rel, art)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_join_nobody_answers_raises(monkeypatch):
    monkeypatch.setattr(parallel, "JOIN_TIMEOUT_S", 2.0)
    monkeypatch.delenv("JEPSEN_TPU_MESH_SHARDS", raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="mesh shard identity "
                       "unresolvable.*JEPSEN_TPU_MESH_SHARDS"):
        mesh.resolve_shard()
    assert not torch.distributed.is_initialized()
