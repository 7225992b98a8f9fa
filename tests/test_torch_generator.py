"""The port's generator DSL, `independent`'s generators and the
workloads' generators give the reference's operations, op for op.

The generators draw from the module-level `random`, so each case seeds
it, drives the reference's generator through a simulated run, seeds it
again and drives the port's: the histories must be identical. The
simulation is `tests/gen_sim.py`'s `simulate` (the reference's
pure_test.clj executors: no threads, fixed latencies), copied here with
the generator module as a parameter.
"""

import heapq
import itertools
import random
from types import SimpleNamespace

import pytest

import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.workloads.append as ref_append
import jepsen_tpu.workloads.bank as ref_bank
import jepsen_tpu.workloads.long_fork as ref_long_fork
import jepsen_tpu.workloads.register as ref_register
import jepsen_tpu.workloads.wr as ref_wr
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.workloads.append as port_append
import jepsen_tpu_torch.workloads.bank as port_bank
import jepsen_tpu_torch.workloads.long_fork as port_long_fork
import jepsen_tpu_torch.workloads.register as port_register
import jepsen_tpu_torch.workloads.wr as port_wr

MS = 1_000_000

REF = SimpleNamespace(gen=ref_gen, ind=ref_ind, append=ref_append,
                      wr=ref_wr, register=ref_register, bank=ref_bank,
                      long_fork=ref_long_fork)
PORT = SimpleNamespace(gen=port_gen, ind=port_ind, append=port_append,
                       wr=port_wr, register=port_register, bank=port_bank,
                       long_fork=port_long_fork)


def perfect(op):
    return {**op, "type": "ok", "time": op["time"] + 10 * MS}


def perfect_info(op):
    return {**op, "type": "info", "time": op["time"] + 10 * MS}


def make_imperfect():
    cycle = itertools.cycle([("ok", 10), ("info", 20), ("fail", 30)])

    def imperfect(op):
        t, lat = next(cycle)
        return {**op, "type": t, "time": op["time"] + lat * MS}

    return imperfect


COMPLETIONS = {"perfect": lambda: perfect,
               "perfect_info": lambda: perfect_info,
               "imperfect": make_imperfect}


def simulate(gen, g, completion_fn, concurrency=2, max_steps=100_000,
             test=None):
    """`tests/gen_sim.py`'s simulate over the generator module `gen`:
    run g to exhaustion against fixed-latency completions; returns the
    history (invokes and completions interleaved by time). `test` is
    the test map the generator sees (its concurrency is set here)."""
    test = {**(test or {}), "concurrency": concurrency}
    ctx = gen.Context.for_test(test)
    history: list = []
    inflight: list = []  # heap of (time, seq, completion-op)
    tiebreak = itertools.count()

    def apply_completion():
        nonlocal ctx, g
        t, _, comp = heapq.heappop(inflight)
        thread = ctx.process_to_thread(comp["process"])
        ctx = ctx.with_time(t).free(thread)
        if thread != gen.NEMESIS and comp.get("type") == "info":
            ctx = ctx.with_worker(thread, ctx.next_process(thread))
        g = gen.update(g, test, ctx, comp)
        history.append(comp)

    for _ in range(max_steps):
        res = gen.op(g, test, ctx)
        if res is None:
            if not inflight:
                return history
            apply_completion()
            continue
        o, g2 = res
        if o is gen.PENDING:
            if not inflight:
                raise RuntimeError("generator pending forever (deadlock)")
            apply_completion()
            continue
        if inflight and inflight[0][0] <= o.get("time", ctx.time):
            apply_completion()
            continue
        thread = ctx.process_to_thread(o.get("process"))
        ctx = ctx.with_time(o["time"]).busy(thread)
        g = gen.update(g2, test, ctx, o)
        history.append(o)
        comp = completion_fn(o)
        if comp is not None:
            heapq.heappush(inflight, (comp["time"], next(tiebreak), comp))
    raise RuntimeError("simulation did not terminate")


def w(test=None, ctx=None):
    return {"f": "write", "value": random.randint(0, 4)}


def cas(test=None, ctx=None):
    return {"f": "cas", "value": [random.randint(0, 4),
                                  random.randint(0, 4)]}


def nemesis_cycle(G):
    return G.cycle([G.sleep(0.05), {"f": "start"}, G.sleep(0.05),
                    {"f": "stop"}])


#: name -> (concurrency, builder of the generator from a package)
SCENARIOS = {
    "mix-limit": (3, lambda P: P.gen.limit(30, P.gen.mix(
        [P.gen.repeat_gen({"f": "read"}), w, cas]))),
    "clients-nemesis": (3, lambda P: P.gen.clients(
        P.gen.limit(20, w), P.gen.limit(6, nemesis_cycle(P.gen)))),
    "time-limit-stagger": (2, lambda P: P.gen.time_limit(
        0.5, P.gen.stagger(0.01, w))),
    "delay": (3, lambda P: P.gen.limit(20, P.gen.delay(0.02, w))),
    "phases": (3, lambda P: P.gen.phases(
        P.gen.limit(5, w), P.gen.once({"f": "read"}), P.gen.limit(5, cas))),
    "each-thread": (3, lambda P: P.gen.each_thread(P.gen.limit(3, w))),
    "reserve": (4, lambda P: P.gen.reserve(
        1, P.gen.limit(10, {"f": "read"}), P.gen.limit(10, w))),
    "until-ok": (2, lambda P: P.gen.limit(
        20, P.gen.until_ok(P.gen.repeat_gen(w)))),
    "process-limit": (2, lambda P: P.gen.limit(
        40, P.gen.process_limit(3, P.gen.repeat_gen(w)))),
    "flip-flop": (2, lambda P: P.gen.limit(
        10, P.gen.flip_flop(w, {"f": "read"}))),
    "filter-f-map": (2, lambda P: P.gen.limit(15, P.gen.f_map(
        {"write": "put"}, P.gen.filter_gen(
            lambda o: o["value"] != 2, P.gen.repeat_gen(w))))),
    "then-any": (3, lambda P: P.gen.then(P.gen.once({"f": "read"}),
                                         P.gen.any_gen(
        P.gen.limit(5, w), P.gen.limit(5, {"f": "read"})))),
    "log-sleep-seq": (2, lambda P: [P.gen.log_gen("hi"),
                                    P.gen.sleep(0.01), P.gen.limit(3, w)]),
    "suite-shape": (3, lambda P: P.gen.phases(
        P.gen.time_limit(0.3, P.gen.clients(
            P.gen.stagger(0.005, w), nemesis_cycle(P.gen))),
        P.gen.clients(P.gen.once({"f": "read"})))),
    "independent-sequential": (2, lambda P: P.ind.sequential_generator(
        range(3), lambda k: P.gen.limit(4, w))),
    "independent-concurrent": (4, lambda P: P.gen.clients(
        P.ind.concurrent_generator(2, range(5), lambda k: P.gen.limit(
            6, P.register.rand_op)))),
    "append": (3, lambda P: P.gen.limit(40, P.append.generator())),
    "wr": (3, lambda P: P.gen.limit(40, P.wr.generator(seed=3))),
    "register": (4, lambda P: P.register.test(
        threads_per_key=2, key_count=4, ops_per_key=10)["generator"]),
    "bank": (3, lambda P: P.gen.limit(40, P.bank.generator())),
    "long-fork": (3, lambda P: P.gen.limit(40, P.long_fork.generator(3))),
}


def run_both(scenario: str, completion: str, seed: int):
    conc, build = SCENARIOS[scenario]
    out = []
    for pkg in (REF, PORT):
        random.seed(seed)
        out.append(simulate(pkg.gen, build(pkg),
                            COMPLETIONS[completion](), concurrency=conc))
    return out


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("completion", sorted(COMPLETIONS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_simulated_history_equals_reference(scenario, completion, seed):
    ref, port = run_both(scenario, completion, seed)
    assert ref, "the reference's generator produced nothing"
    assert port == ref


def test_independent_values_are_the_ports_tuples():
    _, port = run_both("independent-concurrent", "perfect", 0)
    keyed = [o for o in port if o["type"] == "invoke"]
    assert keyed and all(isinstance(o["value"], port_ind.Tuple)
                         for o in keyed)


def test_generator_contract_violations_raise_alike():
    """Validate rejects an op for a busy process in both packages."""
    for G in (ref_gen, port_gen):
        ctx = G.Context.for_test({"concurrency": 1}).busy(0)
        bad = G.Validate(lambda: {"f": "read", "process": 0, "time": 0})
        with pytest.raises(ValueError, match="is not free"):
            G.op(bad, {}, ctx)
