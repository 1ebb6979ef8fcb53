"""``correct`` comes out false when the timed path is broken underneath:
a run on the CPU at small sizes in float32 (the look for a card
skipped), with one fault planted in the program for each fault its cell
can have — a token altered where it is produced, a step that leaves its
state unchanged, half of the batch left out — judged by the limits the
cells' traffic files fix; and the comparison sees the control, the plain
reference in float8 in the program's place."""

import pytest
import torch

from bench import program, spec
from bench.drivers import serve, train
from bench.model import dims
from bench.tests.test_bench_rehearsal import RUNS, rehearse

program.import_program()
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.train import steps  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _limits(cell):
    return spec.load_cell(cell).traffic["check"]["limits"]


@pytest.fixture
def altered_tokens(monkeypatch):
    """The decode step's logits rolled by one along the vocabulary: every
    token it produces is the one after the program's choice."""
    decode = engine_mod.ServingEngine._decode

    def rolled(self, *args):
        logits, cache = decode(self, *args)
        return torch.roll(logits, 1, dims=-1), cache
    monkeypatch.setattr(engine_mod.ServingEngine, "_decode", rolled)


@pytest.fixture
def frozen_state(monkeypatch):
    """The decode step reads its state but never writes it: each step
    runs on a copy of the cache, which is dropped."""
    decode = engine_mod.ServingEngine._decode

    def stale(self, params, tokens, pos, cache):
        copy = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        return decode(self, params, tokens, pos, copy)[0], cache
    monkeypatch.setattr(engine_mod.ServingEngine, "_decode", stale)


@pytest.mark.parametrize("fault", ["altered_tokens", "frozen_state"])
def test_a_broken_serving_path_is_not_correct(fault, request):
    request.getfixturevalue(fault)
    line = rehearse("mixtral-8x22b.chat")
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.fixture
def unchanged_update(monkeypatch):
    """``apply_update`` returns the state it was given and moves no
    weight."""
    def still(params, opt_state, step, grads, cfg, opt_cfg, step_cfg):
        return opt_state, torch.zeros(()), torch.zeros(())
    monkeypatch.setattr(steps, "apply_update", still)


@pytest.fixture
def half_batch(monkeypatch):
    """``grads_of`` takes the first half of each batch's rows alone, the
    mean over them."""
    grads_of = steps.grads_of

    def halved(params, cfg, batch, step_cfg):
        b = batch["tokens"].shape[1] // 2
        return grads_of(params, cfg, {k: v[:, :b] for k, v in batch.items()},
                        step_cfg)
    monkeypatch.setattr(steps, "grads_of", halved)


@pytest.mark.parametrize("fault", ["unchanged_update", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, request):
    request.getfixturevalue(fault)
    line = rehearse("rwkv6-7b.train")
    assert not line["correct"]
    limits = _limits("rwkv6-7b.train")
    assert any(c["value"] > limits[k] for k, c in line["checks"].items())


def test_the_serving_control_is_seen():
    """The float8 reference, put in the program's place at each position
    of the program's own served requests, gives tokens that the
    comparison finds below the float32 reference's best, where the
    program's own tokens (float32 at this size) lie on it.  (At the
    cells' own sizes on the card the control reads above each limit:
    PERF.md gives the readings.)"""
    cell = "mixtral-8x22b.chat"
    sizes, traffic = RUNS[cell]
    c = spec.load_cell(cell)
    c.traffic.update(traffic)
    d = dims(c.config, **sizes)
    ctx = _ctx(c, d)
    sut = serve.build(ctx)
    serve.warm(sut, ctx)
    from bench.traffic import schedule
    rec = serve.drive(sut, ctx, schedule(c.traffic, ctx.seed, 2.0, d.vocab),
                      2.0)
    serve.free(sut, ctx.device)
    picked = serve.sample(rec["done"], ctx.seed, c.traffic["check"])
    got = serve.compare(d, ctx.seed, ctx.device, picked, control=True)
    assert all(got[k] <= v for k, v in _limits(cell).items())
    assert got["max_logit_gap"] < 1e-3 and got["mean_logit_gap"] < 1e-4
    assert got["control_gap"] > 0.1 and got["control_mean_gap"] > 0.01
    assert got["control_tokens_off"] > 0.1


@pytest.mark.parametrize("precision", ["fp8", "fp8_forward"])
def test_the_train_control_is_seen(precision):
    """The float8 reference read against the float32 one: each number
    the cell compares stands off by a hundred times what the program's
    does (float32 at this size); with float8 in the forward products
    alone (float32 gradients), the first step's logits do.  (At the
    cell's own size on the card both controls read above the limit of
    ``logit_rel_err``, and ``bench.tools.calibrate`` exits with 1 if a
    control passes the cell's limits: PERF.md gives the readings.)"""
    sizes, traffic = RUNS["rwkv6-7b.train"]
    c = spec.load_cell("rwkv6-7b.train")
    c.traffic.update(traffic)
    d = dims(c.config, **sizes)
    ctx = _ctx(c, d)
    job = c.traffic
    batches = [train.batch_tokens(ctx.seed, i, job["batch"], job["seq_len"],
                                  d.vocab, ctx.device)
               for i in range(job["check_steps"])]
    keep = train.positions(ctx.seed, job["batch"], job["seq_len"],
                           job["check"]["positions"])
    ref_mod = program.reference(d)
    ref = ref_mod.train_steps(d, ctx.seed, ctx.device, batches, job,
                              positions=keep)
    low = train.compare(ref_mod.train_steps(d, ctx.seed, ctx.device,
                                            batches, job, precision,
                                            positions=keep), ref)
    prog = train.compare(train.run_steps(ctx), ref)
    limits = _limits("rwkv6-7b.train")
    for k in limits:
        assert prog[k] <= limits[k]
    kept = limits if precision == "fp8" else ["logit_rel_err"]
    for k in kept:
        assert low[k] > 100 * prog[k], (k, low[k], prog[k])


def _ctx(cell, d):
    from bench.harness import Context
    from bench.trace import Tracer
    from bench.tests.test_bench_rehearsal import Meter
    import time
    device = torch.device("cpu")
    return Context(cell, d, 2**31 + 9, 2.0, device, Tracer(False, device),
                   Meter(), time.perf_counter())
