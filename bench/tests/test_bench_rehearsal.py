"""The harness end to end on the CPU at small sizes (the program's plain
kernels, a tiny model of each family), without the look for a card; the
command's refusal without a card; and the run's isolation from JAX and
the JAX package, in its modules and in the benchmark's sources."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, spec

ROOT = spec.ROOT
#: small models of each family, in float32 (weights, activations and the
#: KV cache): there the program's plain path and the reference agree to
#: round-off, so a run is correct by the cells' own limits and a broken
#: path is not
F32 = {"torch_dtype": "float32"}
PROGRAM_F32 = {"param_dtype": "float32", "dtype": "float32",
               "cache_dtype": "float32"}
SMALL_MOE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                 head_dim=16, intermediate_size=128, num_local_experts=4,
                 vocab_size=256, num_hidden_layers=2, **F32,
                 program={"capacity_factor": 1.25, "moe_seq_chunk": 512,
                          "prefill_bucket_min": 16, **PROGRAM_F32})
SMALL_RWKV = dict(hidden_size=128, intermediate_size=256, vocab_size=256,
                  num_hidden_layers=2, **F32,
                  program={"rwkv_chunk": 16, **PROGRAM_F32})
#: a vocabulary of 4096, as wide a spread of logits as the cells' own
#: (their limits are set there), and for training so that a batch's
#: rows touch distinct rows of the embedding, as at full size
SMALL_RWKV = {**SMALL_RWKV, "vocab_size": 4096}
CHAT = {"lead_in_s": 0.5, "drain_s": 60.0, "slots": 8, "max_len": 600,
        "prompt": {"median": 40, "sigma": 1.0, "min": 8, "max": 300},
        "output": {"median": 10, "sigma": 0.8, "min": 4, "max": 30},
        "arrivals": {"process": "poisson", "rate": 8.0},
        "warmup_prompts": [8, 64, 512], "trace_s": 1.0}
TRAIN = {"batch": 2, "seq_len": 32, "trace_s": 0.5}
RUNS = {"mixtral-8x22b.chat": (SMALL_MOE, CHAT),
        "rwkv6-7b.train": (SMALL_RWKV, TRAIN)}


class Meter:
    """Stands in for the card's energy counter: 300 W of wall time."""

    def joules(self) -> float:
        return time.perf_counter() * 300.0


def rehearse(cell: str, trace: bool = False, seed: int = 2**31 + 5,
             seconds: float = 2.0) -> dict:
    """One run of ``cell`` at its small size on the CPU, on two threads
    (the test workers share the machine's cores)."""
    sizes, traffic = RUNS[cell]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run(cell, seed, seconds, trace, device="cpu",
                           energy=Meter(), sizes=sizes, traffic=traffic)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", list(RUNS))
def test_a_run_on_the_cpu(cell):
    line = rehearse(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    json.dumps(line)


@pytest.mark.parametrize("cell", ["mixtral-8x22b.chat", "rwkv6-7b.train"])
def test_a_traced_run_on_the_cpu(cell):
    line = rehearse(cell, trace=True)
    assert line["correct"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert set(line["metrics"]) <= names
    assert line["metrics"]


def test_the_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "mixtral-8x22b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _top_level_imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return {n.split(".")[0] for n in names}


SOURCES = sorted((ROOT / "bench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "frozen"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in (ROOT / "bench" / sub).rglob("*.py"):
        assert "repro_torch" not in _top_level_imports(path), path


def test_a_rehearsal_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from bench.tests.test_bench_rehearsal import rehearse\n"
        "from bench.harness import FORBIDDEN\n"
        "line = rehearse('mixtral-8x22b.chat', seconds=1.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
        " & set(FORBIDDEN))), line['correct'])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[-2] == "[] True"
