"""The port's dry run (``repro_torch.launch.dryrun``), its records
(``roofline``) and their re-analysis (``reanalyze``).

* JAX's oracle cell, ``whisper-tiny x decode_32k x pod``
  (``tests/launch/test_distributed.py:105-114``, marked slow there): rank
  0 of a fake 256-rank group runs the placed ``decode_one`` on fake
  tensors, through the CLI, in one subprocess for the module (a fake
  default group is one a process); the record has ``flops_per_device``
  and ``temp_bytes`` above 0, collectives over its mesh, the kernel
  census of its path, and a failing cell is recorded, not dropped.
* ``reanalyze`` re-costs the saved op trace to the record's numbers, and
  ``roofline`` reads the record.
* One step's dry-run counts equal the counts of the same step run for
  real on the CPU under the same counter: reduced gemma2-2b's training
  step (K6 forward, K6b backward through their plain versions), record
  for record.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import dryrun, reanalyze, roofline, specs
from repro_torch.launch.op_cost import OpCounter
from repro_torch.train.step import init_state, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

_SUB = r"""
import sys
from repro_torch.launch import dryrun as D
D.RESULTS_DIR = sys.argv[1]
D.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "pod"])
D.run_and_save("whisper-tiny", "decode_32k", "pod", variant="bad",
               force=True, no_such_flag=1)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUB, str(out_dir)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    with open(out_dir / "whisper-tiny__decode_32k__pod.json") as f:
        rec = json.load(f)
    return {"dir": str(out_dir), "rec": rec, "stdout": out.stdout}


def test_oracle_cell(oracle):
    rec = oracle["rec"]
    assert "OK    whisper-tiny" in oracle["stdout"]
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert (rec["chips"], rec["kind"], rec["global_batch"],
            rec["seq_len"]) == (256, "decode", 128, 32768)
    # this rank's 8 of 128 rows; the parameters gathered over model, the
    # cache (6 KV heads do not divide 16: the sequence) over model, the
    # new lengths and tokens over data
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collective_bytes_per_device"] > 0
    # K6 in the 4 cross-attention layers, and the store's sweeps
    assert rec["kernels"]["flash_prefill"]["launches"] == 4
    assert rec["kernels"]["sweep"]["launches"] >= 1
    assert rec["memory"]["argument_bytes"] > rec["memory"]["alias_bytes"] > 0
    assert rec["device"] in ("cpu", "cuda")


def test_failed_cell_is_recorded(oracle):
    with open(os.path.join(oracle["dir"],
                           "whisper-tiny__decode_32k__pod__bad.json")) as f:
        rec = json.load(f)
    assert rec["error"].startswith("TypeError")
    rows = roofline.load_all(None, oracle["dir"])
    assert [r["status"] for r in rows] == ["ok", "FAILED"]
    assert "FAILED: TypeError" in roofline.table(rows)


def test_reanalyze_recosts_the_saved_trace(oracle, tmp_path):
    for name in os.listdir(oracle["dir"]):
        with open(os.path.join(oracle["dir"], name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    path = tmp_path / "whisper-tiny__decode_32k__pod.json"
    rec = json.loads(path.read_text())
    stale = dict(rec, flops_per_device=1.0, collectives={}, kernels={})
    path.write_text(json.dumps(stale))
    assert reanalyze.reanalyze(str(tmp_path)) == 1
    again = json.loads(path.read_text())
    for key in ("flops_per_device", "bytes_per_device", "transcendentals",
                "collectives", "collective_bytes_per_device", "kernels"):
        assert again[key] == rec[key], key
    row = roofline.analyze(again)
    assert row["status"] == "ok" and row["t_compute_s"] > 0


def test_dry_run_counts_equal_a_real_cpu_step():
    """Reduced gemma2-2b's training step, B 2 x T 16: on fake tensors
    (the dry run) and on real CPU tensors, the counter's trace is the
    same, record for record."""
    cfg = reduced_config("gemma2-2b")
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"])

    def step(state, batch):
        return train_step(state, batch, cfg, run)

    shapes = (specs.shapes_of(lambda dev: init_state(
        cfg, torch.Generator(device=dev))),
        {"tokens": specs.Shaped((2, 16), torch.int32),
         "loss_mask": specs.Shaped((2, 16), torch.float32)})
    dry, memory = dryrun.trace(step, shapes, CPU)
    state = init_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     dtype=torch.int32),
             "loss_mask": torch.ones((2, 16))}
    real = OpCounter("cpu")
    with real:
        real.explore(lambda: step(state, batch))
    assert real.trace == dry.trace
    got = dry.result()
    assert got["kernels"]["flash_prefill"]["launches"] == 2 * 2
    assert got["kernels"]["flash_backward"]["launches"] == 2
    assert got["flops"] > 0 and memory["alias_bytes"] > 0
