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
* Per-device FLOPs of the placed training step against JAX's GSPMD step:
  reduced minitron-4b (``tests/launch/test_distributed.py:64``), one step
  on a 2 x 2 (data, model) mesh with ``fsdp=True``; JAX's from the
  compiled step's HLO (``repro.launch.hlo_cost.analyze_hlo``, as JAX's
  dry run reads it) on 4 fake CPU devices, the port's from its dry run on
  a fake 4-rank group.
* The same for the placed serve step: reduced gemma2-2b's decode step and
  prefill on 2 x 2 against JAX's GSPMD decode and prefill cells.
* The same for the layers that compute on their shards since the parent
  gathered them whole (its ratios in LAYER_PARENT_RATIOS): the RG-LRU,
  xLSTM and encoder-decoder training steps, and xlstm-125m's and
  whisper-tiny's serve cells.
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
    # this rank's 8 of 128 rows; the attention's parameters and its cache
    # gathered over model (6 heads do not divide 16: the layer computes
    # whole), the new lengths and tokens over data
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


_FLOPS_JAX = r"""
import functools, json
import jax, jax.numpy as jnp
import repro  # noqa: F401  (installs jax.set_mesh, jax.P on this jax)
from repro.configs import reduced_config
from repro.configs.base import RunConfig, SHAPES
from repro.dist.sharding import batch_sharding, param_shardings
from repro.launch.hlo_cost import analyze_hlo
from repro.train.step import init_state, train_step
arch, over, shape = json.loads(__import__("sys").argv[1])
cfg = reduced_config(arch, **over)
run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=1e-3)
state = init_state(cfg, jax.random.PRNGKey(0))
batch = {"tokens": jnp.ones(shape, jnp.int32)}
if cfg.encoder_layers:    # an encoder-decoder's frames
    batch["frontend"] = jnp.zeros((shape[0], cfg.encoder_tokens,
                                   cfg.d_model), jnp.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
with jax.set_mesh(mesh):
    rep = jax.NamedSharding(mesh, jax.P())
    psh = param_shardings(state.params, mesh, fsdp=True)
    state = jax.device_put(state, state._replace(
        params=psh, opt=state.opt._replace(step=rep, mu=psh, nu=psh),
        err=jax.tree.map(lambda _: rep, state.err), step=rep))
    batch = jax.device_put(batch, batch_sharding(batch, mesh))
    hlo = jax.jit(functools.partial(train_step, cfg=cfg, run=run)).lower(
        state, batch).compile().as_text()
print(json.dumps(analyze_hlo(hlo)["flops"]))
"""

_FLOPS_PORT = r"""
import json, sys, torch
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.dist.sharding import Placement
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.step import init_state, train_step
arch, over, shape = json.loads(sys.argv[1])
cfg = reduced_config(arch, **over)
run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=1e-3, fsdp=True)
dryrun.start_group(4)
cpu = torch.device("cpu")
mesh = make_host_mesh(2, 2, device=cpu)
state = specs.shapes_of(lambda dev: init_state(cfg, torch.Generator(
    device=dev)))
spec = specs.train_state_specs(state, mesh, run)
pl = Placement(mesh, spec.params)
batch = {"tokens": specs.Shaped(tuple(shape), torch.int32)}
if cfg.encoder_layers:    # an encoder-decoder's frames
    batch["frontend"] = specs.Shaped((shape[0], cfg.encoder_tokens,
                                      cfg.d_model), torch.float32)
counter, _ = dryrun.trace(
    lambda s, b: train_step(s, b, cfg, run, placement=pl),
    (specs._placed(state, spec, mesh), batch), cpu)
print(json.dumps(counter.result()["flops"]))
"""

#: the port's per-device FLOPs of the placed 2 x 2 step within this share
#: of JAX's GSPMD step's.  Stated from JAX's numbers before the placed
#: step computed over ``model``: the port's one-rank step counts 4.3 %
#: fewer than JAX's one-device step (97.56 M against 101.94 M: eager ops
#: by hlo_cost's rules, no fusion), and a step that divides the attention,
#: the MLP and the vocabulary over ``model`` as JAX's does should keep
#: about that gap; a step that repeats them on each ``model`` rank counts
#: 1.88 times JAX's (48.37 M, the parent's, against 25.76 M).  The MoE
#: step (reduced deepseek-moe-16b) held to the same share once its
#: experts split over ``model`` as JAX's do; the parent's, every
#: ``model`` rank running all the experts, is MOE_PARENT_RATIOS' "train".
FLOPS_RTOL = 0.15

#: port / JAX FLOPs per device of the MoE cells before the experts
#: computed over ``model`` (this file's MoE tests run on that code): each
#: ``model`` rank ran all E experts for its rows and its shared expert
#: whole, and in training each data rank ran every bucket row of the
#: global capacity for its own tokens (train 1135894986 against JAX's
#: 484457313; decode 3489337 against 1850591; prefill 59564240 against
#: 31937915 less the T3 unembedding)
MOE_PARENT_RATIOS = {"train": 2.345, "decode": 1.886, "prefill": 1.865}


def _flops_env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def _both(jax_script: str, port_script: str, arg) -> tuple:
    """(JAX's FLOPs, the port's) of one cell: each script in a subprocess
    of its own (4 fake CPU devices; a fake 4-rank group), given ``arg``
    as JSON."""
    env, over = _flops_env(), json.dumps(arg)
    jax_proc = subprocess.Popen([sys.executable, "-c", jax_script, over],
                                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, "-c", port_script, over],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    return (json.loads(out.strip().splitlines()[-1]),
            json.loads(port.stdout.strip().splitlines()[-1]))


def _train_case(case: str) -> list:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_ranks import TRAIN_CASES
    arch, over, shape = TRAIN_CASES[case]
    return [arch, over, list(shape)]


def test_placed_step_flops_per_device_match_jax_gspmd():
    """One train step of reduced minitron-4b on 2 x 2: the port's dry run
    counts per device within FLOPS_RTOL of JAX's compiled GSPMD step (the
    JAX side in a subprocess with 4 fake CPU devices, the port's in one
    with a fake 4-rank group: one fake default group a process)."""
    want, got = _both(_FLOPS_JAX, _FLOPS_PORT, _train_case("dense"))
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


def test_placed_moe_step_flops_per_device_match_jax_gspmd():
    """The same for the MoE training case of ``tests/_torch_ranks.py``
    (reduced deepseek-moe-16b: 4 experts, top 2, one shared expert, B 8
    x T 128): JAX puts the expert dim on ``model``, and so does the
    port's step."""
    want, got = _both(_FLOPS_JAX, _FLOPS_PORT, _train_case("moe"))
    print(f"MoE train step: port / JAX FLOPs per device {got / want} "
          f"(port {got}, JAX {want}; the parent's "
          f"{MOE_PARENT_RATIOS['train']})")
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


_SERVE_FLOPS_JAX = r"""
import json, sys
import jax, jax.numpy as jnp
import repro  # noqa: F401  (installs jax.set_mesh, jax.P on this jax)
from repro.configs import reduced_config
from repro.configs.base import RunConfig, SHAPES
from repro.dist.sharding import param_shardings
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.specs import cache_shardings, mv_shardings
from repro.models import transformer as tf
from repro.serve import engine as eng
arch, B, L = json.loads(sys.argv[1])
cfg = reduced_config(arch)
run = RunConfig(model=cfg, shape=SHAPES["decode_32k"])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rows = jax.NamedSharding(mesh, jax.P("data", None))
out = {}
with jax.set_mesh(mesh):
    params = jax.eval_shape(lambda: tf.init_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    psh = param_shardings(params, mesh, fsdp=False)
    cache = jax.eval_shape(lambda: tf.init_cache(cfg, B, L, jnp.bfloat16))
    # an encoder-decoder's prefill takes its frames (input_specs' frontend)
    frames = (jax.ShapeDtypeStruct((B, cfg.encoder_tokens, cfg.d_model),
                                   jnp.bfloat16)
              if cfg.encoder_layers else None)
    prefill = jax.jit(
        lambda p, c, t, fr: tf.prefill(p, cfg, t, c, frontend_embeds=fr),
        in_shardings=(psh, cache_shardings(cache, mesh, cfg, B), rows,
                      None if frames is None else jax.NamedSharding(
                          mesh, jax.P("data", None, None))))
    out["prefill"] = analyze_hlo(prefill.lower(
        params, cache, jax.ShapeDtypeStruct((B, L), jnp.int32), frames
    ).compile().as_text())["flops"]
    st = jax.eval_shape(lambda: eng.make_serve_state(cfg, run, params, B, L,
                                                     jnp.bfloat16))
    ssh = eng.ServeState(params=psh,
                         cache=cache_shardings(st.cache, mesh, cfg, B),
                         cache_len=jax.NamedSharding(mesh, jax.P("data")),
                         mv=mv_shardings(st.mv, mesh, B), last_tokens=rows)
    decode = jax.jit(lambda s: eng.decode_one(s, cfg, run)[:2],
                     in_shardings=(ssh,))
    out["decode"] = analyze_hlo(decode.lower(st).compile().as_text())["flops"]
print(json.dumps(out))
"""

_SERVE_FLOPS_PORT = r"""
import json, sys, torch
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
arch, B, L = json.loads(sys.argv[1])
specs.get_config = reduced_config     # the cell of the reduced config
dryrun.start_group(4)
cpu = torch.device("cpu")
mesh = make_host_mesh(2, 2, device=cpu)
out = {}
for kind in ("prefill", "decode"):
    step, args, _ = specs.build_serve_cell(
        arch, mesh, ShapeConfig(kind, kind, L, B))
    counter, _ = dryrun.trace(step, args, cpu)
    out[kind] = counter.result()["flops"]
print(json.dumps(out))
"""

#: the serve cells' shape: B 4 (2 rows a data rank), a cache of 32
#: positions; the prefill's prompt fills it (32 tokens, past reduced
#: gemma2-2b's 16-slot ring)
SERVE_FLOPS_SHAPE = (4, 32)

#: the port's per-device FLOPs of the placed serve step within this share
#: of JAX's GSPMD cell's, for decode and for prefill.  Measured before the
#: serve step computed over ``model`` (the parent's, every ``model`` rank
#: repeating each layer whole for its rows): decode 403334 against JAX's
#: 228749 (1.763x); prefill 10204935 against JAX's 6731447 (1.516x), or
#: 1.785x against JAX's less the unembedding of the positions the port
#: does not unembed (below).  A step that divides attention, the MLP and
#: the vocabulary over ``model`` as JAX's does should land near 1 (the
#: train step's gap was 4.3 %: eager ops by hlo_cost's rules, no fusion).
SERVE_FLOPS_RTOL = 0.15


def _t3_unembed_flops(B: int, T: int, arch: str = "gemma2-2b") -> float:
    """The FLOPs per device of JAX's prefill that the port skips by trap
    T3: JAX unembeds every position and keeps the last; the port
    unembeds the last alone.  Per device, ``B / 2`` rows (``data`` of 2)
    times ``T - 1`` positions times ``V / 2`` vocabulary rows (``model``
    of 2) times ``d``, two FLOPs a product."""
    cfg = reduced_config(arch)
    return 2.0 * (B // 2) * (T - 1) * (cfg.vocab_size // 2) * cfg.d_model


def _serve_ratios(arch: str) -> tuple:
    """(port / JAX FLOPs per device of the decode and prefill cells, the
    port's, JAX's less :func:`_t3_unembed_flops`)."""
    want, got = _both(_SERVE_FLOPS_JAX, _SERVE_FLOPS_PORT,
                      [arch, *SERVE_FLOPS_SHAPE])
    want["prefill"] -= _t3_unembed_flops(*SERVE_FLOPS_SHAPE, arch)
    return {k: got[k] / want[k] for k in want}, got, want


def test_placed_serve_flops_per_device_match_jax_gspmd():
    """Reduced gemma2-2b's placed decode step (JAX's ``decode_one``: the
    model's decode, the descriptor write and GC) and its prefill on 2 x 2
    (data, model), parameters by ``param_shardings(fsdp=False)``, the
    cache by ``cache_shardings``, the store by ``mv_shardings``: the
    port's dry-run FLOPs per device within SERVE_FLOPS_RTOL of JAX's
    compiled GSPMD cells (``analyze_hlo``; 4 fake CPU devices in one
    subprocess, the port's fake 4-rank group in another).  JAX's prefill
    is taken less :func:`_t3_unembed_flops`, the work the port leaves out
    by design."""
    ratios, got, want = _serve_ratios("gemma2-2b")
    print(f"port / JAX FLOPs per device: {ratios} (port {got}, JAX {want};"
          " the parent's 1.763 decode, 1.785 prefill)")
    for kind in ("decode", "prefill"):
        assert abs(got[kind] - want[kind]) <= SERVE_FLOPS_RTOL * want[kind], \
            (kind, got[kind], want[kind])


def test_placed_moe_serve_flops_per_device_match_jax_gspmd():
    """The same cells of reduced deepseek-moe-16b (4 experts, top 2, one
    shared expert; its 4 KV heads on ``model``): JAX's GSPMD cells put
    the expert dim on ``model``, and so does the port's placed step."""
    ratios, got, want = _serve_ratios("deepseek-moe-16b")
    print(f"MoE serve cells: port / JAX FLOPs per device {ratios} (port "
          f"{got}, JAX {want}; the parent's {MOE_PARENT_RATIOS})")
    for kind in ("decode", "prefill"):
        assert abs(got[kind] - want[kind]) <= SERVE_FLOPS_RTOL * want[kind], \
            (kind, got[kind], want[kind])


#: port / JAX FLOPs per device of the recurrent and encoder-decoder cells
#: before those layers computed over ``model`` (the parent's: the RG-LRU in
#: training, the xLSTM mixers, whisper's encoder and cross-attention
#: gathered whole on every ``model`` rank): train rglru 95385878 against
#: JAX's 80613943, xlstm 147327643 against 79859854, encdec 67762617
#: against 46513484; serve (JAX's prefill less the T3 unembedding)
#: xlstm-125m decode 1174069 against 632276, prefill 37089196 against
#: 18781296, whisper-tiny decode 324883 against 279480, prefill 12881638
#: against 9290262
LAYER_PARENT_RATIOS = {"rglru": {"train": 1.183},
                       "xlstm": {"train": 1.845},
                       "encdec": {"train": 1.457},
                       "xlstm-125m": {"decode": 1.857, "prefill": 1.975},
                       "whisper-tiny": {"decode": 1.162, "prefill": 1.387}}


@pytest.mark.parametrize("case", ["rglru", "xlstm", "encdec"])
def test_placed_layer_step_flops_per_device_match_jax_gspmd(case):
    """The training cases of ``tests/_torch_ranks.py`` whose recurrent
    mixers and encoder-decoder compute on their shards over ``model``
    (reduced recurrentgemma-9b, xlstm-125m and whisper-tiny with its
    frames), one step on 2 x 2 with ``fsdp=True``: the port's dry-run
    FLOPs per device within FLOPS_RTOL of JAX's compiled GSPMD step."""
    want, got = _both(_FLOPS_JAX, _FLOPS_PORT, _train_case(case))
    print(f"{case} train step: port / JAX FLOPs per device {got / want} "
          f"(port {got}, JAX {want}; the parent's "
          f"{LAYER_PARENT_RATIOS[case]['train']})")
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
def test_placed_layer_serve_flops_per_device_match_jax_gspmd(arch):
    """The decode and prefill cells of reduced xlstm-125m (the mLSTM and
    sLSTM on their heads, the state whole over ``model``) and of reduced
    whisper-tiny (the prefill over its frames: the encoder and
    cross-attention on their heads; the decode step's cross-attention
    over the token itself, trap C13, as JAX's cell runs it) on 2 x 2:
    within SERVE_FLOPS_RTOL of JAX's GSPMD cells, JAX's prefill less
    :func:`_t3_unembed_flops`."""
    ratios, got, want = _serve_ratios(arch)
    print(f"{arch} serve cells: port / JAX FLOPs per device {ratios} "
          f"(port {got}, JAX {want}; the parent's "
          f"{LAYER_PARENT_RATIOS[arch]})")
    for kind in ("decode", "prefill"):
        assert abs(got[kind] - want[kind]) <= SERVE_FLOPS_RTOL * want[kind], \
            (kind, got[kind], want[kind])
