"""Rank programs of the port's placement layer, for the tests that run it
over several processes (``test_torch_ranks.py`` on the CPU,
``test_torch_gpu.py`` on the card).  No JAX here: the rank processes
import only the port; the tests compare what the ranks wrote with JAX and
with the one-process port.

:func:`spawn` starts ``world`` processes of this file, joined by gloo
through a file store in the io directory (no TCP port to pick), each with
a timeout of its own, so that a deadlock fails the run instead of hanging
the suite.  Each rank runs the named programs in order; every program
writes its results under the io directory as ``<name>_<rank>.npz``.

    python tests/_torch_ranks.py RANK WORLD IO DEVICE PROGRAM...
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the engine geometry of tests/test_torch_dist.py
B, NP, PS, MP, KVH, HD = 4, 12, 4, 3, 1, 4
TS_MAX = 2**31 - 1
# the sharded step of tests/launch/test_distributed.py:64 (its all-ones
# batch, one step), and the runs on distinct rows: TRAIN_STEPS steps, so
# that the last loss reads parameters that a nonzero rate updated (step
# 0's rate is 0)
TRAIN_CFG = dict(d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                 vocab_size=256)
TRAIN_LR, TRAIN_BATCH, TRAIN_STEPS = 1e-3, (8, 16), 3
# each run on distinct rows: (arch, config overrides, batch).  "dense" is
# JAX's test's minitron-4b on SyntheticLM rows; "moe" is reduced
# deepseek-moe-16b (4 experts, top 2) with a loss mask whose rows differ
# in their counts, at capacity factor 1.0 and B 8 x T 128, so that the
# capacity from the global batch's 2048 assignments (512 slots an expert)
# is not a rank's own (256), and the buckets of the experts routed to most
# overflow: the global capacity and order decide which tokens are dropped
TRAIN_CASES = {
    "dense": ("minitron-4b", TRAIN_CFG, TRAIN_BATCH),
    "moe": ("deepseek-moe-16b", dict(moe_capacity_factor=1.0), (8, 128)),
}
# the pipeline of tests/launch/test_distributed.py:42
PIPE = dict(S=4, M=6, mb=2, d=16)


def spawn(world: int, io: str, device: str, programs, timeout: float = 600
          ) -> dict:
    """Run ``programs`` on ``world`` rank processes; returns each rank's
    output, after asserting that every rank exited 0 in time."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(io), device, *programs], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs, t0 = {}, time.monotonic()
    try:
        for r, p in enumerate(procs):
            left = max(1.0, timeout - (time.monotonic() - t0))
            outs[r] = p.communicate(timeout=left)[0].decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
            + outs.get(r, "")
    return outs


def save(io: str, name: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(io, f"{name}_{rank}.npz"), **arrays)


def load(io: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(io, f"{name}_{rank}.npz")) as f:
        return dict(f)


def record(x) -> np.ndarray:
    """A JSON-able record as an array npz keeps."""
    return np.asarray(json.dumps(x, sort_keys=True))


def jax_path(cfg, parts):
    """A port parameter keypath -> (JAX's keypath, stacked): layer ``i`` is
    superblock ``i // p``'s ``sb/l{i % p}`` (stacked over superblocks),
    the layers past them ``tail/{k}``; an encoder layer is
    ``encoder/sb/l0``, stacked over the encoder's layers."""
    parts = tuple(parts)
    p, R = len(cfg.layer_pattern), cfg.pattern_repeats
    if parts[0] == "layers":
        i = int(parts[1])
        if i < R * p:
            return ("sb", f"l{i % p}") + parts[2:], True
        return ("tail", str(i - R * p)) + parts[2:], False
    if parts[:2] == ("encoder", "layers"):
        return ("encoder", "sb", "l0") + parts[3:], True
    return parts, False


# ---------------------------------------------------------------------------
# the engine: tests/distrib/test_sharded_mvgc.py's protocols, as records
# ---------------------------------------------------------------------------
def engine(hosts: int, device, mesh=None, policy: str = "slrt", **gc):
    from repro_torch.core.telemetry import GCConfig
    from repro_torch.dist.mvgc import ShardedPagedKVEngine
    kw = dict(policy=policy, versions_per_slot=6, reader_lanes=4, **gc)
    return ShardedPagedKVEngine(hosts, B, NP, PS, MP, KVH, HD,
                                gc=GCConfig(**kw), mesh=mesh, device=device)


def _kv(hosts, step):
    base = (np.arange(hosts * B, dtype=np.float32).reshape(hosts, B)
            + hosts * B * (step + 1))
    return np.broadcast_to(base[:, :, None, None],
                           (hosts, B, KVH, HD)).copy()


def churn(eng, steps, start=0) -> list:
    """Append/reset churn on every host; returns every op's failed mask."""
    hosts = eng.hosts
    seq = np.broadcast_to(np.arange(B, dtype=np.int32), (hosts, B)).copy()
    on = np.ones((hosts, B), bool)
    out = []
    for step in range(start, start + steps):
        out.append(eng.step(seq, _kv(hosts, step), _kv(hosts, step), on)
                   .cpu().numpy().tolist())
        if step % 3 == 2:
            done = np.zeros((hosts, B), bool)
            done[:, step % B] = True
            out.append(eng.reset(seq, done).cpu().numpy().tolist())
    return out


def checksum(eng, h, ts) -> list:
    """The exact K values of every token host ``h``'s view at ``ts``
    covers, read where the shard is."""
    tbl, ln = eng.view_at(h, ts)

    def read(st):
        k = st.k_pages[:, :, 0, 0].cpu().numpy()
        t, n = tbl.cpu().numpy(), ln.cpu().numpy()
        return [[int(n[s])] + [float(k[t[s, j // PS], j % PS])
                               for j in range(int(n[s]))]
                for s in range(t.shape[0])]
    return eng.host_apply(h, read)


def finish(eng) -> dict:
    """What every rank must agree on at the end of a protocol."""
    import dataclasses
    from repro_torch.convert import to_numpy
    from repro_torch.ckpt.manager import tree_flatten
    return {"space": eng.space(), "stats": dataclasses.asdict(eng.stats),
            "lwm_advances": eng.lwm_advances,
            "peak_pages_by_host": eng.peak_pages_by_host,
            "pages_reclaimed_by_host": eng.pages_reclaimed_by_host,
            "pressure": [to_numpy(f).tolist() for f in eng.pressure()],
            "live_pages": int(eng.live_pages()),
            "state": [to_numpy(x).tolist()
                      for x in tree_flatten(eng.stacked())]}


def proto_sentinel_trace(make) -> dict:
    """``:117``: the same pin-free trace on every host (the global LWM
    stays the inert TS_MAX) with resets and forced reclaims: every host's
    shard must end in the same state (checked by the test)."""
    eng = make(4, policy="ebr")
    seq = np.broadcast_to(np.arange(B, dtype=np.int32), (4, B)).copy()
    out = {"failed": []}
    for step in range(12):
        kv = np.broadcast_to(_kv(1, step), (4, B, KVH, HD)).copy()
        out["failed"].append(eng.step(seq, kv, kv, np.ones((4, B), bool))
                             .cpu().numpy().tolist())
        if step % 4 == 3:
            done = np.zeros((4, B), bool)
            done[:, step % B] = True
            eng.reset(seq, done)
    out["reclaimed"] = [eng.reclaim(4), eng.reclaim(None)]
    out["lwm"] = eng.lwm_pins().cpu().numpy().tolist()
    return {**out, **finish(eng)}


def proto_pin_protects(make) -> dict:
    """``:173``: a pin on host 0 protects the views of every host's shard
    under churn and forced reclaims; with the LWM neutered one breaks."""
    def run(neuter):
        eng = make(4)
        if neuter:
            sentinel = torch.full((eng.hosts, 1), TS_MAX, dtype=torch.int32,
                                  device=eng.device)
            eng.lwm_pins = lambda: sentinel
        churn(eng, 4)
        ts = eng.pin(0, 0)
        refs = [checksum(eng, h, ts) for h in range(eng.hosts)]
        churn(eng, 8, start=4)
        eng.reclaim(deficit=NP)
        churn(eng, 4, start=12)
        bad = sum(checksum(eng, h, ts) != refs[h] for h in range(eng.hosts))
        return bad, finish(eng)
    bad, end = run(False)
    bad_neutered, _ = run(True)
    return {"bad": bad, "bad_neutered": bad_neutered, **end}


def proto_lwm_min(make) -> dict:
    """``:208``: the LWM is the min over the hosts' pins, on every host,
    and advances when the oldest pin goes.  Pins on hosts 0 and 1 (on two
    ranks of a mesh of 2 or 4)."""
    eng = make(4)
    churn(eng, 3)
    t0 = eng.pin(0, 0)
    churn(eng, 2, start=3)
    t1 = eng.pin(1, 0)
    first = eng.lwm_pins().cpu().numpy().tolist()
    eng.unpin(0, 0)
    second = eng.lwm_pins().cpu().numpy().tolist()
    return {"t0": t0, "t1": t1, "first": first, "second": second,
            **finish(eng)}


def proto_stall(make) -> dict:
    """``:226``: a stalled host's pin is aged out of the LWM, reclamation
    goes on, and the stalled host's own view stays."""
    eng = make(4, stale_after_s=5.0)
    churn(eng, 4)
    ts = eng.pin(1, 0)
    before_stall = eng.lwm_pins().cpu().numpy().tolist()
    ages = np.zeros((4,), np.float32)
    ages[1] = 100.0
    eng.virtual_ages_s = ages
    aged = eng.lwm_pins().cpu().numpy().tolist()
    reclaimed_before = eng.stats.reclaimed
    churn(eng, 6, start=4)
    eng.reclaim(deficit=NP)
    ref = checksum(eng, 1, ts)
    churn(eng, 3, start=10)
    return {"ts": ts, "before_stall": before_stall, "aged": aged,
            "reclaimed_before": reclaimed_before,
            "view_kept": checksum(eng, 1, ts) == ref, **finish(eng)}


PROTOCOLS = {"sentinel_trace": proto_sentinel_trace,
             "pin_protects": proto_pin_protects,
             "lwm_min": proto_lwm_min,
             "stall": proto_stall}
TIERS = [(t, p) for t in ("smoke", "stall")
         for p in ("ebr", "steam", "dlrt", "slrt")]


def drive_ckpt(eng, steps, start, rng) -> list:
    """tests/test_torch_dist.py's checkpoint trace over ``eng.hosts``
    hosts (kv from ``rng``, the same draws in JAX's engine, which it
    drives too)."""
    H = eng.hosts
    seq = np.broadcast_to(np.arange(B, dtype=np.int32), (H, B)).copy()
    out = []
    for step in range(start, start + steps):
        kv = rng.standard_normal((H, B, KVH, HD)).astype(np.float32)
        f = eng.step(seq, kv, kv, np.ones((H, B), bool))
        out.append((f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f))
                   .tolist())
        if step % 3 == 2:
            done = np.zeros((H, B), bool)
            done[:, step % B] = True
            eng.reset(seq, done)
    return out


CKPT_HOSTS = 4


def program_engine(rank, world, io, device) -> None:
    """The four protocols on meshes of 2 and of ``world`` ranks, the smoke
    and stall tiers of BENCH_dist.json through ``chip_smoke.dist_cell``
    (its default mesh), and the checkpoint interchange: this engine saves
    (``ckpt_port``), and restores JAX's (``ckpt_jax``) and drives on."""
    import importlib.util
    from repro_torch.launch.mesh import make_gc_mesh
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    recs = {}
    for n in sorted({2, world}):
        mesh = make_gc_mesh(n, device=device)
        for name, proto in PROTOCOLS.items():
            recs[f"{name}@{n}"] = proto(
                lambda hosts, **kw: engine(hosts, device, mesh, **kw))
    for key in TIERS:
        recs["tier:" + "/".join(key)] = smoke.dist_cell(*key, device)
    mesh = make_gc_mesh(world, device=device)
    eng = engine(CKPT_HOSTS, device, mesh, hot_k=4)
    rng = np.random.default_rng(0)
    drive_ckpt(eng, 5, 0, rng)
    eng.pin(1, 0)
    recs["ckpt_port"] = {"step": eng.checkpoint(os.path.join(io,
                                                             "ckpt_port")),
                         **finish(eng)}
    eng = engine(CKPT_HOSTS, device, mesh, hot_k=4)
    step = eng.restore(os.path.join(io, "ckpt_jax"))
    restored = finish(eng)
    failed = drive_ckpt(eng, 4, 5, np.random.default_rng(1))
    recs["ckpt_jax"] = {"step": step, "restored": restored,
                        "failed": failed, **finish(eng)}
    save(io, "engine", rank, records=record(recs))


# ---------------------------------------------------------------------------
# the pipeline and the sharded step
# ---------------------------------------------------------------------------
def program_pipeline(rank, world, io, device) -> None:
    """``pipeline_forward`` over ``world`` stage ranks, each with its own
    stage's weight, ``tanh(h @ w)``, on the inputs the test wrote."""
    from repro_torch.launch.mesh import make_gc_mesh
    from repro_torch.train.pipeline_parallel import pipeline_forward
    inp = load(io, "pipeline_in", 0)
    mesh = make_gc_mesh(world, axis="stage", device=device)
    sid = mesh.get_local_rank("stage")
    w = torch.from_numpy(inp["ws"][sid]).to(device)
    x = torch.from_numpy(inp["x"]).to(device)
    y = pipeline_forward(lambda p, h: torch.tanh(h @ p), w, x, mesh=mesh,
                         axis="stage")
    save(io, "pipeline", rank, y=y.cpu().numpy())


def train_batches(case: str, steps: int = TRAIN_STEPS) -> list:
    """``steps`` global batches of ``case`` as numpy: SyntheticLM's tokens
    (distinct rows); the MoE case's loss mask keeps a share of each row's
    positions that grows from 0.2 to 1 over the rows."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    arch, over, (B, T) = TRAIN_CASES[case]
    data = SyntheticLM(DataConfig(over.get("vocab_size", 256), T, B))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        b = next(data)
        if case == "moe":
            keep = np.linspace(0.2, 1.0, B)[:, None]
            b["loss_mask"] = (rng.random((B, T)) < keep).astype(np.float32)
        out.append(b)
    return out


def train_setup(io, case, device):
    """``case``'s reduced config, its run, and the state the test wrote
    for it (JAX's ``init_state`` on the CPU, the port's on the card),
    through the port's manager."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import init_state
    arch, over, _ = TRAIN_CASES[case]
    cfg = reduced_config(arch, **over)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=TRAIN_LR)
    like = init_state(cfg, device=device)
    state, _ = CheckpointManager(os.path.join(io, "train_state_" + case)
                                 ).restore(0, like=like, device=device)
    return cfg, run, state


def _on(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class _SkipUpdate:
    """A planted fault: AdamW's moments advance, but every parameter (a
    shard, on a placed state) keeps its value."""

    def __enter__(self):
        from repro_torch.optim import adamw
        self.real = real = adamw.apply

        def apply(params, grads, state, **kw):
            from repro_torch.ckpt.manager import tree_flatten
            keep = [x.detach().clone() for x in tree_flatten(params)]
            params, state, m = real(params, grads, state, **kw)
            with torch.no_grad():
                for x, k in zip(tree_flatten(params), keep):
                    x.copy_(k)
            return params, state, m
        adamw.apply = apply

    def __exit__(self, *exc):
        from repro_torch.optim import adamw
        adamw.apply = self.real


def _record(out: dict, prefix: str, state, losses, norms) -> None:
    from repro_torch.ckpt.manager import tree_flatten
    out[prefix + ".losses"] = np.asarray(losses)
    out[prefix + ".grad_norms"] = np.asarray(norms)
    for name, tree in (("param", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        for i, x in enumerate(tree_flatten(tree)):
            out[f"{prefix}.{name}_{i}"] = x.detach().float().cpu().numpy()


def placed_run(io, case, mesh, device, wrong_half=False) -> tuple:
    """TRAIN_STEPS sharded steps of ``case`` on the 2 x 2 mesh with
    ``fsdp=True``: (state of shards, losses, grad norms).  ``wrong_half``
    plants a fault: both data rows take the batch's first half."""
    from repro_torch.dist.sharding import place_train_state
    from repro_torch.train.step import train_step
    cfg, run, state = train_setup(io, case, device)
    state, pl = place_train_state(state, mesh, fsdp=True)
    if wrong_half:
        real = pl._index
        pl._index = lambda axes: (0, real(axes)[1])
    losses, norms = [], []
    for b in train_batches(case):
        state, m = train_step(state, _on(b, device), cfg, run, placement=pl)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def dp_run(io, mesh, device, wrong_half=False) -> tuple:
    """Data parallelism through ``make_grad_reduce`` over the mesh's data
    group of 2, the dense case: each rank takes its half of every batch
    (``wrong_half``, a planted fault: both take the first)."""
    from repro_torch.train.step import make_grad_reduce, train_step
    cfg, run, state = train_setup(io, "dense", device)
    i = 0 if wrong_half else mesh.get_local_rank("data")
    reduce = make_grad_reduce(mesh.get_group("data"))
    losses, norms = [], []
    for b in train_batches("dense"):
        half = {k: v.chunk(2)[i] for k, v in _on(b, device).items()}
        state, m = train_step(state, half, cfg, run, grad_reduce=reduce)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def program_train(rank, world, io, device) -> None:
    """On a 2 x 2 (data, model) mesh with ``fsdp=True``: JAX's test (one
    sharded step on the all-ones batch; each leaf's shard shape); the
    dense and MoE cases on distinct rows; the dense case with two planted
    faults (the update skipped, both data rows on the first half); then
    data parallelism through ``make_grad_reduce`` over the data groups,
    as it is and with both ranks on the first half."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.dist.sharding import _paths, place_train_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import train_step
    mesh = make_host_mesh(2, 2, device=device)
    cfg, run, state = train_setup(io, "dense", device)
    state, pl = place_train_state(state, mesh, fsdp=True)
    out = {"coord": np.asarray(mesh.get_coordinate())}
    out["paths"] = record(["/".join(p) for p, _ in _paths(state.params)])
    out["shapes"] = record([list(x.shape) for x in
                            tree_flatten(state.params)])
    ones = {"tokens": torch.ones(TRAIN_BATCH, dtype=torch.int32,
                                 device=device)}
    _, m = train_step(state, ones, cfg, run, placement=pl)
    out["ones_loss"] = float(m["loss"])
    for case in TRAIN_CASES:
        _record(out, case, *placed_run(io, case, mesh, device))
    with _SkipUpdate():
        _record(out, "fault_skip", *placed_run(io, "dense", mesh, device))
    _record(out, "fault_half",
            *placed_run(io, "dense", mesh, device, wrong_half=True))
    _record(out, "dp", *dp_run(io, mesh, device))
    _record(out, "fault_dp_half", *dp_run(io, mesh, device, wrong_half=True))
    save(io, "train", rank, **out)


# ---------------------------------------------------------------------------
# the checks of the train program's records (the CPU and the card tests)
# ---------------------------------------------------------------------------
#: A training run against its reference: the losses and gradient norms
#: within JAX_RTOL of JAX's (JAX's own limit for the sharded loss,
#: tests/launch/test_distributed.py:98) and within PORT_RTOL of the port's
#: one-rank step on the CPU (float32 sums in another order: measured
#: 2.1e-7, where skipping the shards' update moves the last loss by
#: 7.6e-5); AdamW's moments within MOMENT_SHARE of the tree's largest
#: entry (measured 3.4e-7); and each parameter's change over the run
#: (p - p0, what the updates did) against the reference's change.  Where
#: the entry moved at least half the rates' sum (AdamW's normalized steps
#: near 1) and its gradient is not near zero (the reference's second
#: moment at least GRAD_SHARE of its leaf's largest, in root: a gradient
#: entry near zero carries float32 rounding of its leaf's large terms,
#: which AdamW's normalization lifts to a full step), within UPDATE_RTOL
#: of the reference's change (measured 9.5e-4; a skipped update is 1, a
#: wrong half up to 3); elsewhere within twice the rates' sum.  Both
#: sides also carry the float32 spacing of p0.
JAX_RTOL, PORT_RTOL, MOMENT_SHARE, UPDATE_RTOL = 1e-4, 1e-5, 1e-4, 1e-2
GRAD_SHARE = 1e-3


def rate_sum() -> float:
    """The learning rates of the run's TRAIN_STEPS steps, summed."""
    from repro_torch.optim.adamw import cosine_schedule
    return sum(float(cosine_schedule(torch.tensor(i, dtype=torch.int32),
                                     base_lr=TRAIN_LR))
               for i in range(TRAIN_STEPS))


def held(dw, nu, rates) -> np.ndarray:
    """The entries of a leaf held to UPDATE_RTOL: moved at least half the
    rates' sum by the reference (``dw``), with a gradient not near zero
    (``nu``, the reference's second moment)."""
    scale = np.sqrt(nu)
    return (np.abs(dw) >= 0.5 * rates) & (scale >= GRAD_SHARE * scale.max())


def check_update(got, want, p0, nu) -> float:
    """Every leaf's change over the run against the reference's (the
    limits above; ``nu``: the reference's second moments); returns the
    share of entries held to UPDATE_RTOL."""
    rates = rate_sum()
    big_n = total = 0
    for g, w, p, v in zip(got, want, p0, nu):
        assert g.shape == w.shape == p.shape == v.shape
        dg, dw = g - p, w - p
        spacing = 4 * np.finfo(np.float32).eps * np.abs(p)
        err = np.abs(dg - dw)
        big = held(dw, v, rates)
        assert np.all(err[big] <= UPDATE_RTOL * np.abs(dw[big])
                      + spacing[big]), float(
            (err[big] / np.abs(dw[big])).max())
        assert np.all(err <= 2 * rates + spacing), float(err.max())
        big_n, total = big_n + int(big.sum()), total + big.size
    assert big_n > 0
    return big_n / total


def check_run(got: dict, want: dict, p0, moments: bool = True,
              rtol: float = PORT_RTOL, nu=None) -> None:
    """``got`` against ``want`` (losses, grad_norms, params and, with
    ``moments``, mu and nu, leaves in one order); ``nu``, the second
    moments that pick the entries held to UPDATE_RTOL, is ``want``'s
    unless given."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=rtol)
    check_update(got["params"], want["params"], p0,
                 want["nu"] if nu is None else nu)
    for key in ("mu", "nu") if moments else ():
        scale = max(float(np.abs(x).max()) for x in want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=MOMENT_SHARE * scale)


def like_params(case):
    """A parameter tree of ``case``'s shapes (its values unused)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tf
    arch, over, _ = TRAIN_CASES[case]
    return tf.init_params(reduced_config(arch, **over),
                          torch.Generator().manual_seed(0))


def _full(outs, key, like):
    """Every leaf of ``key`` reassembled from the ranks' shards by the
    placement's specs (the shards of one leaf tile it)."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.dist.sharding import _paths, param_shardings
    stand_in = type("StandIn", (), {"shape": {"data": 2, "model": 2}})()
    specs = [s for _, s in _paths(param_shardings(like, stand_in,
                                                  fsdp=True))]
    full = []
    for i, leaf in enumerate(tree_flatten(like)):
        x = np.zeros(tuple(leaf.shape), np.float32)
        for out in outs:
            coord = {"data": int(out["coord"][0]),
                     "model": int(out["coord"][1])}
            idx = []
            for dim, a in enumerate(list(specs[i])[:x.ndim]):
                size = x.shape[dim] // (2 if a else 1)
                c = coord[a] if a else 0
                idx.append(slice(c * size, (c + 1) * size))
            x[tuple(idx)] = out[f"{key}_{i}"]
        full.append(x)
    return full


def placed(io, prefix, case="dense", world=4) -> dict:
    """A placed run's record from the ranks: the losses and gradient
    norms (every rank's the same), and the full leaves."""
    outs = [load(io, "train", r) for r in range(world)]
    assert sorted(tuple(o["coord"]) for o in outs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs[1:]:
        for k in ("losses", "grad_norms"):
            np.testing.assert_array_equal(o[f"{prefix}.{k}"],
                                          outs[0][f"{prefix}.{k}"])
    like = like_params(case)
    rec = {k: outs[0][f"{prefix}.{k}"] for k in ("losses", "grad_norms")}
    for key, name in (("params", "param"), ("mu", "mu"), ("nu", "nu")):
        rec[key] = _full(outs, f"{prefix}.{name}", like)
    return rec


def data_parallel(io, prefix, world=4) -> list:
    """Each rank's record of a ``make_grad_reduce`` run, its losses the
    mean of its data group's two halves' (the whole batch's loss, the
    dense case's mask being uniform)."""
    from repro_torch.ckpt.manager import tree_flatten
    outs = [load(io, "train", r) for r in range(world)]
    by_row = {int(o["coord"][0]): o[f"{prefix}.losses"] for o in outs}
    n = len(tree_flatten(like_params("dense")))
    return [{"losses": (by_row[0] + by_row[1]) / 2,
             "grad_norms": o[f"{prefix}.grad_norms"],
             **{key: [o[f"{prefix}.{name}_{i}"] for i in range(n)]
                for key, name in (("params", "param"), ("mu", "mu"),
                                  ("nu", "nu"))}} for o in outs]


def one_rank(state, case, device) -> dict:
    """``case``'s reference: the port's one-rank step from ``state`` on the
    same whole batches, TRAIN_STEPS times, as numpy, with p0, the initial
    parameters."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import train_step
    arch, over, _ = TRAIN_CASES[case]
    cfg = reduced_config(arch, **over)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=TRAIN_LR)

    def host(tree):
        return [x.detach().float().cpu().numpy().copy()
                for x in tree_flatten(tree)]
    p0 = host(state.params)
    losses, norms = [], []
    for b in train_batches(case):
        state, m = train_step(state, _on(b, device), cfg, run)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": np.asarray(losses), "grad_norms": np.asarray(norms),
            "p0": p0, "params": host(state.params), "mu": host(state.opt.mu),
            "nu": host(state.opt.nu)}


PROGRAMS = {"engine": program_engine, "pipeline": program_pipeline,
            "train": program_train}


def main(argv) -> int:
    rank, world, io, device = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        io, "store"), rank=rank, world_size=world)
    try:
        for name in argv[5:]:
            t0 = time.perf_counter()
            PROGRAMS[name](rank, world, io, torch.device(device))
            print(f"rank {rank} {name} {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
