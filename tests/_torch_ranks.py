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
import contextlib
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
# overflow: the global capacity and order decide which tokens are dropped.
# "rglru" is reduced recurrentgemma-9b (one period: RG-LRU, RG-LRU,
# local attention over 1 KV head) at T 32, past its 16-position window;
# "xlstm" reduced xlstm-125m (3 mLSTM layers, 2 chunks of 8, and an
# sLSTM); "encdec" reduced whisper-tiny (2 encoder and 2 decoder layers, 4
# heads) with TRAIN_FRAMES frames a row
TRAIN_CASES = {
    "dense": ("minitron-4b", TRAIN_CFG, TRAIN_BATCH),
    "moe": ("deepseek-moe-16b", dict(moe_capacity_factor=1.0), (8, 128)),
    "rglru": ("recurrentgemma-9b", {}, (8, 32)),
    "xlstm": ("xlstm-125m", {}, TRAIN_BATCH),
    "encdec": ("whisper-tiny", {}, TRAIN_BATCH),
}
#: the encoder-decoder case's frame embeddings: reduced whisper-tiny's 16
#: encoder positions a row, standard normal times this scale
TRAIN_FRAMES_SCALE = 0.5
# the pipeline of tests/launch/test_distributed.py:42 (S 4, M 6, mb 2, d
# 16), and its gradient at that M, at M 2 < S (the bubble dominates) and at
# M 1; a pytree stage {"w": [w1, w2], "b": b} with b frozen; reduced
# minitron-4b's blocks (8 layers, 2 a stage) in float32 through
# block_apply(mode="train")
PIPE = dict(S=4, M=6, mb=2, d=16)
PIPE_CASES = {"m6": 6, "m2": 2, "m1": 1}
PIPE_TREE = dict(M=4)
PIPE_MODEL = dict(arch="minitron-4b", num_layers=8, M=3, mb=2, T=16, seed=0)
# the forward's limit (tests/test_torch_ranks.py), held also by the
# gradients against JAX's and the sequential port's
PIPE_ATOL = 1e-5


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
def parent_pipeline_forward(apply_fn, stage_params, x, mesh,
                            axis="stage"):
    """The forward-only ``pipeline_forward`` as it stood before it became
    differentiable: the oracle for the new one's bits under no_grad."""
    from repro_torch.dist.overlap import broadcast_, exchange
    group = mesh.get_group(axis)
    S, sid = dist.get_world_size(group), dist.get_rank(group)
    M = x.shape[0]
    buf = torch.zeros_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(M + S - 1):
        m = t - sid
        inp = x[min(max(t, 0), M - 1)] if sid == 0 else carry
        active = 0 <= m < M
        out = apply_fn(stage_params, inp) if active else inp
        if sid == S - 1 and active:
            buf[m] = out
        carry = exchange(out, (sid + 1) % S, (sid - 1) % S, group) \
            if S > 1 else out
    return broadcast_(buf, S - 1, group)


def _sum_dy(gy, group):
    from repro_torch.dist.overlap import all_reduce_
    return all_reduce_(gy.clone(), group)


def _drop_first(acc, g):
    # the first microbatch the backward sums (the last one) is lost
    return torch.zeros_like(g) if acc is None else acc + g


def _hop_to_next(g, sid, S, group):
    from repro_torch.dist.overlap import exchange
    return exchange(g, (sid + 1) % S, (sid - 1) % S, group)


#: planted faults of the pipeline's backward: (the helper of
#: repro_torch.train.pipeline_parallel replaced, its faulty version)
PIPE_FAULTS = {
    "dy_summed": ("_stage_dy", _sum_dy),
    "microbatch_dropped": ("_accumulate", _drop_first),
    "hop_to_next": ("_reverse_hop", _hop_to_next),
}


@contextlib.contextmanager
def pipe_fault(name):
    from repro_torch.train import pipeline_parallel as pp
    attr, fn = PIPE_FAULTS[name]
    old = getattr(pp, attr)
    setattr(pp, attr, fn)
    try:
        yield
    finally:
        setattr(pp, attr, old)


def _tanh(p, h):
    return torch.tanh(h @ p)


def _tree_apply(p, h):
    w1, w2 = p["w"]
    return torch.tanh(torch.tanh(h @ w1) @ w2 + p["b"])


def pipe_model(device):
    """Reduced minitron-4b at PIPE_MODEL's depth: (config, layer ``i``
    built from its own seed, a stage's apply over its layers)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.blocks import block_apply, init_block
    p = PIPE_MODEL
    cfg = reduced_config(p["arch"], num_layers=p["num_layers"])
    kinds = tf._kinds(cfg)
    positions = torch.arange(p["T"], dtype=torch.int32, device=device)[
        None].expand(p["mb"], p["T"])

    def layer(i):
        gen = torch.Generator(device=device).manual_seed(p["seed"] + 1 + i)
        return init_block(gen, cfg, kinds[i], torch.float32), kinds[i]

    def apply(stage, h):
        for bp, kind in stage:
            h, _ = block_apply(bp, cfg, kind, h, positions, mode="train")
        return h
    return cfg, layer, apply


def _saves(fn) -> tuple:
    """``fn()`` and the number of tensors autograd saved while it ran."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


def _pipe_grads(apply_fn, stage, x, c, mesh) -> tuple:
    """``sum(pipeline_forward(apply_fn, stage, x) * c)`` backpropagated on
    this rank: (y, the tensors autograd saved in the call, x.grad)."""
    from repro_torch.train.pipeline_parallel import pipeline_forward
    x = x.detach().clone().requires_grad_()
    y, saved = _saves(lambda: pipeline_forward(apply_fn, stage, x,
                                               mesh=mesh, axis="stage"))
    (y * c).sum().backward()
    return y.detach(), saved, x.grad


def program_pipeline(rank, world, io, device) -> None:
    """``pipeline_forward`` over ``world`` stage ranks, each with its own
    stage: ``tanh(h @ w)`` at each of PIPE_CASES (the forward under
    no_grad, beside the parent's loop; then the gradient of ``sum(y *
    c)``, and at M 6 again under each planted fault), the pytree stage,
    and reduced minitron-4b's blocks (one thread: the CPU BLAS splits its
    sums by the threads it finds free, and the test holds these bits to
    the sequential layers' in another process)."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.launch.mesh import make_gc_mesh
    from repro_torch.train.pipeline_parallel import pipeline_forward
    mesh = make_gc_mesh(world, axis="stage", device=device)
    sid = mesh.get_local_rank("stage")
    out = {"stage": np.asarray(sid)}

    def dev(a):
        return torch.from_numpy(a).to(device)

    for case in PIPE_CASES:
        inp = load(io, f"pipeline_in_{case}", 0)
        x, c = dev(inp["x"]), dev(inp["c"])
        w = dev(inp["ws"][sid])
        with torch.no_grad():
            y, out[f"{case}_saved_nograd"] = _saves(
                lambda: pipeline_forward(_tanh, w, x, mesh=mesh,
                                         axis="stage"))
            out[f"{case}_y"] = y.cpu().numpy()
            out[f"{case}_y_parent"] = parent_pipeline_forward(
                _tanh, w, x, mesh).cpu().numpy()
        runs = [(case, None)] + [(f"{case}_{f}", f) for f in PIPE_FAULTS
                                 if case == "m6"]
        for name, fault in runs:
            w = dev(inp["ws"][sid]).requires_grad_()
            with pipe_fault(fault) if fault else contextlib.nullcontext():
                y, saved, gx = _pipe_grads(_tanh, w, x, c, mesh)
            out.update({f"{name}_y_grad": y.cpu().numpy(),
                        f"{name}_saved": np.asarray(saved),
                        f"{name}_gw": w.grad.cpu().numpy(),
                        f"{name}_gx": gx.cpu().numpy()})
    inp = load(io, "pipeline_tree_in", 0)
    stage = {"w": [dev(inp["w1s"][sid]).requires_grad_(),
                   dev(inp["w2s"][sid]).requires_grad_()],
             "b": dev(inp["bs"][sid])}
    _, out["tree_saved"], gx = _pipe_grads(_tree_apply, stage, dev(inp["x"]),
                                           dev(inp["c"]), mesh)
    out.update(tree_gw1=stage["w"][0].grad.cpu().numpy(),
               tree_gw2=stage["w"][1].grad.cpu().numpy(),
               tree_b_grad_none=np.asarray(stage["b"].grad is None),
               tree_gx=gx.cpu().numpy())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, layer, apply = pipe_model(device)
        per = cfg.num_layers // world
        stage = [layer(i) for i in range(sid * per, (sid + 1) * per)]
        leaves = [t for t in tree_flatten(stage) if torch.is_tensor(t)]
        for t in leaves:
            t.requires_grad_()
        inp = load(io, "pipeline_model_in", 0)
        y, _, gx = _pipe_grads(apply, stage, dev(inp["x"]), dev(inp["c"]),
                               mesh)
    finally:
        torch.set_num_threads(threads)
    out.update(model_y=y.cpu().numpy(), model_gx=gx.cpu().numpy(),
               **{f"model_g{i}": t.grad.cpu().numpy()
                  for i, t in enumerate(leaves)})
    save(io, "pipeline", rank, **out)


def pipeline_inputs(io: str) -> None:
    """The pipeline program's numpy inputs: one set of stage weights, and
    each of PIPE_CASES' x and seeded cotangent c; the pytree stage's; the
    model's x and c (its layers are built from seeds)."""
    from repro_torch.configs import reduced_config
    rng = np.random.default_rng(0)
    S, mb, d = (PIPE[k] for k in ("S", "mb", "d"))

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    ws = normal(S, d, d, scale=0.3)
    for case, M in PIPE_CASES.items():
        save(io, f"pipeline_in_{case}", 0, ws=ws, x=normal(M, mb, d),
             c=normal(M, mb, d))
    M = PIPE_TREE["M"]
    save(io, "pipeline_tree_in", 0, w1s=normal(S, d, d, scale=0.3),
         w2s=normal(S, d, d, scale=0.3), bs=normal(S, d, scale=0.3),
         x=normal(M, mb, d), c=normal(M, mb, d))
    p = PIPE_MODEL
    cfg = reduced_config(p["arch"], num_layers=p["num_layers"])
    shape = (p["M"], p["mb"], p["T"], cfg.d_model)
    save(io, "pipeline_model_in", 0, x=normal(*shape), c=normal(*shape))


def sequential(fn, stages, x: np.ndarray, c: np.ndarray) -> tuple:
    """``sum(y * c)`` through ``stages`` (pytrees of CPU tensors that
    require grad) in sequence, each ``fn(stage, h)``: (y, x's
    gradient)."""
    x = torch.from_numpy(x).requires_grad_()
    y = x
    for st in stages:
        y = fn(st, y)
    (y * torch.from_numpy(c)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def tanh_reference(io: str, case: str) -> dict:
    """``case``'s y and gradients through the ``tanh(h @ w)`` stages in
    sequence on the CPU."""
    inp = load(io, f"pipeline_in_{case}", 0)
    ws = [torch.from_numpy(w).requires_grad_() for w in inp["ws"]]
    y, gx = sequential(_tanh, ws, inp["x"], inp["c"])
    return {"y": y, "gws": np.stack([w.grad.numpy() for w in ws]),
            "gx": gx}


def check_pipe_grads(io: str, run: str, wants, world: int = 4) -> None:
    """Every rank's gradient of its stage's weight and its ``x.grad``
    (those of the run named ``run``) within PIPE_ATOL of each of
    ``wants``."""
    for rank in range(world):
        got = load(io, "pipeline", rank)
        sid = int(got["stage"])
        for want in wants:
            np.testing.assert_allclose(got[f"{run}_gw"], want["gws"][sid],
                                       atol=PIPE_ATOL, rtol=0)
            np.testing.assert_allclose(got[f"{run}_gx"], want["gx"],
                                       atol=PIPE_ATOL, rtol=0)


def pipe_model_reference(x: np.ndarray, c: np.ndarray) -> dict:
    """The gradients of ``sum(y * c)`` through PIPE_MODEL's layers in
    sequence, in one thread: per microbatch a forward that keeps each
    layer's input, then each layer (last first) recomputed and
    differentiated, each leaf's gradient summed last microbatch first.
    Returns each layer's leaf gradients (``layer{i}``: a list) and
    ``gx``."""
    from repro_torch.ckpt.manager import tree_flatten
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, layer, apply = pipe_model(cpu)
        L, M = cfg.num_layers, x.shape[0]
        hs = [[torch.from_numpy(x[m])] for m in range(M)]
        with torch.no_grad():
            for i in range(L):
                one = [layer(i)]
                for m in range(M):
                    hs[m].append(apply(one, hs[m][-1]))
        g = [torch.from_numpy(c[m]) for m in range(M)]
        out = {}
        for i in range(L - 1, -1, -1):
            one = [layer(i)]
            leaves = [t.requires_grad_() for t in tree_flatten(one)
                      if torch.is_tensor(t)]
            acc = [None] * len(leaves)
            for m in range(M - 1, -1, -1):
                h = hs[m][i].clone().requires_grad_()
                grads = torch.autograd.grad(apply(one, h), [h, *leaves],
                                            g[m])
                g[m] = grads[0]
                acc = [a if b is None else b + a
                       for a, b in zip(grads[1:], acc)]
            out[f"layer{i}"] = [a.numpy() for a in acc]
    finally:
        torch.set_num_threads(threads)
    out["gx"] = torch.stack(g).numpy()
    return out


def train_batches(case: str, steps: int = TRAIN_STEPS) -> list:
    """``steps`` global batches of ``case`` as numpy: SyntheticLM's tokens
    (distinct rows); the MoE case's loss mask keeps a share of each row's
    positions that grows from 0.2 to 1 over the rows; an encoder-decoder's
    frames (``frontend``) are drawn from a seed."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    arch, over, (B, T) = TRAIN_CASES[case]
    cfg = reduced_config(arch, **over)
    data = SyntheticLM(DataConfig(over.get("vocab_size", 256), T, B))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        b = next(data)
        if case == "moe":
            keep = np.linspace(0.2, 1.0, B)[:, None]
            b["loss_mask"] = (rng.random((B, T)) < keep).astype(np.float32)
        if cfg.encoder_layers:
            b["frontend"] = (rng.standard_normal(
                (B, cfg.encoder_tokens, cfg.d_model))
                * TRAIN_FRAMES_SCALE).astype(np.float32)
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


class _SkipG:
    """A planted fault: attention over local heads returns this rank's
    partial output, ``g`` (the sum over the ``model`` ranks) skipped
    after ``wo``."""

    def __enter__(self):
        from repro_torch.models import attention as att
        self.real = att._attention_local

        def local(params, cfg, x, positions, window, causal, use_rope, tp,
                  x_kv=None):
            hq = params["wq"].shape[1]
            params = att._local_kv(params, cfg, tp.index * hq, hq, tp)
            q, k, v = att._project_qkv(params, cfg, tp.f(x), positions,
                                       use_rope=use_rope)
            return att._out_proj(params, att._flash(cfg, q, k, v, window,
                                                    causal))
        att._attention_local = local

    def __exit__(self, *exc):
        from repro_torch.models import attention as att
        att._attention_local = self.real


class _LocalLse:
    """A planted fault: the vocab-parallel cross-entropy's row statistics
    (max, sum of exponentials, the label's logit) taken over this rank's
    slice of the vocabulary only."""

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.real = real = tf.cross_entropy_loss

        class Alone:
            def __init__(self, tp):
                self.index, self.n = tp.index, tp.n

            def reduce(self, x, op=None):
                return x.detach()

        def ce(*args, tp=None, **kw):
            return real(*args, tp=Alone(tp) if tp is not None else None,
                        **kw)
        tf.cross_entropy_loss = ce

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf.cross_entropy_loss = self.real


class _SkipFBackward:
    """A planted fault: ``f`` (where a replicated activation enters a
    column-split product) without its backward all-reduce, so each
    ``model`` rank keeps its own slice's share of the activation's
    gradient (the replicated norms' gradients come out wrong)."""

    def __enter__(self):
        from repro_torch.dist.sharding import ModelAxis
        self.real = ModelAxis.f
        ModelAxis.f = lambda tp, x: x

    def __exit__(self, *exc):
        from repro_torch.dist.sharding import ModelAxis
        ModelAxis.f = self.real


#: planted faults of the compute over ``model``, each run as the dense
#: case's placed run; each must fail check_run
TP_FAULTS = {"fault_skip_g": _SkipG, "fault_local_lse": _LocalLse,
             "fault_skip_f_backward": _SkipFBackward}


class _LocalRms:
    """A planted fault: an xLSTM mixer's ``ln_out`` norm takes its
    statistic over this rank's slice of the width only."""

    def __enter__(self):
        from repro_torch.models import common, mlstm
        self.real = mlstm.rms_norm
        mlstm.rms_norm = lambda x, scale, eps=1e-6, tp=None: \
            common.rms_norm(x, scale, eps)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mlstm
        mlstm.rms_norm = self.real


class _SlicedNotSummed:
    """A planted fault: the gradient of a leaf that a layer computing on
    its shards slices (an RG-LRU's gate matrices and per-channel leaves)
    is not summed over ``model``: each rank keeps its slice's share."""

    def __enter__(self):
        from repro_torch.dist.sharding import Placement
        self.real = real = Placement._reduce_grad
        Placement._reduce_grad = (lambda pl, grad, path, local=False,
                                  partial=False: real(pl, grad, path, local))
        return self

    def __exit__(self, *exc):
        from repro_torch.dist.sharding import Placement
        Placement._reduce_grad = self.real


class _CrossNoF:
    """A planted fault: the encoder's output enters cross-attention's
    column-split K/V products without ``f``, so the encoder's gradient on
    each rank is its heads' share."""

    def __enter__(self):
        from repro_torch.models import attention as att
        self.real = att._kv_source
        att._kv_source = lambda x_kv, tp: x_kv
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as att
        att._kv_source = self.real


#: planted faults of the recurrent mixers' and the encoder-decoder's compute
#: over ``model``: (fault, the case it runs as); each must fail check_run
LAYER_FAULTS = {"fault_local_rms": (_LocalRms, "xlstm"),
                "fault_sliced_not_summed": (_SlicedNotSummed, "rglru"),
                "fault_cross_no_f": (_CrossNoF, "encdec")}


class _ExpertAxis:
    """The experts' model axis of one MoE layer call, as a planted fault
    sees it: the real axis, but for what the fault changes."""

    def __init__(self, tp, index=None, g=None, f_calls=None):
        self.tp, self.calls = tp, 0
        self.index = tp.index if index is None else index
        self._g, self._f_calls = g, f_calls

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def f(self, x):
        self.calls += 1
        if self._f_calls is not None and self.calls not in self._f_calls:
            return x
        return self.tp.f(x)

    def g(self, x):
        return self.tp.g(x) if self._g is None else self._g(x)


class _ExpertFault:
    """A planted fault of a mixture of experts over ``model``: the axis
    that ``moe._axes`` gives each layer call wrapped by ``wrap``."""

    wrap = None

    def __enter__(self):
        from repro_torch.models import moe
        self.real = real = moe._axes

        def axes(tp):
            ep, sh = real(tp)
            return (ep if ep is None else self.wrap(ep)), sh
        moe._axes = axes
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._axes = self.real


class _WrongExperts(_ExpertFault):
    """Each rank runs its pieces of the experts on the bucket rows of the
    next rank's block."""

    def wrap(self, ep):
        return _ExpertAxis(ep, index=(ep.index + 1) % ep.n)


class _CombineSkipG(_ExpertFault):
    """The combine without its ``g``: each rank keeps its experts' (and
    its shared expert's) partial sum."""

    def wrap(self, ep):
        return _ExpertAxis(ep, g=lambda x: x)


class _GateSkipF(_ExpertFault):
    """``f`` skipped on the gate weights (the second of a layer call's two
    ``f``, after the one on the tokens): the router's gradient on a rank is
    its own experts' share."""

    def wrap(self, ep):
        return _ExpertAxis(ep, f_calls=(1,))


class _LocalCounts:
    """The load-balance loss from the counts of this rank's block of
    experts only (each other expert's count taken as 0); the dispatch
    reads the true counts."""

    def __enter__(self):
        from repro_torch.models import moe
        self.route, self.axes = route, axes = moe._route, moe._axes
        block = {}

        def local_axes(tp):
            ep, sh = axes(tp)
            block["ep"] = ep
            return ep, sh

        def local_route(params, cfg, x, group=None):
            gate_vals, gate_idx, aux, before = route(params, cfg, x, group)
            ep = block.get("ep")
            if ep is None:
                return gate_vals, gate_idx, aux, before
            E = cfg.num_experts
            probs = torch.softmax(x.float() @ params["router"], dim=-1)
            me = probs.reshape(-1, E).mean(0)
            flat = gate_idx.reshape(-1)
            counts = probs.new_zeros((E,)).scatter_add_(
                0, flat, torch.ones_like(flat, dtype=probs.dtype))
            n = 1
            if group is not None:
                counts, n = group.rows(counts).sum(0), group.n
            mine = torch.arange(E) // (E // ep.n) == ep.index
            ce = torch.where(mine.to(counts.device), counts, 0) / (
                flat.numel() * n)
            return gate_vals, gate_idx, E * torch.sum(me * ce), before
        moe._axes, moe._route = local_axes, local_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._axes, moe._route = self.axes, self.route


#: planted faults of the mixture of experts over ``model``, each run as the
#: MoE case's placed run; each must fail check_run
MOE_FAULTS = {"fault_wrong_experts": _WrongExperts,
              "fault_combine_skip_g": _CombineSkipG,
              "fault_gate_skip_f": _GateSkipF,
              "fault_local_counts": _LocalCounts}


class _QuantRecord:
    """Records every call of ``optim.compress.quantize`` (a leaf of the
    int8 round trip): its int8 values, its scale and the values it
    rounded (``(g + e) / scale``), in call order."""

    def __enter__(self):
        from repro_torch.optim import compress
        self.real = real = compress.quantize
        self.calls = []

        def quantize(g, top=None):
            q, scale = real(g, top)
            self.calls.append((q.cpu().numpy(), float(scale),
                               (g.float() / scale).cpu().numpy()))
            return q, scale
        compress.quantize = quantize
        return self

    def __exit__(self, *exc):
        from repro_torch.optim import compress
        compress.quantize = self.real


def _record(out: dict, prefix: str, state, losses, norms) -> None:
    from repro_torch.ckpt.manager import tree_flatten
    out[prefix + ".losses"] = np.asarray(losses)
    out[prefix + ".grad_norms"] = np.asarray(norms)
    for name, tree in (("param", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        for i, x in enumerate(tree_flatten(tree)):
            out[f"{prefix}.{name}_{i}"] = x.detach().float().cpu().numpy()


def compressed(cfg, run, state):
    """``run`` with int8 gradient compression and ``state`` with its error
    carry (zeros like the parameters)."""
    import dataclasses
    from repro_torch.optim.compress import init_error
    return (dataclasses.replace(run, grad_compression=True),
            state._replace(err=init_error(state.params)))


def record_made(pl, made: dict) -> None:
    """Wraps ``pl``'s gather of one leaf (where every tensor the
    placement makes of a leaf is made) so that ``made`` keeps the shape
    of the largest one made of each leaf, under its "/"-joined path."""
    real = pl._gather

    def gather(shard, path, local=False):
        x = real(shard, path, local)
        key = "/".join(path)
        if x.numel() > int(np.prod(made.get(key, [0]))):
            made[key] = list(x.shape)
        return x
    pl._gather = gather


def placed_run(io, case, mesh, device, wrong_half=False, made=None,
               compression=False) -> tuple:
    """TRAIN_STEPS sharded steps of ``case`` on the 2 x 2 mesh with
    ``fsdp=True``: (state of shards, losses, grad norms).  ``wrong_half``
    plants a fault: both data rows take the batch's first half.  ``made``
    (a dict) receives the largest tensor the placement made of each leaf;
    ``compression`` runs the int8 round trip."""
    from repro_torch.dist.sharding import place_train_state
    from repro_torch.train.step import train_step
    cfg, run, state = train_setup(io, case, device)
    if compression:
        run, state = compressed(cfg, run, state)
    state, pl = place_train_state(state, mesh, fsdp=True,
                                  grad_compression=compression)
    if made is not None:
        record_made(pl, made)
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
    as it is and with both ranks on the first half; the dense case with
    each of TP_FAULTS, the MoE case with each of MOE_FAULTS, each of
    LAYER_FAULTS on its case; the dense
    case with int8 compression, every quantized leaf recorded."""
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
        made = {}
        state, *rest = placed_run(io, case, mesh, device, made=made)
        _record(out, case, state, *rest)
        out[f"made_{case}"] = record(made)
        out[f"shapes_{case}"] = record([list(x.shape) for x in
                                        tree_flatten(state.params)])
    for name, fault in TP_FAULTS.items():
        with fault():
            _record(out, name, *placed_run(io, "dense", mesh, device))
    for name, fault in MOE_FAULTS.items():
        with fault():
            _record(out, name, *placed_run(io, "moe", mesh, device))
    for name, (fault, case) in LAYER_FAULTS.items():
        with fault():
            _record(out, name, *placed_run(io, case, mesh, device))
    with _QuantRecord() as rec:
        _record(out, "compressed", *placed_run(io, "dense", mesh, device,
                                               compression=True))
    for i, (q, scale, v) in enumerate(rec.calls):
        out[f"compressed.q_{i}"], out[f"compressed.scale_{i}"] = q, scale
        out[f"compressed.v_{i}"] = v
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


def check_update(got, want, p0, nu, other_grads=None) -> float:
    """Every leaf's change over the run against the reference's (the
    limits above; ``nu``: the reference's second moments); returns the
    share of entries held to UPDATE_RTOL.  ``other_grads`` (a mask a
    leaf) marks entries whose gradient legitimately differs from the
    reference's (an int8 step apart, vouched for by
    :func:`check_compressed`): they are held to twice the rates' sum
    only."""
    rates = rate_sum()
    big_n = total = 0
    for i, (g, w, p, v) in enumerate(zip(got, want, p0, nu)):
        assert g.shape == w.shape == p.shape == v.shape
        dg, dw = g - p, w - p
        spacing = 4 * np.finfo(np.float32).eps * np.abs(p)
        err = np.abs(dg - dw)
        big = held(dw, v, rates)
        if other_grads is not None:
            big &= ~other_grads[i]
        assert np.all(err[big] <= UPDATE_RTOL * np.abs(dw[big])
                      + spacing[big]), float(
            (err[big] / np.abs(dw[big])).max())
        assert np.all(err <= 2 * rates + spacing), float(err.max())
        big_n, total = big_n + int(big.sum()), total + big.size
    assert big_n > 0
    return big_n / total


def check_run(got: dict, want: dict, p0, moments: bool = True,
              rtol: float = PORT_RTOL, nu=None, other_grads=None) -> None:
    """``got`` against ``want`` (losses, grad_norms, params and, with
    ``moments``, mu and nu, leaves in one order); ``nu``, the second
    moments that pick the entries held to UPDATE_RTOL, is ``want``'s
    unless given; ``other_grads`` is :func:`check_update`'s."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=rtol)
    check_update(got["params"], want["params"], p0,
                 want["nu"] if nu is None else nu, other_grads)
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


def _full(outs, key, like, offset=0):
    """Every leaf of ``key`` reassembled from the ranks' shards by the
    placement's specs (the shards of one leaf tile it); leaf ``i`` is the
    record ``{key}_{offset + i}``."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.dist.sharding import _paths, param_shardings
    stand_in = type("StandIn", (), {"shape": {"data": 2, "model": 2}})()
    specs = [s for _, s in _paths(param_shardings(like, stand_in,
                                                  fsdp=True))]
    full = []
    for i, leaf in enumerate(tree_flatten(like)):
        x = np.zeros(tuple(leaf.shape),
                     outs[0][f"{key}_{offset + i}"].dtype)
        for out in outs:
            coord = {"data": int(out["coord"][0]),
                     "model": int(out["coord"][1])}
            idx = []
            for dim, a in enumerate(list(specs[i])[:x.ndim]):
                size = x.shape[dim] // (2 if a else 1)
                c = coord[a] if a else 0
                idx.append(slice(c * size, (c + 1) * size))
            x[tuple(idx)] = out[f"{key}_{offset + i}"]
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


def one_rank(state, case, device, compression=False) -> dict:
    """``case``'s reference: the port's one-rank step from ``state`` on the
    same whole batches, TRAIN_STEPS times, as numpy, with p0, the initial
    parameters.  ``compression``: with the int8 round trip, each
    quantized leaf recorded (``quant``: its int8 values, scale and the
    values it rounded, step by step)."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import train_step
    arch, over, _ = TRAIN_CASES[case]
    cfg = reduced_config(arch, **over)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], lr=TRAIN_LR)
    if compression:
        run, state = compressed(cfg, run, state)

    def host(tree):
        return [x.detach().float().cpu().numpy().copy()
                for x in tree_flatten(tree)]
    p0 = host(state.params)
    losses, norms = [], []
    with _QuantRecord() as rec:
        for b in train_batches(case):
            state, m = train_step(state, _on(b, device), cfg, run)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"losses": np.asarray(losses), "grad_norms": np.asarray(norms),
            "p0": p0, "params": host(state.params), "mu": host(state.opt.mu),
            "nu": host(state.opt.nu), "quant": rec.calls}


def compressed_quant(io, world=4) -> list:
    """The placed compressed run's int8 round trip from the ranks, one
    entry per quantized leaf in call order: (the whole leaf's int8
    values and the values they rounded, ``(g + e) / scale``, each
    reassembled from the shards by the specs, and the scales of every
    rank)."""
    from repro_torch.ckpt.manager import tree_flatten
    outs = [load(io, "train", r) for r in range(world)]
    like = like_params("dense")
    n = len(tree_flatten(like))
    calls = len([k for k in outs[0] if k.startswith("compressed.scale_")])
    out = []
    for t in range(0, calls, n):
        q = _full(outs, "compressed.q", like, offset=t)
        v = _full(outs, "compressed.v", like, offset=t)
        for j in range(n):
            out.append((q[j], v[j], [float(o[f"compressed.scale_{t + j}"])
                                     for o in outs]))
    return out


def edge_band(scale_gap: float) -> float:
    """How far (in steps) float32 rounding can move a value between two
    runs whose scales differ by ``scale_gap`` (relative; the max entry's
    own difference): that gap over the largest value, 127 steps, and
    float32's rounding of it (half a unit in the last place, 2^-24
    relative)."""
    return 127 * (scale_gap + 2.0 ** -24)


def check_compressed(got: list, want: list, n_leaves: int) -> tuple:
    """The placed compressed step's int8 round trip (``got``:
    :func:`compressed_quant`) against the one-rank step's (``want``:
    :func:`one_rank`'s ``quant``), ``n_leaves`` quantized leaves a step:
    every rank's scale within PORT_RTOL, and every int8 entry equal to
    the one-rank step's, or one step off only where

    * each run rounded its own value to nearest (so a bin edge lies
      between the two values), and the placed value lies within
      :func:`edge_band` of where the one-rank value predicts it: that
      value plus the difference of the two runs' error-feedback carries
      from the step before, which is a band's width unless that step
      flipped the entry (a flip moves a step of the leaf into the carry);
    * after such a flip (carried), the entry moves the way the carry
      does.

    Returns ``(at_edge, carried, flipped)``: the counts of entries off at
    an edge with no carry and of entries off by a carry, and, for each
    leaf, the mask of its entries that were off at some step."""
    assert len(got) == len(want) > 0
    at_edge = carried = 0
    carry, flipped = {}, {}
    for i, ((q, v, scales), (wq, wscale, wv)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(scales, wscale, rtol=PORT_RTOL)
        assert q.shape == wq.shape == v.shape == wv.shape
        j, s = i % n_leaves, scales[0]
        band = edge_band(max(abs(x - wscale) for x in scales) / wscale)
        d = q.astype(np.int32) - wq.astype(np.int32)
        # the carries' difference from the step before, in this step's
        # steps of the one-rank value
        c = carry.get(j, np.zeros(q.shape)) / s
        rounded = ((q == np.clip(np.round(v), -127, 127))
                   & (wq == np.clip(np.round(wv), -127, 127)))
        predicted = np.abs(v - (wv * (wscale / s) + c)) <= band
        was = flipped.get(j, np.zeros(q.shape, bool))
        by_carry = np.abs(c) > band
        ok = (np.abs(d) == 1) & rounded & predicted & (
            ~by_carry | (np.sign(d) == np.sign(c)))
        bad = (d != 0) & ~ok
        assert not bad.any(), (i, int(bad.sum()), int(np.abs(d).max()))
        at_edge += int(((d != 0) & ~by_carry).sum())
        carried += int(((d != 0) & by_carry).sum())
        flipped[j] = was | (d != 0)
        carry[j] = ((v.astype(np.float64) - q) * s
                    - (wv.astype(np.float64) - wq) * wscale)
    return at_edge, carried, [flipped[j] for j in range(n_leaves)]


# ---------------------------------------------------------------------------
# the placed serve step: one rank's share of JAX's decode and prefill cells
# ---------------------------------------------------------------------------
#: (arch, batch, cache length, prompt, decode steps): reduced gemma2-2b (2
#: KV heads: heads on ``model``; a local ring whose ``pos`` is split over
#: ``model``), reduced recurrentgemma-9b (1 KV head: the sequence on
#: ``model``; the RG-LRU ``h`` and ``conv`` split by width) and reduced
#: deepseek-moe-16b (4 KV heads on ``model``; 2 of its 4 experts a rank,
#: its shared expert on half its hidden dim), reduced xlstm-125m (the mLSTM
#: and sLSTM on their heads, the state whole over ``model``) and reduced
#: whisper-tiny (its encoder over SERVE_FRAMES frames and cross-attention
#: on their heads; ``enc_out`` from the encoder on each rank's rows, as
#: JAX's callers compute it)
SERVE_CASES = {"gemma2": ("gemma2-2b", 4, 32, 8, 4),
               "recurrentgemma": ("recurrentgemma-9b", 4, 32, 8, 4),
               "moe": ("deepseek-moe-16b", 4, 32, 8, 4),
               "xlstm": ("xlstm-125m", 4, 32, 8, 4),
               "whisper": ("whisper-tiny", 4, 32, 8, 4)}
#: an encoder-decoder serve case's frames: its encoder's positions a row,
#: standard normal times this scale
SERVE_FRAMES_SCALE = 0.5

#: the placed float32 step lies within SERVE_K times the float32 one-rank
#: step's distance from the float64 one-rank step (``d32``), for each
#: logit row and each cache leaf.  Derived from the sums the placed step
#: reorders (row-parallel sums after ``wo``, ``wd`` and ``w_out``, the
#: vocab-parallel lookup, the RG-LRU gates' products over the gathered
#: ``u``, a sequence-split softmax's row sum and ``P V``; and a mixture of
#: experts' combine, each rank's slots of its experts plus its shared
#: expert's partial sum, summed over the ranks): a sum of N float32 terms
#: over n = 2 ranks rounds (N/n - 1) + (n - 1) times, at most the
#: one-rank sum's N - 1, so the placed step's rounding error has the
#: one-rank step's size; the factor 2 holds the largest of one run's
#: errors over a row or a leaf against another run's.  Stated before the
#: first run of the placed step on its shards, not fitted.
SERVE_K = 2.0


class _Float64:
    """The one-rank step in float64 throughout: ``Tensor.float`` and
    ``Tensor.to(float32)`` leave a float64 tensor float64 (the model's
    casts to float32 are where bf16 activations widen), so the float64
    run rounds nowhere in float32 but in RoPE's angles, which every run
    computes alike from integer positions."""

    def __enter__(self):
        self.real = real_float, real_to = torch.Tensor.float, torch.Tensor.to

        def flt(t, *a, **kw):
            return t if t.dtype == torch.float64 else real_float(t, *a, **kw)

        def to(t, *a, **kw):
            if t.dtype == torch.float64:
                a = tuple(torch.float64 if x is torch.float32 else x
                          for x in a)
                if kw.get("dtype") is torch.float32:
                    kw["dtype"] = torch.float64
            return real_to(t, *a, **kw)
        torch.Tensor.float, torch.Tensor.to = flt, to
        return self

    def __exit__(self, *exc):
        torch.Tensor.float, torch.Tensor.to = self.real


class _Logits:
    """Records the logits of every greedy pick (a prefill's, then each
    decode step's), as the rank holds them: its rows, and its vocabulary
    columns on a placed step."""

    def __enter__(self):
        from repro_torch.serve import engine as eng
        self.real = real = eng._greedy
        self.rows = []

        def greedy(logits, tp=None):
            self.rows.append(logits[:, -1].double().cpu().numpy())
            return real(logits, tp)
        eng._greedy = greedy
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine as eng
        eng._greedy = self.real


def serve_made(pl, made: dict) -> None:
    """Wraps ``pl`` (a ServePlacement) so that ``made`` keeps, by
    "/"-joined path, the largest tensor made of each parameter leaf
    (``Placement._gather``, where every gathered leaf is made) and of each
    cache leaf that a layer reads larger than its shard (``cache_in``,
    under ``cache/<layer>/<field>``)."""
    record_made(pl.params, made)
    real = pl.cache_in

    def cache_in(c, i, tp=None):
        out = real(c, i, tp)
        for f, x, y in zip(c._fields, c, out):
            key = f"cache/{i}/{f}"
            if y.numel() > x.numel() and y.numel() > int(
                    np.prod(made.get(key, [0]))):
                made[key] = list(y.shape)
        return out
    pl.cache_in = cache_in


def serve_inputs(case, device) -> tuple:
    """``case``'s config, its float32 parameters, its prompt [B, T]
    (int32) and an encoder-decoder's frames [B, S, d] (else None), each
    from its seed."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tf
    arch, B, _, T, _ = SERVE_CASES[case]
    cfg = reduced_config(arch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # erfinv's CPU paths: the same bits on
    params = tf.init_params(     # every rank and in the reference
        cfg, torch.Generator(device=device).manual_seed(5))
    torch.set_num_threads(threads)
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32).to(device)
    frames = None
    if cfg.encoder_layers:
        frames = torch.from_numpy((np.random.default_rng(7).standard_normal(
            (B, cfg.encoder_tokens, cfg.d_model)) * SERVE_FRAMES_SCALE
        ).astype(np.float32)).to(device)
    return cfg, params, tokens, frames


def serve_run(case, device, placement=None, dtype=torch.float32,
              made=None) -> dict:
    """Prefill and ``steps`` decode steps of ``case`` from one seed: the
    one-rank step (``placement`` None; ``dtype`` float32, or float64
    through :class:`_Float64`) or this rank's placed float32 step.
    Returns, as numpy, the tokens, lengths and stats of every step, the
    logits of every greedy pick as this rank holds them (with its mesh
    coordinate on a placed step), the store and the whole cache after the
    last step; ``made`` receives the placement's largest tensors
    (:func:`serve_made`)."""
    from repro_torch.ckpt.manager import tree_flatten
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.specs import map_leaves
    from repro_torch.serve import engine as eng
    from repro_torch.models import transformer as tf
    _, B, L, _, steps = SERVE_CASES[case]
    cfg, params, tokens, frames = serve_inputs(case, device)
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"])
    if dtype == torch.float64:
        params = map_leaves(params, lambda x: x.double())
        frames = frames.double() if frames is not None else None
    state = eng.make_serve_state(cfg, run, params, B, L, dtype, device)
    if dtype == torch.float64:   # a recurrent state is float32 by default
        state = state._replace(cache=map_leaves(
            state.cache, lambda x: x.double() if x.is_floating_point()
            else x))
    pl = placement(cfg, params, state.cache) if placement else None
    out = {}
    if pl is not None:
        if made is not None:
            serve_made(pl, made)
        state = state._replace(
            params=pl.params.shard_tree(params),
            cache=pl.shard_cache(state.cache),
            cache_len=pl.rows(state.cache_len).clone(),
            last_tokens=pl.rows(state.last_tokens).clone())
        out["coord"] = np.asarray(pl.params.mesh.get_coordinate())
    whole = pl.whole if pl is not None else (lambda x: x)
    rows = pl.rows if pl is not None else (lambda x: x)
    with (_Float64() if dtype == torch.float64
          else contextlib.nullcontext()), _Logits() as seen:
        state = eng.prefill_step(state, cfg, run, tokens, frames,
                                 placement=pl)
        # an encoder-decoder's enc_out, as JAX's callers compute it: the
        # encoder over this rank's rows, the whole batch's passed
        enc = None if frames is None else whole(tf._run_encoder(
            state.params, cfg, rows(frames), pl))
        out["toks_0"] = whole(state.last_tokens).cpu().numpy()
        out["lens_0"] = whole(state.cache_len).cpu().numpy()
        for i in range(1, steps + 1):
            state, toks, _, stats = eng.decode_one(state, cfg, run, enc,
                                                   placement=pl)
            out[f"toks_{i}"] = toks.cpu().numpy()
            out[f"lens_{i}"] = whole(state.cache_len).cpu().numpy()
            out[f"stats_{i}"] = np.stack([v.cpu().numpy()
                                          for v in stats.values()])
    for i, x in enumerate(seen.rows):
        out[f"logits_{i}"] = x
    for j, x in enumerate(tree_flatten(state.mv)):
        out[f"mv_{j}"] = x.cpu().numpy()
    cache = pl.gather_cache(state.cache) if pl is not None else state.cache
    for j, x in enumerate(tree_flatten(cache)):
        out[f"cache_{j}"] = x.cpu().numpy()
    return out


class _WrongShard:
    """Planted fault: a rank writes its new cache pieces into the wrong
    shard (the piece of the next index along the first split dim)."""

    def __enter__(self):
        from repro_torch.dist import sharding
        self._cut = cut = sharding.ServePlacement._cut_leaf

        def wrong(pl, x, spec, first):
            dims = pl._dims(spec, first)
            if first == 1 and dims:
                d, axes = dims[0]
                idx, k = pl.params._index(axes)
                x = x.chunk(k, dim=d)[(idx + 1) % k]
                spec = tuple(None if i == d else e
                             for i, e in enumerate(spec))
            return cut(pl, x, spec, first)
        sharding.ServePlacement._cut_leaf = wrong
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import sharding
        sharding.ServePlacement._cut_leaf = self._cut


class _ServeSkipG:
    """Planted fault: serving attention returns this rank's partial
    output, ``g`` (the sum over the ``model`` ranks) skipped after
    ``wo``."""

    def __enter__(self):
        from repro_torch.models import attention as att
        self.real = att._serve_out
        att._serve_out = lambda params, out, tp: att._out_proj(params, out)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as att
        att._serve_out = self.real


class _NoVocabOffset:
    """Planted fault: the vocab-parallel greedy pick combines each rank's
    first index without its block's first row (every rank's offset 0)."""

    class _Axis:
        def __init__(self, tp):
            self.tp, self.index, self.n = tp, 0, tp.n

        def reduce(self, x, op):
            return self.tp.reduce(x, op)

    def __enter__(self):
        from repro_torch.serve import engine as eng
        self.real = real = eng._greedy

        def greedy(logits, tp=None):
            return real(logits, self._Axis(tp) if tp is not None else None)
        eng._greedy = greedy
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine as eng
        eng._greedy = self.real


class _LocalRowSum:
    """Planted fault: a sequence-split decode normalises ``p`` by this
    rank's row sum, not the sum over the ranks: ``_decode_attend``'s axis
    skips the second of its three reductions (the row max and ``P V``
    still reduced)."""

    class _Axis:
        def __init__(self, tp):
            self.tp, self.calls = tp, 0

        def __getattr__(self, name):
            return getattr(self.tp, name)

        def reduce(self, x, op=dist.ReduceOp.SUM):
            self.calls += 1
            return x if self.calls == 2 else self.tp.reduce(x, op)

    def __enter__(self):
        from repro_torch.models import attention as att
        self.real = real = att._decode_attend

        def attend(cfg, q, k, v, mask, out_dtype, tp=None):
            return real(cfg, q, k, v, mask, out_dtype,
                        None if tp is None else self._Axis(tp))
        att._decode_attend = attend
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as att
        att._decode_attend = self.real


class _StaleHeads:
    """Planted fault: an xLSTM layer's new state is not gathered over
    ``model``: each rank writes its heads into the state it was given,
    the other heads left as they were."""

    def __enter__(self):
        from repro_torch.dist import sharding
        self.real = real = sharding.ServePlacement.cache_out

        def cache_out(pl, new, old, i, tp=None):
            if tp is None or not tp.joined:
                return real(pl, new, old, i, tp)
            out = []
            for f, n, o in zip(new._fields, new, old):
                if f in tp.joined:
                    w = o.clone()
                    w.chunk(tp.n, dim=1)[tp.index].copy_(n)
                    n = w
                out.append(n)
            return type(new)(*out)
        sharding.ServePlacement.cache_out = cache_out
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import sharding
        sharding.ServePlacement.cache_out = self.real


#: planted faults of the placed serve step: (fault, case, ranks that run
#: under it); each must fail check_serve
SERVE_FAULTS = {"wrong_shard": (_WrongShard, "gemma2", (1,)),
                "skip_g": (_ServeSkipG, "gemma2", (0, 1, 2, 3)),
                "vocab_offset": (_NoVocabOffset, "gemma2", (0, 1, 2, 3)),
                "local_row_sum": (_LocalRowSum, "recurrentgemma",
                                  (0, 1, 2, 3)),
                "stale_heads": (_StaleHeads, "xlstm", (0, 1, 2, 3))}


def program_serve(rank, world, io, device) -> None:
    """Each serve case on a 2 x 2 (data, model) mesh: the placed float32
    step (parameters by ``param_shardings(fsdp=False)``, the cache by
    ``cache_shardings``), with every tensor the placement makes recorded;
    each of SERVE_FAULTS on its case; rank 0 also runs the one-rank step
    in float32 and in float64."""
    from repro_torch.dist.sharding import ServePlacement, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import cache_shardings
    mesh = make_host_mesh(2, 2, device=device)

    def placement(cfg, params, cache):
        return ServePlacement(
            mesh, param_shardings(params, mesh, fsdp=False),
            cache_shardings(cache, mesh, cfg, cache[0][0].shape[0]))

    for case in SERVE_CASES:
        made = {}
        rec = serve_run(case, device, placement, made=made)
        save(io, f"serve_{case}", rank, made=record(made), **rec)
        if rank == 0:
            save(io, f"serve_ref_{case}", 0, **serve_run(case, device))
            save(io, f"serve_ref64_{case}", 0,
                 **serve_run(case, device, dtype=torch.float64))
    for name, (fault, case, ranks) in SERVE_FAULTS.items():
        with fault() if rank in ranks else contextlib.nullcontext():
            save(io, f"serve_fault_{name}", rank,
                 **serve_run(case, device, placement))


def _assemble(recs: list, key: str) -> np.ndarray:
    """A whole logit array from every rank's block: rank at coordinate
    (data i, model j) holds rows block i and columns block j."""
    coords = [tuple(r["coord"]) for r in recs]
    nd, nm = (max(c[k] for c in coords) + 1 for k in (0, 1))
    b, v = recs[0][key].shape
    out = np.empty((b * nd, v * nm))
    for r, (i, j) in zip(recs, coords):
        out[i * b:(i + 1) * b, j * v:(j + 1) * v] = r[key]
    return out


def check_serve(got: list, want32: dict, want64: dict, k: float = SERVE_K
                ) -> dict:
    """Every rank's record of the placed step (``got``, one per rank)
    against the one-rank step's in float32 (``want32``) and float64
    (``want64``).

    * Exact, on every rank and at every step: the lengths, the stats and
      the store (they depend on lengths alone).
    * Each row of logits, step by step (the prefill's pick, then each
      decode step's): the placed logits within ``k * d32`` of float64's,
      ``d32`` the float32 one-rank row's largest distance from them.  A
      row's tokens are equal in all three runs while its float64 top-2
      margin exceeds twice that limit; from the first step where it does
      not, the row may take another token, and its logits, tokens and
      cache are no longer compared.
    * The whole cache after the last step, on the rows still compared:
      each float leaf within ``k * d32`` of float64's, each integer leaf
      (a ring's ``pos``) equal.

    Returns the steps at which a row's margin stopped the comparison
    ({row: step}) and the worst ratio of error to ``d32``."""
    for rec in got:
        assert sorted(k_ for k_ in rec if k_ not in ("coord", "made")) \
            == sorted(want32), "records differ in their keys"
        for key in want32:
            if key.startswith(("lens_", "stats_", "mv_")):
                np.testing.assert_array_equal(rec[key], want32[key],
                                              err_msg=key)
    steps = sum(1 for key in want32 if key.startswith("logits_"))
    B = want32["logits_0"].shape[0]
    live = np.ones(B, dtype=bool)
    closed, worst = {}, 0.0
    for s in range(steps):
        key = f"logits_{s}"
        l64, l32 = want64[key], want32[key]
        lp = _assemble(got, key)
        d32 = np.abs(l32 - l64).max(axis=-1)
        err = np.abs(lp - l64).max(axis=-1)
        limit = k * d32
        top2 = np.sort(l64, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        for b in np.flatnonzero(live):
            assert err[b] <= limit[b], \
                f"step {s} row {b}: logits {err[b]} from float64, " \
                f"limit {limit[b]} ({k} x {d32[b]})"
            worst = max(worst, err[b] / d32[b] if d32[b] else 0.0)
            if margin[b] <= 2 * limit[b]:
                live[b] = False
                closed[int(b)] = s
                continue
            toks = f"toks_{s}"
            assert want32[toks][b] == want64[toks][b] and all(
                rec[toks][b] == want64[toks][b] for rec in got), \
                f"step {s} row {b}: tokens differ at margin {margin[b]}"
    for key in (k_ for k_ in want32 if k_.startswith("cache_")):
        w64, w32 = want64[key][live], want32[key][live]
        for rec in got:
            g = rec[key][live]
            if not np.issubdtype(w32.dtype, np.floating):
                np.testing.assert_array_equal(g, w32, err_msg=key)
                continue
            d32 = float(np.abs(w32 - w64).max()) if w32.size else 0.0
            err = float(np.abs(g - w64).max()) if g.size else 0.0
            assert err <= k * d32, \
                f"{key}: {err} from float64, limit {k} x {d32}"
            worst = max(worst, err / d32 if d32 else 0.0)
    return {"closed": closed, "worst": worst}


PROGRAMS = {"engine": program_engine, "pipeline": program_pipeline,
            "train": program_train, "serve": program_serve}


def main(argv) -> int:
    rank, world, io, device = int(argv[1]), int(argv[2]), argv[3], argv[4]
    # one thread a rank: the four rank processes share the host's cores,
    # and at torch's default each takes all of them, so the ranks' small
    # ops spend their time in the threads' contention (3 steps of the MoE
    # case took 29.6 s so on an 8-core host, 3.0 s in one thread)
    torch.set_num_threads(1)
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
