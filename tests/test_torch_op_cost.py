"""The port's dispatch-level cost counter (``repro_torch.launch.op_cost``)
against the JAX package's ``analyze_hlo`` on the programs of
``tests/launch/test_hlo_cost.py``, and its own rules.

* A 128 x 256 x 512 matmul: FLOPs exactly ``analyze_hlo``'s.
* ``tanh(c @ w)`` 13 times (JAX: a 13-step scan) and ``c @ w`` 3 times 5
  times (a 5 x 3 nested scan): FLOPs within JAX's own tolerances there
  (1 % and 2 %) of ``analyze_hlo``'s of the scans, and of the analytic
  count.  Eager code has no loop to multiply: the counter sees every trip.
* An embedding gather charges the rows read, not the table (JAX's test's
  bound, 1e6 bytes, against a 12.8 MB table).
* The collective byte model on a 4-rank fake group (a subprocess: a fake
  default group is one a process) equals ``dryrun.collective_census``'s
  on HLO lines of the same shapes.
* A kernel wrapper charges its roofline cost once a call, on fake tensors
  (its shape-only route) as on CPU tensors (its plain version), and the
  ops inside are not counted; host reads of fake tensors are explored, a
  non-boolean one raises.
* The charge hook lives in the kernels layer (``repro_torch.kernels.cost``):
  with no counter a charged call computes no cost, and neither the kernel
  wrappers nor ``dist/overlap.py`` load the launch tooling (``op_cost``,
  ``roofline``).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

jax.config.update("jax_platform_name", "cpu")

from repro.launch.hlo_cost import analyze_hlo

from repro_torch.kernels import cost
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.version_search import ops as search_ops
from repro_torch.launch import op_cost, roofline
from repro_torch.launch.op_cost import DataDependentRead, OpCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hlo(f, *specs):
    return jax.jit(f).lower(*specs).compile().as_text()


def _count(fn, *args):
    c = OpCounter("cpu")
    with c:
        c.explore(lambda: fn(*args))
    return c.result()


def test_matmul_exact():
    txt = _hlo(lambda a, b: a @ b,
               jax.ShapeDtypeStruct((128, 256), jnp.float32),
               jax.ShapeDtypeStruct((256, 512), jnp.float32))
    got = _count(lambda a, b: a @ b, torch.randn(128, 256),
                 torch.randn(256, 512))
    assert got["flops"] == analyze_hlo(txt)["flops"] == 2 * 128 * 256 * 512


def test_loop_every_trip_counted():
    def jf(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=13)[0]

    def tf(x, w):
        for _ in range(13):
            x = torch.tanh(x @ w)
        return x

    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    want = analyze_hlo(_hlo(jf, s, s))["flops"]
    got = _count(tf, torch.randn(64, 64), torch.randn(64, 64))
    expect = 13 * (2 * 64**3 + 64 * 64)
    assert abs(got["flops"] - want) / want < 0.01
    assert abs(got["flops"] - expect) / expect < 0.01
    assert got["transcendentals"] == 13 * 64 * 64


def test_nested_loops_multiply_both_levels():
    def jf(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def tf(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    s = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    want = analyze_hlo(_hlo(jf, s, s))["flops"]
    got = _count(tf, torch.randn(32, 32), torch.randn(32, 32))["flops"]
    expect = 5 * 3 * 2 * 32**3
    assert abs(got - want) / want < 0.02
    assert abs(got - expect) / expect < 0.02


def test_gather_counts_result_not_table():
    table = torch.randn(50_000, 64)
    ids = torch.randint(0, 50_000, (8,))
    got = _count(lambda t, i: t[i], table, ids)["traffic_bytes"]
    assert got < 1e6, got
    emb = _count(torch.nn.functional.embedding, ids, table)["traffic_bytes"]
    assert emb < 1e6, emb


def test_views_and_empty_cost_nothing():
    x = torch.randn(64, 32)
    got = _count(lambda x: (x.view(32, 64).t()[:5].unsqueeze(0),
                            torch.empty(1000), x.transpose(0, 1)), x)
    assert got["flops"] == got["traffic_bytes"] == 0


def test_in_place_update_charges_the_update():
    big, upd = torch.zeros(1000, 64), torch.ones(4, 64)
    got = _count(lambda b, u: b[:4].copy_(u), big, upd)
    assert got["traffic_bytes"] == 2 * upd.numel() * 4
    assert got["flops"] == 0


_COLLECTIVES_SUB = r"""
import json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro.launch.dryrun import collective_census
from repro_torch.dist import overlap
from repro_torch.launch.op_cost import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
shapes = json.loads(sys.argv[1])
c = OpCounter("cpu")
with FakeTensorMode(), c:
    x = torch.empty(shapes["x"])
    overlap.all_gather_cat(x, None, dim=0)
    overlap.all_reduce_(x, None)
    overlap.exchange(x, 1, 3)
    overlap.ring_all_reduce(x)
    overlap.broadcast_(x, 0, None)
r, a = "f32[%s]{1,0}" % ",".join(map(str, shapes["x"])), shapes["x"]
g = "f32[%d,%d]{1,0}" % (4 * a[0], a[1])
hlo = "\n".join([
    "  %%ag = %s all-gather(%s %%p), dimensions={0}" % (g, r),
    "  %%ar = %s all-reduce(%s %%p), to_apply=%%add" % (r, r),
    "  %%cp = %s collective-permute(%s %%p), source_target_pairs={{0,1}}"
    % (r, r),
    "  %%ar2 = %s all-reduce(%s %%p), to_apply=%%add" % (r, r)])
print(json.dumps({"port": c.result()["collectives"],
                  "jax": collective_census(hlo)}))
"""


def test_collective_byte_model_equals_jax_census():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _COLLECTIVES_SUB,
         json.dumps({"x": [16, 32]})], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    port, want = res["port"], res["jax"]
    nbytes = 16 * 32 * 4
    assert port["broadcast"] == {"count": 1, "bytes": nbytes}
    del port["broadcast"]
    assert port == want
    assert want["all-gather"]["bytes"] == 4 * nbytes
    assert want["all-reduce"] == {"count": 2, "bytes": 2 * 2 * nbytes}


def test_kernel_wrapper_charges_its_roofline_cost():
    """K6 on fake tensors (the shape-only route) and on CPU tensors (the
    plain version) charges the same, once, with no op of its own."""
    shape, kv = (2, 4, 64, 16), (2, 2, 64, 16)
    want = roofline.flash_prefill_cost(2, 4, 2, 64, 64, 16, 4, 8, True)
    got = {}
    for name in ("fake", "cpu"):
        c = OpCounter("cpu")
        with (FakeTensorMode() if name == "fake"
              else torch.inference_mode()), c:
            q, k, v = torch.randn(shape), torch.randn(kv), torch.randn(kv)
            out = flash_ops.flash_attention(q, k, v, window=8)
        assert out.shape == shape
        got[name] = c.result()
    for res in got.values():
        assert res["kernels"] == {"flash_prefill": {
            "launches": 1, "flops": want[1], "bytes": want[0]}}
    assert got["fake"] == got["cpu"]
    assert flash_ops.flash_attention.launches == 0


def test_fake_route_launches_nothing():
    before = search_ops.search.launches + search_ops.value_at.launches
    c = OpCounter("cpu")
    with FakeTensorMode(), c:
        ts = torch.empty((16, 8), dtype=torch.int32)
        out = search_ops.value_at(ts, ts, None, 5)
    assert out.shape == (16,) and out.dtype == torch.int32
    assert search_ops.search.launches + search_ops.value_at.launches \
        == before
    assert c.result()["kernels"]["value_at"]["launches"] == 1


def test_explore_keeps_the_path_with_more_flops():
    def step(x, w):
        if bool((x > 0).any()):
            return x @ w @ w             # the larger branch
        return x + 1

    c = OpCounter("cpu")
    with FakeTensorMode(), c:
        x, w = torch.empty(8, 8), torch.empty(8, 8)
        c.explore(lambda: step(x, w))
    # the two matmuls, the compare and the any()
    assert c.result()["flops"] == 2 * (2 * 8**3) + 8 * 8 + 8 * 8
    with pytest.raises(DataDependentRead):
        with FakeTensorMode(), OpCounter("cpu") as c2:
            x = torch.empty(4, dtype=torch.int32)
            c2.explore(lambda: int(x.sum()))


def test_memory_follows_live_storages():
    c = OpCounter("cpu")
    with FakeTensorMode(), c:
        a = torch.empty(1000, dtype=torch.float32)
        c.mark_entry({a.untyped_storage()._cdata: 4000})

        def step():
            b = a * 2                    # 4000 live
            d = b + 1                    # 8000 live
            del b
            a.add_(1)                    # an argument written in place
            return d
        out = c.explore(step)
    assert c.temp_bytes == 8000
    assert c.written_entry_bytes == 4000
    assert out.shape == (1000,)
    assert op_cost.active() is None


def test_charge_hook_without_a_counter_computes_no_cost():
    """A charged wrapper with no counter calls through at one check of
    ``cost.ACTIVE``: its cost function is not called.  Under a counter it
    is charged once, with the call's arguments by name and defaults."""
    seen = []

    def cost_of(x, scale, **_):
        seen.append(scale)
        return 8.0 * x.numel(), float(x.numel()), "f32"

    @cost.charged("probe", cost_of)
    def probe(x, scale=2.0):
        return x * scale

    x = torch.ones(4)
    assert probe(x).tolist() == [2.0] * 4 and seen == []
    with OpCounter("cpu") as c:
        probe(x, scale=3.0)
    assert seen == [3.0]
    assert c.result()["kernels"] == {"probe": {
        "launches": 1, "flops": 4.0, "bytes": 32.0}}
    assert not cost.ACTIVE


def test_kernels_and_collectives_do_not_import_launch():
    """The dependency points downward: the kernel wrappers and the port's
    collectives load neither ``launch.op_cost`` nor ``launch.roofline``
    (``dist`` reaches ``launch.mesh`` for its meshes, as before)."""
    code = ("import sys\n"
            "import repro_torch.kernels.compact.ops\n"
            "import repro_torch.kernels.decode_attention.ops\n"
            "import repro_torch.kernels.flash_prefill.ops\n"
            "import repro_torch.kernels.version_search.ops\n"
            "import repro_torch.dist.overlap\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m in ('repro_torch.launch.op_cost',\n"
            "                      'repro_torch.launch.roofline')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
