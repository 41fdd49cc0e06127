"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's and against the bounds ``chip_smoke.py`` phase 3 printed.

* ``analyze`` and ``model_flops_per_device`` give JAX's numbers on the
  same records, with JAX's TPU peaks set to the H100 table (the formulas
  are compared, not the hardware); trap C15 (JAX's divisor of 256 chips
  on every mesh but ``multipod``) shows on a ``host`` and a ``host2``
  record.
* ``kernel_bandwidth_target`` on the CPU runners equals JAX's.
* Each kernel's cost, through ``bound``, reproduces the bound of every
  phase-3 row of ``PERF.md`` section 6 to its printed digits: from the
  shapes, and for the rows whose work depends on the data (K2's found
  rows, K4's visible tokens) from phase 3's own draws, replayed on the
  CPU with ``chip_smoke.py``'s helpers.
"""
import importlib.util
import math
import os

import jax
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.launch import roofline as jroof

from repro_torch.configs import SHAPES, list_archs, runnable
from repro_torch.kernels.version_search.ref import search_ref
from repro_torch.launch import roofline as roof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(arch, shape, mesh, chips):
    sh = SHAPES[shape]
    return {"arch": arch, "shape": shape, "mesh": mesh, "variant": "baseline",
            "chips": chips, "seq_len": sh.seq_len,
            "global_batch": sh.global_batch, "kind": sh.kind,
            "flops_per_device": 3.0e15, "bytes_per_device": 2.0e12,
            "transcendentals": 1.0e9,
            "collectives": {"all-gather": {"count": 3, "bytes": 5.0e9}},
            "collective_bytes_per_device": 5.0e9,
            "memory": {"argument_bytes": 7 * 2**30, "output_bytes": 0,
                       "temp_bytes": 9 * 2**30, "alias_bytes": 0}}


RECORDS = [_record(a, s, m, c) for a in list_archs() for s in SHAPES
           if runnable(a, s)
           for m, c in (("pod", 256), ("multipod", 512), ("host", 1))]


@pytest.fixture
def h100_jax(monkeypatch):
    """JAX's roofline module with the H100's peaks in place of the TPU's:
    the compute term at bf16, HBM, and the collective bandwidth."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roof.PEAK_FLOPS["bf16"])
    monkeypatch.setattr(jroof, "HBM_BW", roof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", roof.COLLECTIVE_BW)
    return jroof


@pytest.mark.parametrize("i", range(0, len(RECORDS), 3))
def test_analyze_equals_jax(h100_jax, i):
    for rec in RECORDS[i:i + 3]:
        got, want = roof.analyze(rec), h100_jax.analyze(rec)
        for key in got:
            if isinstance(got[key], float):
                assert got[key] == pytest.approx(want[key], rel=1e-12), key
            else:
                assert got[key] == want[key], key
        assert roof.model_flops_per_device(rec) == \
            h100_jax.model_flops_per_device(rec)


def test_failed_record_passes_through(h100_jax):
    rec = {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "pod",
           "error": "boom"}
    assert roof.analyze(rec) == h100_jax.analyze(rec)
    assert "FAILED: boom" in roof.table([roof.analyze(rec)])


def test_c15_host_records_divide_by_256_chips():
    """Trap C15, reproduced: the divisor is 256 chips on every mesh but
    ``multipod``, whatever the record's own ``chips``.  A ``host`` record
    (1 chip) gets a pod device's share of the step's useful FLOPs, so its
    useful ratio and roofline fraction are 256 times too small (a
    ``host2`` record's 128 times), in both packages."""
    pod = _record("gemma2-2b", "train_4k", "pod", 256)
    whole = roof.model_flops_per_device(pod) * 256     # the whole step
    multi = _record("gemma2-2b", "train_4k", "multipod", 512)
    assert roof.model_flops_per_device(multi) * 512 == pytest.approx(whole)
    for mesh, chips, factor in (("host", 1, 256), ("host2", 2, 128)):
        rec = _record("gemma2-2b", "train_4k", mesh, chips)
        got = roof.model_flops_per_device(rec)
        assert got == jroof.model_flops_per_device(rec)
        assert whole / chips == pytest.approx(factor * got)
        a = roof.analyze(rec)
        assert a["useful_flops_ratio"] * factor == pytest.approx(
            whole / chips / rec["flops_per_device"])
        assert a["roofline_fraction"] == pytest.approx(
            roof.analyze(pod)["roofline_fraction"])


@pytest.mark.parametrize("kernel", sorted(roof.KERNEL_BW_FRACTION))
def test_kernel_bandwidth_target_cpu_equals_jax(kernel):
    assert roof.kernel_bandwidth_target(kernel, "cpu") == \
        jroof.kernel_bandwidth_target(kernel, "cpu")
    card = roof.kernel_bandwidth_target(kernel, "cuda")
    assert card["peak_bw_gb_s"] == 3350.0
    with pytest.raises(KeyError):
        roof.kernel_bandwidth_target("paged_decode")


def test_h100_table():
    assert roof.PEAK_FLOPS == {"bf16": 989e12, "tf32": 495e12,
                               "f32": 67e12, "int32": 67e12}
    assert (roof.HBM_BW, roof.NVLINK_BW, roof.IB_BW) == (3.35e12, 450e9,
                                                         50e9)
    assert roof.COLLECTIVE_BW == roof.IB_BW


# ---------------------------------------------------------------------------
# the bounds PERF.md section 6 prints for phase 3's rows
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held(got_ms: float, printed: str) -> None:
    """``got_ms`` rounds to ``printed`` at its printed decimals."""
    decimals = len(printed.split(".")[1])
    assert abs(got_ms - float(printed)) <= 0.5 * 10 ** -decimals + 1e-15, \
        (got_ms, printed)


def _flash(c, elt):
    return roof.flash_prefill_cost(c["B"], c["Hq"], c["Hkv"], c["T"],
                                   c.get("S", c["T"]), c["D"], elt,
                                   c["window"], c.get("causal", True))


# (phase-3 row, printed bound ms, printed "bytes"/"operations")
FLASH_ROWS = [("serve", "0.417106", "operations"),
              ("gemma2_local", "0.121631", None),
              ("gemma2_w4096", "0.278071", None),
              ("gemma2_global", "0.278071", None),
              ("gemma2_ring_f32", "2.051578", None),
              ("gemma2_train_f32", "1.025914", "operations"),
              ("f32", "1.539247", "operations"),
              ("moe", "0.139035", None),
              ("whisper_encoder", "0.055911", "operations"),
              ("whisper_cross_prefill", "0.011474", "bytes"),
              ("whisper_cross_decode", "0.011012", "bytes"),
              ("recurrentgemma_local", "0.521934", None),
              ("whisper_encoder_f32", "0.825313", None),
              ("whisper_cross_prefill_f32", "0.035213", None),
              ("whisper_cross_decode_f32", "0.022023", None),
              ("recurrentgemma_local_f32", "7.704373", None),
              ("moe_placed", "0.010016", "bytes"),
              ("granite_placed_train_f32", "0.064135", "operations"),
              ("whisper_encoder_placed_train_f32", "0.025791", "operations"),
              ("whisper_cross_placed_train_f32", "0.007703", "operations"),
              ("recurrentgemma_placed_train_f32", "0.064167", "operations"),
              ("whisper_encoder_placed", "0.013978", "operations"),
              ("whisper_cross_placed", "0.002868", "bytes")]
# K6's float32 rows in their route's unit (split-TF32: three tf32
# products for each of the forward's two): (case, printed bound, by)
FLASH_TF32_ROWS = [("f32", "0.625028", "operations"),
                   ("gemma2_train_f32", "0.416583", "operations"),
                   ("gemma2_ring_f32", "0.833065", "operations"),
                   ("whisper_encoder_f32", "0.335127", "operations"),
                   ("whisper_cross_prefill_f32", "0.022947", "bytes"),
                   ("whisper_cross_decode_f32", "0.022023", "bytes"),
                   ("recurrentgemma_local_f32", "3.128442", "operations"),
                   ("gemma2_capped_f32", "0.416685", "operations"),
                   ("granite_placed_train_f32", "0.026043", "operations"),
                   ("whisper_encoder_placed_train_f32", "0.010473",
                    "operations"),
                   ("whisper_cross_placed_train_f32", "0.003128",
                    "operations"),
                   ("recurrentgemma_placed_train_f32", "0.026056",
                    "operations")]
# K6b's rows: (case, tf32 x 3 bound, CUDA-core bound, bf16 bound)
BWD_ROWS = [("gemma2_train", "1.041458", "2.564786", "0.173752"),
            ("gemma2_window512", "0.244064", "0.601053", "0.040718"),
            ("minitron", "1.562569", "3.848117", "0.260691"),
            ("whisper_cross", "0.045902", "0.088033", "0.022955"),
            ("granite_placed_train", "0.065107", "0.160338", "0.010862"),
            ("whisper_encoder_placed_train", "0.026182", "0.064478",
             "0.004368"),
            ("whisper_cross_placed_train", "0.007820", "0.019257",
             "0.001305"),
            ("recurrentgemma_placed_train", "0.065139", "0.160416",
             "0.010867")]


def test_board_bound_charges_the_probes_its_searches_reach():
    """K1/K5's board costs every entry while the searches can reach them
    all, and only their probes (``ceil(log2(P + 1))`` each) past that:
    phase 3's every-slot rows at a board of 2^20 print PERF.md's bounds,
    which the whole 4 MB board would raise about twentyfold."""
    assert roof.board_bytes(16, 4096) == 16 * 4
    assert roof.board_bytes(1 << 20, 2048) == 2048 * 21 * 4
    S, V, P = _chip_smoke().BIG_BOARD
    _held(roof.bound(*roof.needed_cost(S, V, P))[0], "0.0000569")
    _held(roof.bound(*roof.sweep_cost(S, V, S, P, lanes=False))[0],
          "0.0000685")
    whole = S * V * 9 + P * 4 + 4
    assert roof.bound(whole, 0, "int32")[0] > 20 * roof.bound(
        *roof.needed_cost(S, V, P))[0]


def test_shape_bounds_equal_perf_md():
    cs = _chip_smoke()
    p = cs.SERVE
    S, V, P = p["num_seqs"], p["versions_per_slot"], p["reader_lanes"]
    R = 2 * S * V
    _held(roof.bound(*roof.sweep_cost(S, V, R, P))[0], "0.0000599")
    _held(roof.bound(*roof.compact_cost(R, V, P))[0], "0.000275")
    _held(roof.bound(*roof.value_at_cost(16, 16))[0], "0.00000063")
    _held(roof.bound(*roof.search_cost(S, V))[0], "0.0000059")
    Sb, Vb, Bb = cs.SEARCH_BIG
    _held(roof.bound(*roof.search_cost(Bb, Vb))[0], "0.000188")
    _held(roof.bound(*roof.value_at_cost(Sb, Vb))[0], "0.00133")
    for (r, v, pp), printed in zip(cs.NEEDED_SHAPES,
                                   ("0.000088", "0.001409", "0.001410")):
        _held(roof.bound(*roof.needed_cost(r, v, pp))[0], printed)
    MP, PS = p["max_pages_per_seq"], p["page_size"]
    full = roof.paged_decode_cost(16, p["q_heads"], p["kv_heads"],
                                  p["head_dim"], 2, 16 * MP, 16 * MP * PS)
    _held(roof.bound(*full)[0], "0.080194")
    for case, printed, by in FLASH_ROWS:
        c = cs.FLASH[case]
        ms, got_by = roof.bound(*_flash(c, 2 if c["dtype"] == "bf16" else 4))
        _held(ms, printed)
        assert by is None or got_by == by, case
    for case, tf32, core, bf16 in BWD_ROWS:
        c = cs.FLASH_BWD[case]
        args = (c["B"], c["Hq"], c["Hkv"], c["T"], c.get("S", c["T"]),
                c["D"])
        kw = dict(window=c["window"], causal=c.get("causal", True))
        f32 = roof.flash_backward_cost(*args, 4, **kw)
        _held(roof.flash_backward_bound(f32)[0], tf32)
        _held(roof.bound(*f32)[0], core)
        _held(roof.flash_backward_bound(
            roof.flash_backward_cost(*args, 2, **kw))[0], bf16)


@pytest.mark.parametrize("case,printed,by", FLASH_TF32_ROWS)
def test_flash_prefill_bound_tf32_equals_perf_md(case, printed, by):
    """flash_prefill_bound of a float32 row is its split-TF32 bound, three
    tf32 products for each of the function's two, as PERF.md prints it;
    of the same row in bf16 it is ``bound`` of the bf16 cost, unchanged."""
    cs = _chip_smoke()
    c = cs.FLASH[case]
    ms, got_by = roof.flash_prefill_bound(_flash(c, 4))
    _held(ms, printed)
    assert got_by == by
    assert ms <= roof.bound(*_flash(c, 4))[0]
    bf16 = _flash(c, 2)
    assert roof.flash_prefill_bound(bf16) == roof.bound(*bf16)


def test_every_float32_flash_row_has_a_tf32_bound():
    """Every float32 K6 row of phase 3 is in FLASH_TF32_ROWS."""
    cs = _chip_smoke()
    assert {case for case, c in cs.FLASH.items() if c["dtype"] == "f32"} \
        == {case for case, _, _ in FLASH_TF32_ROWS}


def test_k6b_ab_script_times_phase_3s_cases():
    """tools/time_flash_backward.py, the A/B script of K6b, times
    chip_smoke.py's FLASH_BWD shapes under their names and holds the
    float32 route to phase 3's FLASH_BWD_TOL, so that its rows stand for
    phase 3's."""
    spec = importlib.util.spec_from_file_location(
        "time_flash_backward",
        os.path.join(ROOT, "tools", "time_flash_backward.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cs = _chip_smoke()
    assert tool.CASES == cs.FLASH_BWD
    assert tool.TOL_F32 == cs.FLASH_BWD_TOL


def test_data_bounds_equal_perf_md():
    """K2's ``view`` (0.000145 ms: the rows found at t 2000) and K4 at 256
    sequences (0.625611: the visible tokens and pages in use), from phase
    3's draws in its order (``phase_kernels``: K1's two stores, then K2's
    store and tables, then ``decode_table``), on the CPU."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    p = cs.SERVE
    S, V, P = p["num_seqs"], p["versions_per_slot"], p["reader_lanes"]
    ring = 2 * S * V
    g = torch.Generator().manual_seed(1)
    for R in (ring, ring - 3):                     # K1's compact cases
        cs._store(g, R, V, cpu)
        torch.rand((R,), generator=g)
        torch.randint(0, 4000, (P,), generator=g, dtype=torch.int32)
        torch.rand((P,), generator=g)
    ts, _, pay = cs._store(g, S, V, cpu)           # K2 and K3
    ps, MP = p["page_size"], p["max_pages_per_seq"]
    lens = torch.randint(0, ps * MP + 1, (S * V,), generator=g,
                         dtype=torch.int32)
    for r in range(S * V):
        n = (int(lens[r]) + ps - 1) // ps
        torch.randint(0, p["num_pages"], (n,), generator=g,
                      dtype=torch.int32)
    ids = torch.arange(S, dtype=torch.int32)
    found = int(search_ref(ts, pay, ids, 2000)[1].sum())
    _held(roof.bound(*roof.view_cost(S, V, MP, found))[0], "0.000145")
    table, lengths = cs.decode_table(g, S, False)  # K4 at B 256
    cost = roof.paged_decode_cost(S, p["q_heads"], p["kv_heads"],
                                  p["head_dim"], 2, int((table >= 0).sum()),
                                  int(lengths.sum()))
    ms, by = roof.bound(*cost)
    _held(ms, "0.625611")
    assert by == "bytes"


def test_visible_pairs():
    assert roof.visible_pairs(4, 0) == 10
    assert roof.visible_pairs(6, 2) == 3 + 4 * 2
    assert roof.visible_pairs(3, 0, 7, causal=False) == 21
    assert math.isclose(roof.bound(3.35e9, 0, "bf16")[0], 1.0)
