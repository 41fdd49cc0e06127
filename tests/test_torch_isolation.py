"""The port stands alone: no module of ``repro_torch`` and no part of
``chip_smoke.py`` imports JAX or the JAX package, the package imports with
JAX absent, and its entry points refuse to fall back to the CPU when no GPU
is present and the caller did not ask for one."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value).split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "import repro_torch.serve.engine, repro_torch.convert\n"
        "import repro_torch.kernels.compact.ops\n"
        "import repro_torch.kernels.version_search.ops\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.flash_prefill.ops\n"
        "import repro_torch.launch.serve, repro_torch.configs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _entry_points():
    from repro_torch.core.mvgc import vstore
    from repro_torch.mvkv import paged
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import MVServeEngine, PagedKVEngine
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"])

    def mv_serve(**kw):
        params = tf.init_params(cfg, torch.Generator().manual_seed(0))
        return MVServeEngine(cfg, run, params, batch=2, max_len=8, **kw)

    def launch(device=None):
        flags = ["--arch", "minitron-4b", "--reduced", "--steps", "1"]
        return launcher.build(launcher.parse_args(
            flags + (["--device", device] if device else [])))

    return {
        "make_state": lambda **kw: vstore.make_state(4, 4, 2, **kw),
        "make_paged_kv": lambda **kw: paged.make_paged_kv(
            2, 8, 4, 2, 1, 4, gc=None, **kw),
        "PagedKVEngine": lambda **kw: PagedKVEngine(2, 8, 4, 2, 1, 4, **kw),
        "MVServeEngine": mv_serve,
        "launch.serve": launch,
    }


@pytest.mark.parametrize("name", ["make_state", "make_paged_kv",
                                  "PagedKVEngine", "MVServeEngine",
                                  "launch.serve"])
def test_entry_points_default_to_the_gpu(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    made = make(device="cpu")          # asked for explicitly: fine
    assert made is not None
