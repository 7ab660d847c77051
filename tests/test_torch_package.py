"""Package boundaries of the port, and ``chip_smoke.py`` without a card.

``fastdem_tpu_torch`` imports torch and never JAX; ``chip_smoke.py`` must
fail at once, and print no result, where CUDA is not available.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fastdem_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tests run torch on one intra-op thread: the suite runs in
    several worker processes, and a thread pool per worker on every core
    oversubscribes the machine (and disturbs timing-based tests elsewhere).
    The other ``test_torch_*`` modules import this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_modules():
    """The dotted names of every module of the port."""
    names = []
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                names.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(names)


def test_import_leaves_jax_out():
    """Importing every module of the port (and building a mapper and a
    driver) loads no JAX and no module of the JAX package: not by name, and
    not by path (no loaded module's file lies under ``fastdem_tpu/``)."""
    modules = port_modules()
    assert {"fastdem_tpu_torch.runtime.driver", "fastdem_tpu_torch.io.npz",
            "fastdem_tpu_torch.tools.fastdem_replay", "fastdem_tpu_torch.presets",
            "fastdem_tpu_torch.utils.colors", "fastdem_tpu_torch.cloud.normals",
            "fastdem_tpu_torch.cloud.segmentation", "fastdem_tpu_torch.cloud.registration",
            "fastdem_tpu_torch.utils.prng", "fastdem_tpu_torch.native",
            "fastdem_tpu_torch.parallel.sharding", "fastdem_tpu_torch.parallel.distributed",
            "fastdem_tpu_torch.io.sharded_ckpt", "fastdem_tpu_torch.runtime.aotcache",
            "fastdem_tpu_torch.tools.multihost_demo", "fastdem_tpu_torch.tools.aot_warmup",
            "fastdem_tpu_torch.utils.benchtime",
            "fastdem_tpu_torch.utils.profiling",
            "fastdem_tpu_torch.utils.graphs"} <= set(modules)
    jax_dir = os.path.join(ROOT, "fastdem_tpu") + os.sep
    code = (
        "import importlib, os, sys; import fastdem_tpu_torch as fd; "
        f"[importlib.import_module(m) for m in {modules!r}]; "
        "from fastdem_tpu_torch.postprocess import apply_postprocess_fn; "
        "from fastdem_tpu_torch.runtime import MappingDriver; "
        "fd.FastDEM(fd.GridGeometry.from_length(2.0, 2.0, 0.1), fd.Config(), device='cpu'); "
        "MappingDriver(fd.GridGeometry.from_length(2.0, 2.0, 0.1), device='cpu').close(); "
        "from fastdem_tpu_torch import native; native.available(); "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'fastdem_tpu.')) or m == 'fastdem_tpu'); "
        f"bad += sorted(n for n, m in list(sys.modules.items()) if os.path.abspath(getattr(m, '__file__', None) or '').startswith({jax_dir!r})); "
        # No shared object (the native scan IO) loaded from the JAX package.
        f"bad += [l for l in open('/proc/self/maps').read().splitlines() if {jax_dir!r} in l]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_sources_are_the_port_copy():
    """The native library compiles the port's own copy of the C++ sources
    into the port's build directory, never a path under ``fastdem_tpu/``."""
    from fastdem_tpu_torch import native

    jax_dir = os.path.join(ROOT, "fastdem_tpu") + os.sep
    for path in native._SRCS + [native._LIB]:
        assert os.path.abspath(path).startswith(PACKAGE + os.sep), path
        assert not os.path.abspath(path).startswith(jax_dir), path


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.MULTILINE)
    sources = []
    for dirpath, _, files in os.walk(PACKAGE):
        sources += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) > 10
    for new in ("runtime/driver.py", "runtime/wire.py", "io/pcd.py", "tools/fastdem_node.py",
                "mapping/pipeline.py", "config.py", "presets.py", "cloud/normals.py",
                "cloud/segmentation.py", "cloud/registration.py", "utils/prng.py",
                "native/__init__.py", "parallel/sharding.py", "parallel/distributed.py",
                "io/sharded_ckpt.py", "runtime/aotcache.py", "tools/multihost_demo.py",
                "tools/aot_warmup.py", "utils/benchtime.py", "utils/profiling.py",
                "utils/graphs.py"):
        assert os.path.join(PACKAGE, new) in sources, new
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_mapping_imports_nothing_of_parallel():
    """The mapping layer sits below the scale-out layer: no module of
    ``mapping/`` imports ``fastdem_tpu_torch.parallel``, at its top or
    inside a function (a mesh hands the facade its own map object)."""
    mapping = os.path.join(PACKAGE, "mapping")
    sources = sorted(f for f in os.listdir(mapping) if f.endswith(".py"))
    assert "pipeline.py" in sources
    for name in sources:
        with open(os.path.join(mapping, name)) as f:
            tree = ast.parse(f.read(), name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                targets = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            bad = [t for t in targets
                   if t == "fastdem_tpu_torch.parallel"
                   or t.startswith("fastdem_tpu_torch.parallel.")]
            assert not bad, f"mapping/{name}:{node.lineno} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout + proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script cannot find the port and fails."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout + proc.stderr
