"""The facade on a block mesh (``FastDEM(mesh=...)``): four processes on the
CPU with gloo, one 2x2 mesh block each, on the GLOBAL windowed path
(``shardmap_windowed``) of a 40 m map at 0.2 m with 4,096-point scans.

(a) Over calls whose scans cross the blocks' edges and a ``reset()``, the
    map rank 0 assembles (``sharding.gather_state``) equals the one-process
    facade's bit for bit, and the plain reference of ``port_bench`` within
    the benchmark cell's limit.
(b) A rank that integrates one scan fewer in a call makes the next call
    raise on every rank, naming it, in time.
(c) Without a mesh, the facade's graph signature is that of the facade
    before meshes, and it dispatches the ops of its donating step
    (digests taken on those trees).
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import fastdem_tpu_torch as ft
from fastdem_tpu_torch.cloud import pointcloud as pc
from fastdem_tpu_torch.mapping.pipeline import FastDEM
from fastdem_tpu_torch.runtime.node_config import NodeConfig
from fastdem_tpu_torch.utils import graphs
from test_torch_graphs import RecordingGraphs
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 120
# The calls of (a): scan indices, None for a reset.
CALLS = [[0, 1, 2], [3, 4, 5], None, [6, 7, 8]]
# (b): in this call rank 2 leaves out its last scan.
SHORT_CALL, SHORT_RANK = [9, 10, 11], 2


def node_group() -> dict:
    """The benchmark's GLOBAL mesh configuration at a CPU test's size: a 40
    m map at 0.2 m and a 10 m range, so the update window (134 cells) is
    at most the map over sqrt(2) and the windowed formulation engages."""
    path = os.path.join(ROOT, "port_bench", "configs", "global_vlp16_mesh2x2.json")
    with open(path) as f:
        node = json.load(f)["node"]
    node["map"].update(width=40.0, height=40.0, resolution=0.2)
    node["point_filter"]["range_max"] = 10.0
    return node


def stream(n_scans=12, n=4096):
    """Scans of rough ground and a few posts, the robot crossing x = 0 and
    y = 0 (the blocks' edges)."""
    rng = np.random.default_rng(17)
    xyz = []
    for _ in range(n_scans):
        p = np.column_stack([rng.uniform(-9, 9, n), rng.uniform(-9, 9, n),
                             0.3 * np.sin(rng.uniform(0, 6, n)) - 1.0])
        p[: n // 16, 2] += rng.uniform(0.5, 2.0, n // 16)
        xyz.append(p.astype(np.float32))
    T_bs = np.eye(4, dtype=np.float32)
    T_bs[2, 3] = 1.0
    T_wb = np.tile(np.eye(4, dtype=np.float32), (n_scans, 1, 1))
    T_wb[:, 0, 3] = np.linspace(-4.0, 4.0, n_scans)
    T_wb[:, 1, 3] = np.linspace(3.0, -2.0, n_scans)
    return xyz, T_bs, T_wb


WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import fastdem_tpu_torch as ft
from fastdem_tpu_torch.cloud import pointcloud as pc
from fastdem_tpu_torch.mapping.pipeline import FastDEM
from fastdem_tpu_torch.parallel import sharding as sh
from fastdem_tpu_torch.parallel.distributed import init_distributed, make_global_mesh, shutdown
from fastdem_tpu_torch.runtime.node_config import NodeConfig

pid, port, scans, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
node, calls, (short_call, short_rank) = (json.loads(a) for a in sys.argv[5:8])
init_distributed(f"localhost:{port}", 4, pid, timeout_s=60)
mesh = make_global_mesh(devices=["cpu"])
with np.load(scans) as f:
    T_bs, T_wb = f["T_bs"], f["T_wb"]
    clouds = [pc.from_numpy(x, frame_id="lidar", device="cpu") for x in f["xyz"]]
geom = ft.GridGeometry.from_length(node["map"]["width"], node["map"]["height"],
                                   node["map"]["resolution"])
m = FastDEM(geom, NodeConfig.parse(node).pipeline, device="cpu", mesh=mesh)
print("formulation", m._map.step.formulation, "blocks", mesh.local_slots(), flush=True)
for call in calls:
    if call is None:
        m.reset()
    else:
        m.integrate_sequence([clouds[i] for i in call], T_bs, T_wb[call])
print("agreed", tuple(m.mesh_check()), flush=True)
full = sh.gather_state(m.state)
if pid == 0:
    np.savez(out, position=full.position.numpy(),
             **{k: v.numpy() for k, v in full.layers.items()})
short = short_call[:-1] if pid == short_rank else short_call
m.integrate_sequence([clouds[i] for i in short], T_bs, T_wb[short])
try:
    m.integrate_sequence([clouds[0]], T_bs, T_wb[:1])
    print("no error", flush=True)
    code = 1
except RuntimeError as err:
    print("raised:", err, flush=True)
    code = 0
shutdown()
sys.exit(code)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The worker in four processes: (exit codes, outputs, rank 0's map)."""
    tmp = tmp_path_factory.mktemp("mesh")
    out, scans = str(tmp / "map.npz"), str(tmp / "scans.npz")
    xyz, T_bs, T_wb = stream()
    np.savez(scans, xyz=np.stack(xyz), T_bs=T_bs, T_wb=T_wb)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port), scans, out,
             json.dumps(node_group()), json.dumps(CALLS), json.dumps([SHORT_CALL, SHORT_RANK])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(4)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    return [p.returncode for p in procs], outs, got


def one_process_map():
    geom = ft.GridGeometry.from_length(40.0, 40.0, 0.2)
    m = FastDEM(geom, NodeConfig.parse(node_group()).pipeline, device="cpu")
    xyz, T_bs, T_wb = stream()
    clouds = [pc.from_numpy(x, frame_id="lidar", device="cpu") for x in xyz]
    for call in CALLS:
        if call is None:
            m.reset()
        else:
            m.integrate_sequence([clouds[i] for i in call], T_bs, T_wb[call])
    return m.state


def test_mesh_facade_equals_one_process_and_the_reference(four_ranks):
    from port_bench.harness import check

    codes, outs, got = four_ranks
    assert all("formulation shardmap_windowed" in o for o in outs), outs[0][-3000:]
    for pid, o in enumerate(outs):
        assert f"blocks [{(pid // 2, pid % 2)}]" in o, o[-3000:]
        assert "agreed (9, 1)" in o, o[-3000:]
    one = one_process_map()
    assert set(got) == set(one.layers) | {"position"}
    for name, v in one.layers.items():
        np.testing.assert_array_equal(got[name].view(np.int32), v.numpy().view(np.int32),
                                      err_msg=name)
    np.testing.assert_array_equal(got["position"], one.position.numpy())
    assert int(np.isfinite(got["elevation"]).sum()) > 5000

    # The plain reference of the benchmark, over the same scans and reset.
    xyz, T_bs, T_wb = stream()
    log = SimpleNamespace(xyz=xyz, T_bs=T_bs, T_wb=T_wb)
    history = [h for call in CALLS for h in (call or [check.RESET])]
    ref = check.reference_map({"node": node_group()}, log, history, "cpu")
    layers = {k: v for k, v in got.items() if k != "position"}
    numbers, _ = check.compare_maps(layers, got["position"], ref)
    with open(os.path.join(ROOT, "port_bench", "limits",
                           "global_vlp16_mesh2x2.replay_4proc.json")) as f:
        assert numbers["state_err"] <= json.load(f)["state_err"], numbers


def test_a_rank_with_other_scans_raises_on_every_rank(four_ranks):
    codes, outs, _ = four_ranks
    for code, o in zip(codes, outs):
        assert code == 0, o[-3000:]
        assert "raised: the mesh's ranks hold different scans" in o, o[-3000:]
        assert f"ranks [{SHORT_RANK}] differ" in o, o[-3000:]


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_one_card_facade_unchanged(monkeypatch):
    """Two capacities captured (a recording double stands in for CUDA
    graphs), then one replay and a reset under a recording dispatch mode:
    the signatures are those of the facade before meshes; the ops are the
    donating step's (no copy of the map into the slots nor clone out of
    them, the window written into each layer's slot in place and the
    obstacle layer reset there, no copy of a layer into its slot inside
    the graph, a reset that fills the slots in place)."""
    monkeypatch.setattr(graphs, "BACKEND", RecordingGraphs())
    geom = ft.GridGeometry.from_length(20.0, 20.0, 0.1)
    cfg = ft.Config()
    cfg.mapping.mode = ft.MappingMode.GLOBAL
    cfg.point_filter.range_max = 4.0
    m = FastDEM(geom, cfg, device="cpu")
    assert m.mesh is None and m._map.step.donate is True
    rng = np.random.default_rng(5)
    eye = np.eye(4, dtype=np.float32)

    def cloud(n):
        xyz = np.column_stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                               rng.normal(-1, 0.05, n)]).astype(np.float32)
        return pc.from_numpy(xyz, frame_id="l", device="cpu")

    for n in (1000, 3000, 1000):
        m.integrate_sequence([cloud(n)], eye, eye[None])
    keys = list(m._map.step.graphs)
    assert [g.stats.replays for g in m._map.step.graphs.values()] == [2, 1]
    for key, cap in zip(keys, (1024, 4096)):
        assert [(tuple(s), d) for s, d, _ in key[1]] == (
            [((200, 200), torch.float32)] * 11 + [((2,), torch.float32), ((cap, 3), torch.float32),
                                                  ((cap,), torch.bool)]
            + [((4, 4), torch.float32)] * 2)
    spec = hashlib.sha256(repr([k[0] for k in keys]).encode()).hexdigest()
    assert spec == "38fd8567ce16cb380728c447457a6e2cd1e548ad6d7ae663e66e2f87ab2d0b23"
    c = cloud(1000)
    with Ops() as ops:
        m.integrate_sequence([c], eye, eye[None])
        m.reset()
    digest = hashlib.sha256("\n".join(ops.names).encode()).hexdigest()
    assert (len(ops.names), digest) == (
        533, "56ebe0c37aafa78340e824720b0f9053375ad6d71c5cae982d17a5fa6b527cc3")
