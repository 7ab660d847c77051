"""The compiled step of the port (``utils/graphs.py``: ``jit=True`` /
``donate=True`` as CUDA graphs), on the CPU.

Two parts:

* A capture-safety guard: a ``TorchDispatchMode`` that raises on every op
  that reads the device from the host or makes a data-dependent shape, or
  builds a tensor from host data (on a card, a copy from host memory);
  none of them may run inside a CUDA graph's capture. Every step the
  builders return runs once under it at a small map, after one call
  outside it, as the capture follows its warm-up.
* The graph plumbing against JAX: ``graphs.BACKEND`` is replaced by a test
  double that records the function at capture and, at each replay, runs
  it again and copies its results into the outputs the capture returned,
  so the slots, the donation and the cloning are those of the card. A
  session of moving LOCAL scans of two capacity buckets through
  ``build_integrate(jit=True, donate=True)`` then equals JAX's
  ``jax.jit(build_integrate(..., donate=True))`` bit for bit on every
  layer (raycast off: with it the raycast layers differ in a few cells by
  atan2's last bit, ``test_torch_pipeline.py``).
"""

import copy
import gc
import inspect
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import fastdem_tpu as fj
import fastdem_tpu_torch as ft
from fastdem_tpu.mapping import pipeline as pl_j
from fastdem_tpu_torch.mapping import pipeline as pl_t
from fastdem_tpu_torch.postprocess import apply_postprocess_fn
from fastdem_tpu_torch.runtime import MappingDriver
from fastdem_tpu_torch.utils import graphs
from test_torch_package import one_torch_thread  # noqa: F401 (autouse)
from test_torch_replay import assert_bitwise

aten = torch.ops.aten
HOST_READS = {
    aten._local_scalar_dense.default, aten.item.default, aten.is_nonzero.default,
    aten.equal.default, aten.nonzero.default, aten.masked_select.default,
    aten._unique.default, aten._unique2.default, aten.unique_dim.default,
    aten.unique_consecutive.default, aten.bincount.default,
    # A tensor made from host data: on a card, a copy from host memory.
    aten.lift_fresh.default,
}
T_BS = np.eye(4, dtype=np.float32)
T_BS[2, 3] = 1.0


class CaptureGuard(TorchDispatchMode):
    """Raises on an op that a CUDA graph's capture refuses (see above)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bool_index = func in (aten.index.Tensor, aten.index_put.default,
                              aten.index_put_.default, aten._index_put_impl_.default) and any(
            i is not None and i.dtype == torch.bool for i in args[1]
        )
        unsized = func is aten.repeat_interleave.Tensor and kwargs.get("output_size") is None
        if func in HOST_READS or bool_index or unsized:
            raise AssertionError(f"{func} inside the step: a capture would refuse it")
        return func(*args, **kwargs)


def scan(rng, n=4096, reach=6.0):
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.5, reach, n)
    x, y = rad * np.cos(ang), rad * np.sin(ang)
    z = 0.2 * np.sin(0.7 * x) * np.cos(0.5 * y) - 1.0 + rng.normal(0, 0.02, n)
    return np.stack([x, y, z], -1).astype(np.float32)


def pose(k):
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[1, 3] = 0.23 * k, -0.11 * k
    return T


def config(mode="LOCAL", est="KALMAN", raycast=True, method="polar", range_max=None):
    cfg = ft.Config()
    cfg.mapping.mode = getattr(ft.MappingMode, mode)
    cfg.mapping.estimation_type = getattr(ft.EstimationType, est)
    cfg.raycasting.enabled = raycast
    cfg.raycasting.method = method
    if range_max is not None:
        cfg.point_filter.range_max = range_max
    return cfg


class HostValueGuard(TorchFunctionMode):
    """Raises on a tensor method that hands a value to Python: on a card it
    copies to the host and waits, which a capture refuses. On the CPU some
    of them read the memory without a dispatched op, so ``CaptureGuard``
    cannot see them."""

    METHODS = {torch.Tensor.tolist, torch.Tensor.item, torch.Tensor.numpy,
               torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
               torch.Tensor.__index__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.METHODS:
            raise AssertionError(f"{func.__name__} inside the step: a capture would refuse it")
        return func(*args, **(kwargs or {}))


def guarded(fn, *args):
    """``fn`` once as the warm-up, then once under both guards."""
    fn(*args)
    with CaptureGuard(), HostValueGuard():
        return fn(*args)


STEPS = {
    "local kalman": (10.0, config(), {}),
    "local p2": (10.0, config(est="P2_QUANTILE"), {}),
    "global windowed": (30.0, config("GLOBAL", range_max=6.0), {}),
    "packed": (10.0, config(), {"scatter_mode": "packed"}),
    "twophase": (10.0, config(), {"scatter_mode": "twophase"}),
    "sort": (10.0, config(raycast=False), {"scatter_mode": "sort"}),
    "sampled": (10.0, config(method="sampled"), {}),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_is_capture_safe(rng, name):
    """Each step with a move (LOCAL) or a window (GLOBAL), on a scan with
    masked points and intensity."""
    length, cfg, kw = STEPS[name]
    geom = ft.GridGeometry.from_length(length, length, 0.1)
    step = ft.build_integrate(geom, cfg, has_intensity=True, device="cpu", **kw)
    state = ft.create_map_state(geom, cfg, has_intensity=True, device="cpu")
    mask = torch.ones(4096, dtype=torch.bool)
    mask[-300:] = False
    state, _ = step(state, torch.tensor(scan(rng)), mask, torch.tensor(T_BS),
                    torch.tensor(pose(0)))
    guarded(step, state, torch.tensor(scan(rng)), mask, torch.tensor(T_BS),
            torch.tensor(pose(1)), torch.tensor(rng.random(4096).astype(np.float32)))


@pytest.mark.parametrize("donate", [True, False])
def test_cpu_step_leaves_the_state_passed_in(rng, donate):
    """On the CPU, where nothing is captured, the compiled step runs on a
    copy of the state: the windowed update writes its window into that
    copy, so the state passed in stays as it was, bit for bit, and a
    second call on it gives the same map."""
    length, cfg, _ = STEPS["global windowed"]
    geom = ft.GridGeometry.from_length(length, length, 0.1)
    step = ft.build_integrate(geom, cfg, donate=donate, device="cpu")
    state = ft.create_map_state(geom, cfg, device="cpu")
    args = (torch.tensor(scan(rng)), torch.ones(4096, dtype=torch.bool), torch.tensor(T_BS),
            torch.tensor(pose(1)))
    state, _ = step(state, *args)
    kept = copy.deepcopy(state)
    first, _ = step(state, *args)
    assert_bitwise(state, kept)
    again, _ = step(state, *args)
    assert_bitwise(first, again)
    assert not torch.equal(first.layers["n_points"], kept.layers["n_points"])


def test_block_step_is_capture_safe(rng):
    """The step of one block of a 2x2 map (``spmd_blocks``), its block
    keyword a constant of the signature."""
    from fastdem_tpu_torch.parallel import sharding as sh

    geom = ft.GridGeometry.from_length(32.0, 32.0, 0.25)
    cfg = config("GLOBAL", range_max=5.0)
    mesh = sh.make_mesh(4, shape=(2, 2), devices=["cpu"])
    step = ft.build_integrate(geom, cfg, spmd_blocks=mesh.shape, device="cpu")
    slot = mesh.slots()[-1]
    state = sh.shard_state(ft.create_map_state(geom, cfg, device="cpu"), mesh).block(slot)
    guarded(lambda *a: step(*a, block=slot), state, torch.tensor(scan(rng, reach=4.5)),
            torch.ones(4096, dtype=torch.bool), torch.tensor(T_BS), torch.tensor(pose(1)))


@pytest.mark.parametrize("build", ["microbatch 1", "microbatch 4", "fused"])
def test_replay_steps_are_capture_safe(rng, build):
    geom = ft.GridGeometry.from_length(10.0, 10.0, 0.1)
    cfg = config()
    if build == "fused":
        seq = pl_t.build_integrate_fused(geom, cfg, device="cpu")
    else:
        seq = pl_t.build_integrate_sequence(geom, cfg, microbatch=int(build.split()[1]),
                                            device="cpu")
    K = 4
    xyz = torch.tensor(np.stack([scan(rng, 2048) for _ in range(K)]))
    mask = torch.ones((K, 2048), dtype=torch.bool)
    poses = torch.tensor(np.stack([pose(k) for k in range(K)]))
    state = ft.create_map_state(geom, cfg, device="cpu")
    guarded(seq, state, xyz, mask, torch.tensor(T_BS), poses)


def test_postprocess_chain_is_capture_safe(rng):
    geom = ft.GridGeometry.from_length(6.4, 6.4, 0.1)
    pp = ft.PostProcessConfig()
    pp.uncertainty_fusion.enabled = True
    pp.inpainting.enabled = True
    pp.feature_extraction.enabled = True
    elev = torch.tensor(rng.normal(0.0, 0.2, geom.shape).astype(np.float32))
    elev[torch.tensor(rng.random(geom.shape) < 0.3)] = float("nan")
    out = guarded(apply_postprocess_fn(geom, pp), elev, elev + 0.1, elev - 0.1)
    assert out["elevation"].shape == geom.shape


def test_guard_refuses_a_host_read():
    """The guard itself: ``.item()`` and a boolean mask both raise."""
    x = torch.arange(4.0)
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with CaptureGuard():
            float(x.sum())
    with pytest.raises(AssertionError, match="index"):
        with CaptureGuard():
            x[x > 1.0]


class RecordingGraphs:
    """Test double of ``graphs.CudaGraphs`` on the CPU: ``capture`` runs the
    warm-up, records the body and runs it once for the outputs' tensors;
    ``replay`` runs the body again and copies its results into those
    tensors, as a replay rewrites a graph's outputs in place."""

    def __init__(self):
        self.bodies = []

    @staticmethod
    def applies(device):
        return True

    @staticmethod
    def synchronize(device):
        pass

    @staticmethod
    def new_pool(device):
        return None

    def capture(self, device, warm, body, pool):
        warm()
        outs = body()
        self.bodies.append(body)
        return self.Replay(body, outs), outs, 0

    class Replay:
        def __init__(self, body, outs):
            self.body, self.outs = body, outs

        def replay(self):
            for out, new in zip(self.outs, self.body()):
                if new is not out:
                    out.copy_(new)


@pytest.fixture
def recorded(monkeypatch):
    double = RecordingGraphs()
    monkeypatch.setattr(graphs, "BACKEND", double)
    return double


def session_pair(est):
    cj, ct = fj.Config(), ft.Config()
    for c, pkg in ((cj, fj), (ct, ft)):
        c.raycasting.enabled = False
        c.mapping.mode = pkg.MappingMode.LOCAL
        c.mapping.estimation_type = getattr(pkg.EstimationType, est)
    return (fj.GridGeometry.from_length(8.0, 8.0, 0.1), cj,
            ft.GridGeometry.from_length(8.0, 8.0, 0.1), ct)


def buckets(rng, K):
    """Scans of two capacity buckets, 4,096 and 8,192 points, in turns,
    with the last 100 points of each masked out."""
    out = []
    for k in range(K):
        n = 4096 if k % 2 == 0 else 8192
        mask = np.ones(n, dtype=bool)
        mask[-100:] = False
        out.append((scan(rng, n, reach=3.5), mask, pose(k)))
    return out


def bits(t):
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("est", ["KALMAN", "P2_QUANTILE"])
def test_donated_step_matches_jax_jit(recorded, rng, est):
    gj, cj, gt, ct = session_pair(est)
    step_j = pl_j.build_integrate(gj, cj, donate=True)
    step_t = pl_t.build_integrate(gt, ct, jit=True, donate=True, device="cpu")
    sj = pl_j.create_map_state(gj, cj)
    st = pl_t.create_map_state(gt, ct, device="cpu")
    held = None
    for k, (xyz, mask, T_wb) in enumerate(buckets(rng, 6)):
        sj, aux_j = step_j(sj, jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(T_BS),
                           jnp.asarray(T_wb))
        st, aux_t = step_t(st, torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_BS),
                           torch.tensor(T_wb))
        # Every call, the first of each bucket included, is one step.
        for name in st.layers:
            np.testing.assert_array_equal(bits(sj.layers[name]), bits(st.layers[name]),
                                          err_msg=f"scan {k}, layer {name}")
        np.testing.assert_array_equal(np.asarray(sj.position), st.position.numpy())
        np.testing.assert_array_equal(bits(aux_j.world_xyz), bits(aux_t.world_xyz))
        np.testing.assert_array_equal(np.asarray(aux_j.obs.touched), aux_t.obs.touched.numpy())
        # The returned state is the bucket's slots.
        graph = next(g for g in step_t.graphs.values()
                     if any(s.shape == (len(xyz), 3) for s in g.slots))
        assert all(t is s for t, s in zip(list(st.layers.values()) + [st.position], graph.slots))
        # An aux held from the previous call did not change.
        if held is not None:
            aux_prev, copy = held
            np.testing.assert_array_equal(aux_prev.world_xyz.numpy(), copy[0])
            np.testing.assert_array_equal(aux_prev.obs.min_z.numpy(), copy[1])
        held = (aux_t, (aux_t.world_xyz.numpy().copy(), aux_t.obs.min_z.numpy().copy()))
    assert len(step_t.graphs) == 2 and len(recorded.bodies) == 2
    assert [g.stats.replays for g in step_t.graphs.values()] == [3, 3]


def test_without_donation_state_is_fresh(recorded, rng):
    geom = ft.GridGeometry.from_length(8.0, 8.0, 0.1)
    cfg = config()
    eager = pl_t.build_integrate(geom, cfg, jit=False, device="cpu")
    step = pl_t.build_integrate(geom, cfg, donate=False, device="cpu")
    s_e = s_g = pl_t.create_map_state(geom, cfg, device="cpu")
    for xyz, mask, T_wb in buckets(rng, 3):
        args = (torch.tensor(xyz), torch.tensor(mask), torch.tensor(T_BS), torch.tensor(T_wb))
        before = {k: v.clone() for k, v in s_g.layers.items()}
        prev = s_g
        s_e, _ = eager(s_e, *args)
        s_g, _ = step(s_g, *args)
        assert_bitwise(s_g, s_e)
        # The state passed in is not touched, and the new one is no slot.
        assert_bitwise(prev, ft.GridMapState(layers=before, position=prev.position))
        slots = {s.data_ptr() for g in step.graphs.values() for s in g.slots}
        assert not slots & {t.data_ptr() for t in s_g.layers.values()}


def test_cache_keys(recorded, rng):
    """One graph per scan capacity, channel set and extrinsic rank; a
    signature seen before replays."""
    geom = ft.GridGeometry.from_length(8.0, 8.0, 0.1)
    cfg = config()
    step = pl_t.build_integrate(geom, cfg, has_intensity=True, device="cpu")
    state = pl_t.create_map_state(geom, cfg, has_intensity=True, device="cpu")
    T = torch.tensor(T_BS)
    for n, channel in ((4096, False), (4096, False), (8192, False), (4096, True),
                       (8192, False), (4096, True)):
        xyz = torch.tensor(scan(rng, n))
        inten = torch.rand(n) if channel else None
        state, _ = step(state, xyz, torch.ones(n, dtype=torch.bool), T, T, inten)
    assert len(step.graphs) == 3
    assert sorted(g.stats.replays for g in step.graphs.values()) == [2, 2, 2]

    seq = pl_t.build_integrate_sequence(geom, cfg, device="cpu")
    state = pl_t.create_map_state(geom, cfg, device="cpu")
    xyz = torch.tensor(np.stack([scan(rng, 2048) for _ in range(2)]))
    mask = torch.ones((2, 2048), dtype=torch.bool)
    poses = torch.tensor(np.stack([pose(0), pose(1)]))
    for tbs in (T, T.expand(2, 4, 4).clone(), T):
        state = seq(state, xyz, mask, tbs, poses)
    assert len(seq.graphs) == 2


@pytest.mark.parametrize("warm", [True, False])
def test_warm_up_runs_unless_the_caller_ran_the_step(recorded, warm):
    """``jit(fn, warm=False)`` captures without the warm-up run: the first
    call runs ``fn`` for the capture and the replay only, and gives the
    same step as with the warm-up."""
    calls = []

    def fn(x):
        calls.append(True)
        return x * 2.0 + 1.0, x.sum()

    step = graphs.jit(fn, warm=warm)
    x = torch.arange(6, dtype=torch.float32)
    x, total = step(x)
    assert len(calls) == (3 if warm else 2)
    x, total = step(x)
    assert len(calls) == (4 if warm else 3)
    assert x.tolist() == [3.0, 7.0, 11.0, 15.0, 19.0, 23.0] and float(total) == 36.0


def test_step_frees_its_inputs_and_outputs_without_the_collector(recorded):
    """With the cyclic collector off, a step's input tensors and its
    returned outputs are freed as soon as the caller drops them: neither
    the signature's walk nor the outputs' assembly leaves a reference
    cycle behind, at the capture and at a replay."""
    step = graphs.jit(lambda s, x: (s + x, {"twice": x * 2.0}))
    state = torch.zeros(4)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(3):
            x = torch.ones(4)
            state, out = step(state, x)
            refs = [weakref.ref(x), weakref.ref(out["twice"])]
            del x, out
            assert [r() for r in refs] == [None, None]
    finally:
        if was_enabled:
            gc.enable()
    assert state.tolist() == [3.0] * 4 and len(step.graphs) == 1


def test_facade_keeps_held_state_and_rebuild_drops_graphs(recorded, rng):
    """The facade's step donates its map, yet a held state and a held aux
    stay as they were; a setter's rebuild drops the graphs."""
    geom = ft.GridGeometry.from_length(8.0, 8.0, 0.1)
    m = ft.FastDEM(geom, config(), device="cpu")
    ref = ft.FastDEM(geom, config(), device="cpu")
    ref._map.step = pl_t.build_integrate(geom, ref.cfg, jit=False, device="cpu")
    for k, (xyz, _, T_wb) in enumerate(buckets(rng, 4)):
        held, aux = m.state, m.last_aux
        copies = ({n: v.clone() for n, v in held.layers.items()},
                  None if aux is None else aux.obs.min_z.clone())
        for mapper in (m, ref):
            assert mapper.integrate(ft.cloud.from_numpy(xyz, device="cpu"), T_BS, T_wb)
        assert_bitwise(held, ft.GridMapState(layers=copies[0], position=held.position))
        if aux is not None:
            np.testing.assert_array_equal(aux.obs.min_z.numpy(), copies[1].numpy())
    assert_bitwise(m.state, ref.state)
    old = m._map.step
    assert len(old.graphs) == 2
    m.set_height_filter(-5.0, 5.0)
    assert not old.graphs and not m._map.step.graphs and m._map.step is not old


class EagerFacade(ft.FastDEM):
    """The facade over the eager step (``build_integrate(jit=False)``)."""

    def _build_step(self):
        return pl_t.build_integrate(self.geom, self.cfg, self.has_intensity, self.has_color,
                                    window_margin=self._window_margin, jit=False,
                                    device=self.device)


@pytest.mark.parametrize("mode", ["LOCAL", "GLOBAL"])
def test_donating_facade_equals_eager_loop(recorded, rng, mode):
    """The facade's donating step against the eager step's facade, bit for
    bit after every scan, over two capacities (two graphs), a ``state``
    set mid-run, ``reset()``, a rebuild and a margin widening: a state
    held from ``state`` never changes, a value set to ``state`` is never
    written (neither by scans nor by ``reset()``), and the counters read
    one copy-in per graph's first call, per switch of graph and per set
    or rebuild, every other call in place."""
    from fastdem_tpu_torch.utils import tracing

    if mode == "LOCAL":
        geom, cfg = ft.GridGeometry.from_length(8.0, 8.0, 0.1), config()
    else:
        geom = ft.GridGeometry.from_length(30.0, 30.0, 0.1)
        cfg = config("GLOBAL", raycast=False, range_max=6.0)
    m = ft.FastDEM(geom, cfg, device="cpu")
    ref = EagerFacade(geom, copy.deepcopy(cfg), device="cpu")
    wide = T_BS.copy()
    wide[0, 3] = 1.8  # past the 2 m window margin: the facade widens it and rebuilds
    before = tracing.counters()
    k = 0

    def scans(*sizes, T_bs=T_BS):
        nonlocal k
        for n in sizes:
            xyz = scan(rng, n, reach=3.5)
            for mapper in (m, ref):
                assert mapper.integrate(ft.cloud.from_numpy(xyz, device="cpu"), T_bs, pose(k))
            k += 1
            assert_bitwise(m.live_state(), ref.live_state())

    def counted():
        now = tracing.counters()
        return tuple(now.get(c, 0) - before.get(c, 0)
                     for c in ("step.state_in_place", "step.state_copied_in"))

    scans(1000, 1000, 3000, 1000)
    assert len(m._map.step.graphs) == 2 and counted() == (1, 3)
    held = m.state
    kept = copy.deepcopy(held)
    scans(1000, 1000, 1000)
    assert_bitwise(held, kept)
    assert counted() == (4, 3)

    # A value set to ``state`` is copied into the slots by the next scan.
    for mapper in (m, ref):
        mapper.state = copy.deepcopy(held)
    scans(1000)
    assert_bitwise(held, kept)
    assert counted() == (4, 4)

    live = m.live_state()
    for mapper in (m, ref):
        mapper.reset()
    assert m.live_state() is live and all(torch.isnan(v).all() for v in live.layers.values())
    scans(1000, 3000, 3000)
    assert counted() == (6, 5)

    for mapper in (m, ref):
        mapper.set_height_filter(-5.0, 5.0)
    scans(3000, 3000)
    assert counted() == (7, 6)
    scans(3000, 3000, T_bs=wide)
    assert m._window_margin == ref._window_margin == pytest.approx(2.8)
    assert counted() == (8, 7)

    # ``reset()`` of a value set to ``state`` clears new tensors.
    m.state = held
    m.reset()
    assert_bitwise(held, kept)
    assert torch.isnan(m.live_state().layers["elevation"]).all()


def near_ties(xyz, dz=7e-7):
    """Each point of the first half of a scan preceded by a copy 5 mm
    further out and ``dz`` higher. At the scans' z range of about 0.55 m,
    0.7 um is more than one z quantum of the rasterizer's argmin key with
    an 11-bit point index and less than one with 12 bits, where the pair
    may tie and the copy (another range, so another variance) wins."""
    half = xyz[: len(xyz) // 2]
    r = np.hypot(half[:, 0], half[:, 1])[:, None]
    copy = half + np.concatenate([0.005 * half[:, :2] / r, np.full((len(half), 1), dz)], 1)
    return np.stack([copy, half], 1).reshape(-1, 3).astype(np.float32)


def test_facade_pads_scans_to_powers_of_two(recorded, rng):
    """Scans of five sizes through the facade: one graph per power of two
    (1,024 / 2,048 / 4,096), not per size, and the map and the aux equal
    JAX's facade on the unpadded scans bit for bit, near-ties in z
    included: the padding keeps the argmin key's index width (a pad to
    4,096 would widen it for the small scans)."""
    sizes = (1000, 1900, 1500, 3000, 2500)
    gj, cj, gt, ct = session_pair("KALMAN")
    m_j = fj.FastDEM(gj, cj)
    m_t = ft.FastDEM(gt, ct, device="cpu")
    for k, n in enumerate(sizes):
        xyz = near_ties(scan(rng, n, reach=3.5))
        assert m_j.integrate(fj.cloud.from_numpy(xyz), T_BS, pose(k))
        assert m_t.integrate(ft.cloud.from_numpy(xyz, device="cpu"), T_BS, pose(k))
        for name in m_t.state.layers:
            np.testing.assert_array_equal(bits(m_j.state.layers[name]),
                                          bits(m_t.state.layers[name]),
                                          err_msg=f"scan {k}, layer {name}")
        for f in ("world_xyz", "world_mask", "z_var"):
            got, want = getattr(m_t.last_aux, f).numpy(), np.asarray(getattr(m_j.last_aux, f))
            assert got.shape == want.shape == (n,) + want.shape[1:], f
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=f)
    assert sorted(s.shape[0] for g in m_t._map.step.graphs.values() for s in g.slots
                  if s.dim() == 2 and s.shape[1] == 3) == [1024, 2048, 4096]
    assert sorted(g.stats.replays for g in m_t._map.step.graphs.values()) == [1, 2, 2]


def test_facade_graphs_stay_within_the_rungs(recorded, rng):
    """A session of forty distinct scan sizes holds at most one graph per
    power of two they span."""
    geom = ft.GridGeometry.from_length(6.0, 6.0, 0.2)
    m = ft.FastDEM(geom, config(raycast=False), device="cpu")
    sizes = rng.integers(300, 5000, 40)
    assert len(set(sizes.tolist())) == 40
    for k, n in enumerate(sizes):
        assert m.integrate(ft.cloud.from_numpy(scan(rng, int(n), reach=2.5), device="cpu"),
                           T_BS, pose(k % 4))
    rungs = {1 << int(n - 1).bit_length() for n in sizes}
    assert len(m._map.step.graphs) == len(rungs) <= 5


def test_cpu_chain_runs_outside_the_lock(rng):
    """On the CPU, where nothing is captured, the node's chain runs without
    holding the driver's lock, so the intake is not held off meanwhile."""
    import threading

    geom = ft.GridGeometry.from_length(6.4, 6.4, 0.1)
    d = MappingDriver(geom, config(), postprocess_rate=0.0, viz_rate=0.0, device="cpu")
    try:
        fn = d.postprocess_fn(True, True, True)
        free = []

        def probe(*layers):
            def take():
                with d._lock:
                    free.append(True)

            t = threading.Thread(target=take, daemon=True)
            t.start()
            t.join(timeout=5.0)
            return fn(*layers)

        d._pp_cache[(True, True, True)] = probe
        d.run_postprocess()
        assert free == [True]
    finally:
        d.close()


def test_driver_chain_is_compiled(recorded, rng):
    """The node's chain is captured per map shape and switches; its
    result equals the plain chain on the snapshot."""
    geom = ft.GridGeometry.from_length(6.4, 6.4, 0.1)
    d = MappingDriver(geom, config(), postprocess_rate=0.0, viz_rate=0.0, device="cpu")
    try:
        assert d.on_scan(ft.cloud.from_numpy(scan(rng, 4096, reach=3.0), device="cpu"),
                         T_BS, pose(0))
        snap = d.snapshot()
        got = d.run_postprocess()
        again = d.run_postprocess()
        fn = d.postprocess_fn(True, True, True)
        assert isinstance(fn, graphs.CompiledStep) and len(fn.graphs) == 1
        assert fn.stats()[0].replays == 2
        ref = fn.fn(*(snap.layers[k] for k in ("elevation", "upper_bound", "lower_bound")))
        assert len(ref) > 4
        for k, v in ref.items():
            np.testing.assert_array_equal(bits(got[k]), bits(v.numpy()), err_msg=k)
            np.testing.assert_array_equal(bits(again[k]), bits(v.numpy()), err_msg=k)
    finally:
        d.close()


@pytest.mark.parametrize("name", ["build_integrate", "build_integrate_sequence",
                                  "build_integrate_fused"])
def test_builders_take_jit_and_donate_as_jax(name):
    for pkg in (pl_j, pl_t):
        params = inspect.signature(getattr(pkg, name)).parameters
        assert params["jit"].default is True and params["donate"].default is True, pkg
