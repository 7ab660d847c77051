"""Streaming mapping driver: the ROS-node equivalent without ROS (port of
``fastdem_tpu/runtime/driver.py``).

The reference node's behaviour:
  * scan intake -> integrate under a writer lock;
  * periodic local-map / global-submap publishing through pluggable sinks
    (topics become callbacks and npz / HTML artifacts);
  * periodic post-processing on a SNAPSHOT of {elevation, upper, lower}.
    The reference package's arrays are immutable, so its snapshot is a dict
    subset; torch tensors are not, so this one clones the three layers
    under the lock, and a later in-place map update cannot tear it;
  * trigger services -> methods: reset / run_postprocess / run_inpainting /
    run_uncertainty_fusion / run_feature_extraction;
  * a startup banner.

Threading is the reference's three lanes: the caller's scan thread (or the
async intake worker), a visualization timer and a post-processing timer,
serialized around the FastDEM facade with an RLock (the facade is not
thread-safe). All device work runs on the current stream. On a CUDA
device the constructor builds and loads the kernels, so no intake or timer
thread ever runs nvcc.
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from types import SimpleNamespace
from typing import Callable, Deque, Dict, Optional

import numpy as np

from fastdem_tpu_torch.cloud.pointcloud import stage
from fastdem_tpu_torch.config import Config, PostProcessConfig
from fastdem_tpu_torch.device import resolve_device
from fastdem_tpu_torch.grid import gridmap as gm
from fastdem_tpu_torch.grid.geometry import GridGeometry
from fastdem_tpu_torch.grid.gridmap import GridMapState, layers
from fastdem_tpu_torch.interop import host_state, to_host
from fastdem_tpu_torch.mapping.pipeline import FastDEM
from fastdem_tpu_torch.postprocess import apply_postprocess_fn

log = logging.getLogger("fastdem_tpu_torch.runtime")

# Layers of the post-processing snapshot.
SNAPSHOT_LAYERS = (layers.elevation, layers.upper_bound, layers.lower_bound)


def build_kernels() -> None:
    """Build (one nvcc per source, in parallel) and load K1 and K4."""
    from fastdem_tpu_torch.ops import cuda_build
    from fastdem_tpu_torch.ops import polar_field as k1
    from fastdem_tpu_torch.ops import resample as k4

    cuda_build.build(k1.SOURCE, k4.SOURCE)
    k1.library()
    k4.library()


class _HandoffLock:
    """The driver's reentrant lock, which a burst hands to waiting readers
    between its scans. A plain lock is not fair: the intake thread would
    take it back at once after each scan, and a timer tick waiting for it
    would wait for the whole burst."""

    def __init__(self):
        self._lock = threading.RLock()
        self._cond = threading.Condition(threading.Lock())
        self.waiting = 0

    def __enter__(self):
        with self._cond:
            self.waiting += 1
            self._cond.notify_all()
        self._lock.acquire()
        with self._cond:
            self.waiting -= 1
            self._cond.notify_all()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def let_waiters_in(self, timeout: float = 1.0) -> None:
        """Called without the lock held: wait until the threads waiting for
        the lock have taken it."""
        with self._cond:
            self._cond.wait_for(lambda: self.waiting == 0, timeout)


class MappingDriver:
    """Online mapping session driver on ``device``."""

    def __init__(
        self,
        geom: GridGeometry,
        cfg: Optional[Config] = None,
        postprocess_cfg: Optional[PostProcessConfig] = None,
        calibration=None,
        odometry=None,
        postprocess_rate: float = 1.0,
        viz_rate: float = 2.0,
        global_rate: float = 0.0,
        global_window: tuple = (15.0, 15.0),
        artifact_dir: Optional[str] = None,
        async_intake: bool = False,
        burst_batch: int = 8,
        max_queue: int = 64,
        stage_ahead: bool = True,
        *,
        device="cuda",
        **mapper_kwargs,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            build_kernels()
        self.geom = geom
        self.mapper = FastDEM(geom, cfg, device=self.device, **mapper_kwargs)
        if calibration is not None:
            self.mapper.set_calibration_provider(calibration)
        if odometry is not None:
            self.mapper.set_odometry_provider(odometry)
        self.pp_cfg = postprocess_cfg or PostProcessConfig()
        self.postprocess_rate = postprocess_rate
        self.viz_rate = viz_rate
        self.global_rate = global_rate
        self.global_window = global_window
        self.artifact_dir = artifact_dir

        self._lock = _HandoffLock()
        self._timers: list[threading.Thread] = []
        self._stop = threading.Event()
        self._scan_count = 0
        self._started = False

        # Pluggable sinks (the 'topics'): name -> callback(payload).
        self.sinks: Dict[str, Callable[[dict], None]] = {}
        self.postprocess_result: Optional[Dict[str, np.ndarray]] = None
        # Post-processing functions per (uf, inpaint, features).
        self._pp_cache: Dict[tuple, Callable] = {}
        # Host ms of the last ticks of each timer ("postprocess", "viz",
        # "global"), measured around the tick's work.
        self.tick_ms: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=1000)
        )

        # Async intake: scans enqueue and a worker drains them, integrating
        # up to burst_batch queued scans per burst (the lock per scan). Under
        # overload the OLDEST scans drop, like the reference node's
        # keep-last subscription.
        self.async_intake = async_intake
        self.burst_batch = max(1, burst_batch)
        self.max_queue = max(1, max_queue)
        # While a burst integrates, the next queued scans' host-to-device
        # copies are started (pointcloud.stage).
        self.stage_ahead = stage_ahead
        self.dropped_scans = 0
        # Bursts whose integration raised (logged; the worker goes on).
        self.intake_errors = 0
        self._queue: list = []
        self._inflight = 0
        self._qcond = threading.Condition()
        self._intake_thread: Optional[threading.Thread] = None
        if async_intake:
            self._intake_thread = threading.Thread(target=self._intake_loop, daemon=True)
            self._intake_thread.start()

        self._banner()

    @property
    def scan_count(self) -> int:
        """Scans integrated since construction or the last reset."""
        return self._scan_count

    # -- intake ------------------------------------------------------------
    def on_scan(self, cloud, T_base_sensor=None, T_world_base=None) -> bool:
        """Scan callback.

        Synchronous mode (default): integrate inline and report the result.
        With ``async_intake`` the scan is enqueued (True = accepted) and a
        worker integrates it; backlogs integrate in bursts and the oldest
        queued scans drop under overload (``dropped_scans``).
        """
        if self.async_intake:
            with self._qcond:
                if self._stop.is_set():
                    return False
                self._queue.append((cloud, T_base_sensor, T_world_base))
                while len(self._queue) > self.max_queue:
                    self._queue.pop(0)
                    self.dropped_scans += 1
                self._qcond.notify()
            return True
        return self._integrate_burst([(cloud, T_base_sensor, T_world_base)]) == 1

    def _count(self, n: int) -> None:
        self._scan_count += n
        if not self._started:
            self._started = True
            self._start_timers()

    def _intake_loop(self):
        while True:
            with self._qcond:
                while not self._queue and not self._stop.is_set():
                    self._qcond.wait(0.1)
                if self._stop.is_set() and not self._queue:
                    return
                items = self._queue[: self.burst_batch]
                del self._queue[: len(items)]
                self._inflight = len(items)
                to_stage = list(self._queue[: self.burst_batch]) if self.stage_ahead else []
            if to_stage:
                # Start the next burst's copies while this one computes.
                # Entries are re-matched by identity under a short
                # re-acquire, so drops that happened meanwhile stay intact.
                staged = []
                for c, tbs, twb in to_stage:
                    try:
                        staged.append(((c, tbs, twb), (stage(c, self.device), tbs, twb)))
                    except Exception:  # noqa: BLE001
                        break
                if staged:
                    with self._qcond:
                        for orig, new in staged:
                            for i, cur in enumerate(self._queue):
                                if cur is orig or cur[0] is orig[0]:
                                    self._queue[i] = new
                                    break
            try:
                self._integrate_burst(items)
            except Exception:  # noqa: BLE001 - intake must not die
                self.intake_errors += 1
                log.exception("driver intake error")
            finally:
                with self._qcond:
                    self._inflight = 0
                    self._qcond.notify_all()

    def _integrate_burst(self, items) -> int:
        """Integrate scans one after the other, as
        ``FastDEM.integrate_sequence`` does (explicit and provider-posed
        scans may mix); the number integrated. The lock is taken per scan
        and handed to the threads waiting for it between scans, so a timer
        tick sees the map between two scans of a burst, as it does under
        sync intake."""
        n = 0
        for c, tbs, twb in items:
            self._lock.let_waiters_in()
            with self._lock:
                if self.mapper.integrate(c, tbs, twb):
                    n += 1
                    self._count(1)
        return n

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the async intake queue is empty and no burst is in
        flight."""
        deadline = time.time() + timeout
        with self._qcond:
            while self._queue or self._inflight:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._qcond.wait(min(remaining, 0.1))
        return True

    # -- timers ------------------------------------------------------------
    def _start_timers(self):
        """Timers start on the first integrated scan."""
        if self.postprocess_rate > 0:
            self._spawn("postprocess", self._pp_loop, 1.0 / self.postprocess_rate)
        if self.viz_rate > 0:
            self._spawn("viz", self._viz_loop, 1.0 / self.viz_rate)
        if self.global_rate > 0:
            self._spawn("global", self._global_loop, 1.0 / self.global_rate)

    def _spawn(self, name, fn, period):
        t = threading.Thread(target=self._loop, args=(name, fn, period), daemon=True)
        t.start()
        self._timers.append(t)

    def _loop(self, name, fn, period):
        while not self._stop.wait(period):
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # noqa: BLE001 - timers must not die
                log.exception("driver timer error")
            self.tick_ms[name].append((time.perf_counter() - t0) * 1000.0)

    def close(self):
        if self.async_intake and not self.drain(timeout=120.0):
            log.warning(
                "intake queue did not drain before close; %d scans dropped",
                len(self._queue),
            )
        self._stop.set()
        with self._qcond:
            self._qcond.notify_all()
        if self._intake_thread is not None:
            self._intake_thread.join(timeout=5.0)
        for t in self._timers:
            t.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- services ----------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self.mapper.reset()
            self._scan_count = 0

    def snapshot(self) -> GridMapState:
        """A copy of {elevation, upper_bound, lower_bound}, taken under the
        lock: its tensors are clones, which later map updates cannot
        touch."""
        with self._lock:
            state = self.mapper.state
            return GridMapState(
                layers={k: state.layers[k].clone() for k in SNAPSHOT_LAYERS
                        if k in state.layers},
                position=state.position.clone(),
            )

    def postprocess_fn(self, uf: bool = True, inpaint: bool = True, features: bool = True):
        """The post-processing chain with the three stages switched as
        given and the other parameters of ``pp_cfg``."""
        key = (uf, inpaint, features)
        fn = self._pp_cache.get(key)
        if fn is None:
            cfg = copy.deepcopy(self.pp_cfg)
            cfg.inpainting.enabled = inpaint
            cfg.uncertainty_fusion.enabled = uf
            cfg.feature_extraction.enabled = features
            fn = apply_postprocess_fn(self.geom, cfg)
            self._pp_cache[key] = fn
        return fn

    def run_postprocess(
        self, uf: bool = True, inpaint: bool = True, features: bool = True
    ) -> Dict[str, np.ndarray]:
        """Snapshot -> UF -> inpaint -> FE -> derived uncertainty_range, on
        the map's device; the result as host numpy arrays."""
        snap = self.snapshot()
        out = self.postprocess_fn(uf, inpaint, features)(
            *(snap.layers[k] for k in SNAPSHOT_LAYERS)
        )
        result = to_host(out)
        self.postprocess_result = result
        self._publish("postprocess", result)
        return result

    def run_inpainting(self):
        return self.run_postprocess(uf=False, inpaint=True, features=False)

    def run_uncertainty_fusion(self):
        return self.run_postprocess(uf=True, inpaint=False, features=False)

    def run_feature_extraction(self):
        return self.run_postprocess(uf=False, inpaint=False, features=True)

    # -- publishing --------------------------------------------------------
    def _pp_loop(self):
        if self._scan_count == 0:
            return
        self.run_postprocess(
            uf=self.pp_cfg.uncertainty_fusion.enabled,
            inpaint=self.pp_cfg.inpainting.enabled,
            features=self.pp_cfg.feature_extraction.enabled,
        )

    def _viz_loop(self):
        if self._scan_count == 0:
            return
        # One host read under the lock, so the payload is consistent with
        # concurrent integrates: every non-internal layer (every layer when
        # the npz artifact is written), the position and the last scan's
        # surviving points.
        with self._lock:
            state = self.mapper.state
            names = [k for k in state.layers
                     if self.artifact_dir or not gm.is_internal(k)]
            arrays = {("layer", k): state.layers[k] for k in names}
            arrays["position"] = state.position
            aux = self.mapper.last_aux
            if aux is not None:
                arrays["scan_xyz"] = aux.world_xyz
                arrays["scan_mask"] = aux.world_mask
            host = to_host(arrays)
            scan_count = self._scan_count
        host_map = SimpleNamespace(
            layers={k: host[("layer", k)] for k in names}, position=host["position"]
        )
        payload = {
            "position": host["position"],
            "scan_count": scan_count,
            "layers": {k: v for k, v in host_map.layers.items() if not gm.is_internal(k)},
        }
        if aux is not None:
            pts = host["scan_xyz"][host["scan_mask"]]
            if pts.shape[0] > 20_000:
                pts = pts[:: pts.shape[0] // 20_000 + 1]
            payload["scan_xyz"] = pts
        self._publish("map", payload)
        # Wire-format topics only when a sink subscribes.
        if "pointcloud2" in self.sinks:
            from fastdem_tpu_torch.runtime import wire

            self._publish("pointcloud2", wire.map_to_pointcloud2(
                self.geom, host_map, frame_id=self.mapper.frame_id))
        if "gridmap_msg" in self.sinks:
            from fastdem_tpu_torch.runtime import wire

            self._publish("gridmap_msg", wire.map_to_gridmap_msg(
                self.geom, host_map, frame_id=self.mapper.frame_id))
        if self.artifact_dir:
            from fastdem_tpu_torch.io.html_viewer import save_html
            from fastdem_tpu_torch.io.npz import save_npz

            save_npz(f"{self.artifact_dir}/map_latest.npz", self.geom, host_map,
                     frame_id=self.mapper.frame_id)
            save_html(f"{self.artifact_dir}/map_latest.html", self.geom, host_map)

    def _publish(self, topic: str, payload):
        sink = self.sinks.get(topic)
        if sink is not None:
            try:
                sink(payload)
            except Exception:  # noqa: BLE001
                log.exception("sink '%s' failed", topic)

    def _global_loop(self):
        """Global-submap publishing around the robot."""
        if self._scan_count == 0:
            return
        with self._lock:
            center = host_state(self.mapper.state, [])[1]
        payload = self.submap(tuple(center), self.global_window)
        payload["center"] = center
        self._publish("global_submap", payload)

    def submap(self, center_xy, length_xy) -> Dict[str, np.ndarray]:
        """The non-internal layers on the submap of extent ``length_xy``
        around ``center_xy``, as host arrays."""
        with self._lock:
            state = self.mapper.state
            position = host_state(state, [])[1]
            rs, cs = gm.submap_slices(self.geom, position, center_xy, length_xy)
            return to_host({k: v[rs, cs] for k, v in state.layers.items()
                            if not gm.is_internal(k)})

    def _banner(self):
        cfg = self.mapper.cfg
        log.info(
            "FastDEM driver on %s: map %dx%d @ %.2fm | mode=%s estimator=%s "
            "sensor=%s raycast=%s | pp %.1f Hz viz %.1f Hz",
            self.device,
            self.geom.rows,
            self.geom.cols,
            self.geom.resolution,
            cfg.mapping.mode.value,
            cfg.mapping.estimation_type.value,
            cfg.sensor_model.type.value,
            cfg.raycasting.enabled,
            self.postprocess_rate,
            self.viz_rate,
        )
