"""Time one-frame launches of K1 and K4 against the same kernels built from
another checkout's sources, in one process on one card.

    python -m fastdem_tpu_torch.tools.kernel_ab OTHER_CSRC [--turns 5] [--reps 100]

``OTHER_CSRC`` holds the other ``polar_field.cu`` and ``resample.cu`` with
the one-frame C interface (the kernels before their launch grid took a
frame index). The two builds' outputs are compared bit for bit, then each
turn times other, this, this, other: device time per launch under
torch.profiler, at the flagship shapes (K1 on a [515, 2048] field, K4
over the 150 x 150 map). Prints one line per kernel and build with the
median and every turn's time, and the card's name and power limit.
"""

import argparse
import ctypes
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

import fastdem_tpu_torch as fd
from fastdem_tpu_torch.ops import cuda_build
from fastdem_tpu_torch.ops import polar_field as k1
from fastdem_tpu_torch.ops import resample as k4
from fastdem_tpu_torch.postprocess import raycasting as raycast
from fastdem_tpu_torch.utils import profiling
from fastdem_tpu_torch.utils.profiling import platform_info


def device_ms(fn, reps: int) -> float:
    """Device time per call of the kernels ``fn`` launches."""
    return profiling.device_profile(fn, reps, attempts=3)[0]


def load_other(csrc: Path, build_dir: Path):
    """The other checkout's K1 and K4 libraries, with their one-frame C
    interfaces. Their sources are copied under other names, so that their
    libraries never share a name with this checkout's."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = []
    for name in ("polar_field", "resample"):
        src = build_dir / f"other_{name}.cu"
        shutil.copyfile(csrc / f"{name}.cu", src)
        libs.append(cuda_build.load(src))
    p1, p4 = libs
    p1.fastdem_polar_field.argtypes = [vp, vp, vp, vp, cf, ci, ci, ci, ci, vp, vp]
    p1.fastdem_polar_field.restype = ci
    p4.fastdem_resample_lookup.argtypes = [vp, vp, vp, ci, ci, vp, vp,
                                           ctypes.POINTER(k4._LookupParams), vp, vp, vp]
    p4.fastdem_resample_lookup.restype = ci
    return p1, p4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        p1, p4 = load_other(args.other_csrc.resolve(), Path(tmp))
        rng = np.random.default_rng(3)
        geom = fd.GridGeometry.from_length(15.0, 15.0, 0.1)
        A, R, dr = raycast.polar_dims(geom, 2048, 0.25, 12.81)
        win = raycast.column_windows(geom, 2048, 0.25, 12.81, dev)
        lk = raycast.polar_lookup(geom, 2048, 0.25, 12.81)
        tbl = rng.uniform(-2.0, 0.5, (R, A)).astype(np.float32)
        tbl[rng.random(tbl.shape) < 0.97] = np.inf
        scat = torch.tensor(tbl, device=dev)
        so = torch.tensor([0.07, -0.03, 1.2], device=dev)
        pos = torch.tensor([0.2, -0.1], device=dev)
        field = torch.empty_like(scat)
        ray_min = torch.empty(geom.shape, device=dev)
        touched = torch.empty(geom.shape, dtype=torch.bool, device=dev)
        params = lk.params(geom.rows, geom.cols, False)

        def other_k1():
            st = torch.cuda.current_stream().cuda_stream
            err = p1.fastdem_polar_field(scat.data_ptr(), win.lvl.data_ptr(),
                                         win.shift.data_ptr(), so[2:3].data_ptr(), dr, R, A,
                                         4, 1, field.data_ptr(), st)
            if err:
                raise RuntimeError(f"the other K1 failed: cudaError {err}")

        def other_k4():
            st = torch.cuda.current_stream().cuda_stream
            err = p4.fastdem_resample_lookup(field.data_ptr(), pos.data_ptr(), so.data_ptr(),
                                             1, 1, None, None, ctypes.byref(params),
                                             ray_min.data_ptr(), touched.data_ptr(), st)
            if err:
                raise RuntimeError(f"the other K4 failed: cudaError {err}")

        def this_k1():
            return k1.polar_field_cuda(scat, win, so, dr, 4, True)

        def this_k4():
            return k4.resample_lookup_cuda(field, lk, pos, so)

        other_k1()
        same1 = torch.equal(field.view(torch.int32), this_k1().view(torch.int32))
        other_k4()
        h, t = this_k4()
        torch.cuda.synchronize()
        same4 = torch.equal(ray_min.view(torch.int32), h.view(torch.int32)) and torch.equal(
            touched, t)
        info = platform_info()
        print(f"card, power limit (nvidia-smi): {info.get('nvidia_smi', info['device'])}")
        print(f"K1 other == this bitwise {same1}; K4 other == this bitwise {same4}")
        if not (same1 and same4):
            raise SystemExit("the two builds differ")
        times = {k: [] for k in ("K1 other", "K1 this", "K4 other", "K4 this")}
        for _ in range(args.turns):
            for build in ("other", "this", "this", "other"):
                for kern, fns in (("K1", (other_k1, this_k1)), ("K4", (other_k4, this_k4))):
                    fn = fns[0] if build == "other" else fns[1]
                    times[f"{kern} {build}"].append(device_ms(fn, args.reps))
        for k, v in times.items():
            print(f"{k}: median {float(np.median(v))!r} ms per launch, turns {v!r}")


if __name__ == "__main__":
    main()
