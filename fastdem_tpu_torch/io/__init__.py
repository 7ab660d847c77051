"""IO (port of ``fastdem_tpu/io``): npz checkpoints, PNG export, PCD / KITTI
/ trajectory files, the HTML viewer and the live viewer. Host-side numpy;
a map is read from its device once per call (``interop.host_state``)."""

from fastdem_tpu_torch.io.npz import load_npz, save_npz  # noqa: F401
from fastdem_tpu_torch.io.png import PngExportConfig, save_png  # noqa: F401
