"""Settings: camera intrinsics + extractor knobs, loadable from TUM*.yaml.

The reference reads these with OpenCV FileStorage in the Tracking ctor
(src/Tracking.cc ~55-140). We keep the exact key names
(`Camera.fx`, `ORBextractor.nFeatures`, ...) so the reference's
Examples/RGB-D/TUM{1,2,3}.yaml files are drop-in (SURVEY.md §8).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from plslam_tpu_torch import constants as C


@dataclasses.dataclass(frozen=True)
class Settings:
    # Camera.* (Examples/RGB-D/TUM1.yaml)
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    bf: float = 40.0  # baseline * fx (virtual stereo)
    rgb: int = 1  # 1: RGB order, 0: BGR
    width: int = 640
    height: int = 480
    # depth handling
    th_depth: float = C.TH_DEPTH_DEFAULT
    depth_map_factor: float = 5000.0
    # ORBextractor.*
    n_features: int = C.N_FEATURES
    scale_factor: float = C.SCALE_FACTOR
    n_levels: int = C.N_LEVELS
    ini_th_fast: int = C.INI_TH_FAST
    min_th_fast: int = C.MIN_TH_FAST
    # line features on/off (the PL fork always extracts lines; configs 1 runs
    # point-only per BASELINE.json config 1)
    use_lines: bool = True
    # line detection backend: "device" fuses LSD into the jitted frame
    # builder (ops/lsd_device.py — TPU-native, zero host cost); "host" uses
    # the C++/cv2 detector (ops/lsd.py — the oracle, and the reference's
    # architecture: LSDDetector on a CPU thread)
    line_backend: str = "device"
    # loop closing on/off (config 1/2/3 vs 4)
    use_loop_closing: bool = True

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def depth_th(self) -> float:
        """Close/far split in meters: ThDepth * baseline (src/Tracking.cc ctor)."""
        return self.baseline * self.th_depth

    def intrinsics(self):
        import numpy as np

        K = np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )
        dist = np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float32)
        return K, dist


_KEYMAP = {
    "Camera.fx": "fx",
    "Camera.fy": "fy",
    "Camera.cx": "cx",
    "Camera.cy": "cy",
    "Camera.k1": "k1",
    "Camera.k2": "k2",
    "Camera.p1": "p1",
    "Camera.p2": "p2",
    "Camera.k3": "k3",
    "Camera.fps": "fps",
    "Camera.bf": "bf",
    "Camera.RGB": "rgb",
    "Camera.width": "width",
    "Camera.height": "height",
    "ThDepth": "th_depth",
    "DepthMapFactor": "depth_map_factor",
    "ORBextractor.nFeatures": "n_features",
    "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.nLevels": "n_levels",
    "ORBextractor.iniThFAST": "ini_th_fast",
    "ORBextractor.minThFAST": "min_th_fast",
    "UseLines": "use_lines",
    "LineBackend": "line_backend",
    "UseLoopClosing": "use_loop_closing",
}

_INT_FIELDS = {"rgb", "width", "height", "n_features", "n_levels", "ini_th_fast", "min_th_fast"}
_BOOL_FIELDS = {"use_lines", "use_loop_closing"}
_STR_FIELDS = {"line_backend"}


def load_settings(path: str | Path) -> Settings:
    """Parse an OpenCV-FileStorage-style YAML (the `%YAML:1.0` dialect the
    reference ships) without depending on cv2. Unknown keys are ignored."""
    text = Path(path).read_text()
    values: dict[str, object] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*$", line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        field = _KEYMAP.get(key)
        if field is None:
            continue
        if field in _BOOL_FIELDS:
            values[field] = raw.strip().lower() in ("1", "true", "yes", "on")
        elif field in _STR_FIELDS:
            values[field] = raw.strip().strip("\"'")
        elif field in _INT_FIELDS:
            values[field] = int(float(raw))
        else:
            values[field] = float(raw)
    return Settings(**values)
