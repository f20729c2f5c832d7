"""The frame front end in plain PyTorch: ORB keypoints and descriptors,
and the device line detector with its LBD descriptors.

Frozen copy of what `plslam_tpu_torch.features.frame.FrameBuilder.build`
computes for a frame's observations (features/orb.py's `ORBExtractor`,
ops/patches.py's plain gather, the line fields of features/frame.py), with
kernel B1 and B2 replaced by their plain twins. It imports nothing of the
port: the benchmark holds what the timed path built to it.
"""

from __future__ import annotations

import torch

from portbench.reference import brief, camera, fast, lbd, lsd_device, orientation, pyramid, select
from portbench.reference import constants as C


def features_per_level(n_features: int, scale_factor: float, n_levels: int):
    """Geometric split of the feature budget over levels (last level
    absorbs the rounding remainder)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor**n_levels)
    out, acc = [], 0
    for lv in range(n_levels - 1):
        k = int(round(n_first * factor**lv))
        out.append(k)
        acc += k
    out.append(max(n_features - acc, 0))
    return out


def level_budget(settings: dict):
    """(features per level, level shapes): levels too small for a
    descriptor patch give their budget to the last usable level."""
    per_level = features_per_level(settings["n_features"], settings["scale_factor"], settings["n_levels"])
    shapes = pyramid.level_shapes(settings["height"], settings["width"], settings["n_levels"],
                                  settings["scale_factor"])
    usable = [min(s) > 2 * C.EDGE_THRESHOLD + 1 for s in shapes]
    last_ok = max(i for i, u in enumerate(usable) if u)
    for lv in range(settings["n_levels"]):
        if not usable[lv]:
            per_level[last_ok] += per_level[lv]
            per_level[lv] = 0
    return per_level, shapes


def _starts(yx, H, W, size):
    """Window top-left as lax.dynamic_slice takes it (a negative start
    wraps once by the dimension, then clamps into [0, dim - size])."""
    r = size // 2

    def one(v, dim):
        v = v.long() - r
        return torch.clamp(torch.where(v < 0, v + dim, v), 0, dim - size)

    return one(yx[:, 0], H), one(yx[:, 1], W)


def gather_patches(img, yx, size: int):
    """Kernel B2's plain twin: img f32[H, W], centres i32[K, 2] ->
    f32[K, size, size]."""
    H, W = img.shape
    ys, xs = _starts(yx, H, W, size)
    ar = torch.arange(size, device=img.device)
    return img[(ys[:, None] + ar)[:, :, None], (xs[:, None] + ar)[:, None, :]]


def orb(gray, settings: dict):
    """gray f32[H, W] (0..255) -> dict of the frame's keypoints: uv_raw
    f32[N, 2] level-0 pixels, octave i32[N], angle f32[N], desc u8[N, 32],
    valid bool[N] (N = the feature budget, before padding to capacity)."""
    Lv, sf = settings["n_levels"], settings["scale_factor"]
    per_level, shapes = level_budget(settings)
    stack = pyramid.build_pyramid_stack(gray, Lv, sf)
    s_hi, s_lo, blurred = fast.fast_blur_stack(stack, shapes, float(settings["ini_th_fast"]),
                                               float(settings["min_th_fast"]))
    score = fast.fallback_nms_border_stack(s_hi, s_lo, shapes, C.FAST_CELL, C.EDGE_THRESHOLD)
    yx, _, valid = select.select_topk_grid(score, max(per_level), cell=16)
    keep = [lv for lv in range(Lv) if per_level[lv]]
    yx_f = torch.cat([yx[lv, : per_level[lv]] for lv in keep], 0)
    val_f = torch.cat([valid[lv, : per_level[lv]] for lv in keep], 0)
    oct_f = torch.cat([torch.full((per_level[lv],), lv, dtype=torch.int32, device=gray.device) for lv in keep])
    scales = torch.tensor([sf**lv for lv in range(Lv)], dtype=torch.float32, device=gray.device)
    H = stack.shape[1]
    yx_flat = torch.stack([oct_f * H + yx_f[:, 0], yx_f[:, 1]], -1)
    sub = select.subpixel_refine(score.reshape(Lv * H, -1), yx_flat)
    patch = gather_patches(blurred.reshape(Lv * H, -1), yx_flat, brief.PATCH_D)
    ang = orientation.ic_angle(patch)
    desc = brief.steered_brief(patch, ang)
    uv0 = (yx_f.flip(-1).to(torch.float32) + sub.flip(-1)) * scales[oct_f.long()][:, None]
    return dict(uv_raw=uv0, octave=oct_f, angle=ang, desc=desc, valid=val_f)


def lines(gray, settings: dict, capacity: int = C.MAX_LINES):
    """gray f32[H, W] -> dict of the frame's keylines from the device line
    detector: ln_sp / ln_ep f32[L, 2] undistorted endpoints, ln_desc
    u8[L, 32] LBD, ln_valid bool[L]."""
    sp_raw, ep_raw, ok = lsd_device.detect_lines_device(gray, capacity)
    gx, gy = lbd.image_gradients(gray)
    desc = lbd.lbd_descriptor(gx, gy, sp_raw, ep_raw, ok)
    K = torch.tensor([[settings["fx"], 0, settings["cx"]], [0, settings["fy"], settings["cy"]], [0, 0, 1]],
                     dtype=torch.float32, device=gray.device)
    dist = torch.tensor([settings[k] for k in ("k1", "k2", "p1", "p2", "k3")], dtype=torch.float32,
                        device=gray.device)
    if bool((dist != 0).any()):
        sp = camera.undistort_pixels(K, dist, torch.where(ok[:, None], sp_raw, 0.0))
        ep = camera.undistort_pixels(K, dist, torch.where(ok[:, None], ep_raw, 1.0))
    else:
        sp, ep = torch.where(ok[:, None], sp_raw, 0.0), torch.where(ok[:, None], ep_raw, 1.0)
    return dict(ln_sp=sp, ln_ep=ep, ln_desc=desc, ln_valid=ok)
