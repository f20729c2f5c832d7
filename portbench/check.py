"""How `correct` is decided: what the window produced, against the plain
reference in portbench/reference/, which imports nothing of the port.

Numbers (each held to its limit in portbench/limits/<cell>.json):
  frontend_bits  the frame front end: ORB (kernels B1 and B2 below it)
              and the device line detector with LBD. Over the sampled
              frames, the share of descriptor bits (ORB and LBD together)
              that differ from the reference's: keypoints of one octave
              paired one to one, nearest first, within MATCH_PX, keylines
              by both endpoints likewise; a row left unpaired on either
              side counts 256 bits.
              One number for both: TF32 reaches the line front end only
              through LBD's two small products, so the control flips no
              keyline bit on some seeds, and a keyline share alone would
              have no upper reading
  pose_gap_p90  kernel B3 on the window's own sampled problems, against
              the plain LM on the same inputs: per problem the largest
              element of |Tcw - Tcw_ref|, and of those the 90th percentile.
              Not the largest: a problem with a row on the chi2 inlier
              boundary flips it in one solve and not in the other and
              moves ~1e-4, in the program and in the control alike
  ba_pose_gap the keyframe chain's local bundle adjustment on the window's
              own sampled problems (the map and keyframe it was given),
              against the plain copy in reference/local_ba.py on the same
              inputs (a batched call's under vmap over the same batch, see
              `ba_gaps`): per problem the largest element of
              |Tcw - Tcw_ref| over the keyframes it returned, and of those
              the largest.
              ATE alone would not see a chain that skips its BA: tracking
              against exact depth keeps the poses within millimetres
  ate_m       trajectory: ATE RMSE (m) of the window's tracked frames
              against the scene's ground truth, after a rigid alignment
  ate_kf_m    the same over the keyframes the window made
The reference runs after the window, with TF32 off (the configuration
states float32). The control is the same reference with TF32 on, put in
the program's place (`control=True`): its numbers come out beside the
program's as control.<name>, and `judge` is asked of them as of the
program's (the control's numbers in the place of the program's).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from portbench.reference import ate, frontend
from portbench.reference.local_ba import BAMap, Camera, LocalBA
from portbench.reference.pose import LineObs, PointObs, pose_optimization_plain

MATCH_PX = 0.01
BITS = 256
MIN_POSE_ROWS = 15  # problems with fewer valid point rows are not held (no pose is determined by them)


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """float32 products with TF32 on or off, restored after."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _popcount(x):
    """Set bits per byte of a u8 tensor."""
    import torch

    x = x.to(torch.int32)
    n = torch.zeros_like(x)
    for k in range(8):
        n = n + ((x >> k) & 1)
    return n


def _match_bits(pts_c, desc_c, ok_c, pts_r, desc_r, ok_r, group_c=None, group_r=None):
    """(differing bits, reference bits): reference rows and candidate rows
    of the same group paired one to one, nearest first, where their
    coordinates (pts: [N, D]; for keylines both endpoints, either way
    round) lie within MATCH_PX; a pair counts its differing bits, a row
    left unpaired on either side BITS bits."""
    import torch

    ic, ir = torch.nonzero(ok_c)[:, 0], torch.nonzero(ok_r)[:, 0]
    n_ref, n_c = int(ir.numel()), int(ic.numel())
    if n_ref == 0 or n_c == 0:
        return float(BITS * (n_ref + n_c)), float(BITS * max(n_ref, 1))
    pr, pc = pts_r[ir].double(), pts_c[ic].double()
    d = torch.cdist(pr, pc)
    if pr.shape[1] == 4:  # keylines: the same segment with its endpoints the other way round
        d = torch.minimum(d, torch.cdist(pr, pc[:, [2, 3, 0, 1]]))
    if group_c is not None:
        d = torch.where(group_r[ir][:, None] == group_c[ic][None, :], d, math.inf)
    r_idx, c_idx = torch.nonzero(d <= MATCH_PX, as_tuple=True)
    order = torch.argsort(d[r_idx, c_idx], stable=True).cpu().numpy()
    r_host, c_host = r_idx.cpu().numpy()[order], c_idx.cpu().numpy()[order]
    seen_r, seen_c, pairs = set(), set(), []
    for r, c in zip(r_host.tolist(), c_host.tolist()):  # greedy, nearest pair first: exact duplicates pair off
        if r not in seen_r and c not in seen_c:
            seen_r.add(r)
            seen_c.add(c)
            pairs.append((r, c))
    bad = BITS * (n_ref - len(pairs) + n_c - len(pairs))
    if pairs:
        pr_i = torch.tensor([p[0] for p in pairs], device=ir.device)
        pc_i = torch.tensor([p[1] for p in pairs], device=ic.device)
        bad += int(_popcount(desc_r[ir[pr_i]] ^ desc_c[ic[pc_i]]).sum())
    return float(bad), float(BITS * n_ref)


def orb_bits(cand: dict, ref: dict):
    n = ref["uv_raw"].shape[0]
    return _match_bits(cand["uv_raw"][:n], cand["desc"][:n], cand["valid"][:n],
                       ref["uv_raw"], ref["desc"], ref["valid"], cand["octave"][:n], ref["octave"])


def line_bits(cand: dict, ref: dict):
    import torch

    ends = lambda d: torch.cat([d["ln_sp"], d["ln_ep"]], -1)  # noqa: E731
    return _match_bits(ends(cand), cand["ln_desc"], cand["ln_valid"], ends(ref), ref["ln_desc"], ref["ln_valid"])


def reference_frame(gray, settings: dict, tf32: bool = False) -> dict:
    """The reference's frame front end on one gray image (a device tensor)."""
    with matmul_tf32(tf32):
        out = frontend.orb(gray, settings)
        out.update(frontend.lines(gray, settings))
    return out


def _problems(item):
    """A captured pose call -> one entry per problem (a stacked call holds P)."""
    P = item["Tcw0"].shape[0] if item["Tcw0"].ndim == 3 else None
    rows = []
    for p in range(P or 1):
        sel = (lambda t: t[p]) if P else (lambda t: t)
        rows.append(dict(Tcw0=sel(item["Tcw0"]), pts=PointObs(*(sel(f) for f in item["pts"])),
                         lines=None if item["lines"] is None else LineObs(*(sel(f) for f in item["lines"])),
                         K=np.asarray(item["K"], np.float32), bf=item["bf"], Tcw=sel(item["Tcw"]),
                         pin=sel(item["pin"])))
    return rows


def reference_pose(prob, tf32: bool = False):
    """-> (Tcw, point inliers) of the plain LM on the problem's inputs."""
    with matmul_tf32(tf32):
        T, pin, _ = pose_optimization_plain(prob["Tcw0"], prob["pts"], prob["K"], prob["bf"], prob["lines"])
    return T, pin


def ba_gaps(item, settings: dict, tf32: bool = False) -> list:
    """A captured local BA call -> per problem the largest element of
    |Tcw - Tcw_ref| (and with tf32=True of |Tcw_control - Tcw_ref|): one
    problem, or under vmap one per sequence that made a keyframe. A
    batched call is held to the reference run under vmap over the same
    batch: float32 LM here moves a pose by ~1e-3 for any change in
    rounding, and a batched product sums in another order than a solo one
    (PERF.md section 4)."""
    pose, batched = item["kf_pose"]
    if not batched:
        m = BAMap(**{f: v for f, (v, _) in item["inp"].items()})
        ref = reference_ba(m, item["k"][0], settings)
        cand = reference_ba(m, item["k"][0], settings, tf32=True) if tf32 else pose
        return [float((cand - ref).abs().max())]
    B = pose.shape[0]
    m = BAMap(**{f: (v if bt else v.expand((B,) + v.shape)) for f, (v, bt) in item["inp"].items()})
    k = item["k"][0] if item["k"][1] else item["k"][0].expand(B)
    ref = reference_ba(m, k, settings, batched=True)
    cand = reference_ba(m, k, settings, tf32=True, batched=True) if tf32 else pose
    return [float((cand[b] - ref[b]).abs().max()) for b in [int(i) for i in item["made"].nonzero()[0]]]


def reference_ba(m: BAMap, k, settings: dict, tf32: bool = False, batched: bool = False):
    """kf_pose of the plain local BA on the problem's inputs (batched:
    under torch.func.vmap over the leading axis)."""
    import torch

    one = BAMap(*(v[0] for v in m)) if batched else m
    fn = LocalBA(Camera(settings, one)).run
    with matmul_tf32(tf32):
        if batched:
            return torch.func.vmap(lambda mm_, kk: fn(BAMap(*mm_), kk).kf_pose)(tuple(m), k)
        return fn(m, k).kf_pose


def judge(numbers: dict, limits: dict) -> bool:
    """Each number compared is there, finite, and within its limit."""
    return all(math.isfinite(numbers.get(k, math.nan)) and numbers[k] <= lim for k, lim in limits.items())


def ate_rmse(rows, gt_pose, skip_short: bool = False):
    """rows [(seq, scene index, Twc)] -> ATE RMSE (m), each sequence aligned
    on its own, pooled over all rows. A sequence with fewer than 3 rows
    (no alignment is determined) makes it inf, or with skip_short is left
    out; inf if no row is left."""
    err2, n = 0.0, 0
    for b in sorted({r[0] for r in rows}):
        sel = [r for r in rows if r[0] == b]
        if len(sel) < 3:
            if skip_short:
                continue
            return math.inf
        A = np.stack([r[2][:3, 3] for r in sel])
        B = np.stack([gt_pose(b, r[1])[:3, 3] for r in sel])
        R, t = ate.horn_align(A, B)
        err2 += float((((A @ R.T + t) - B) ** 2).sum())
        n += len(sel)
    return math.sqrt(err2 / n) if n else math.inf


def evaluate(cell, sess, caps, out: dict, device, control: bool = False) -> dict:
    """The numbers of one run (and with control=True the control's too)."""
    import torch

    s = cell.config["settings"]
    want = {k for k in cell.limits if not k.startswith("_")}
    nums: dict[str, float] = {}
    fed = sess.window_frames()
    acc = {k: [0.0, 0.0] for k in ("frontend_bits", "control.frontend_bits")}
    for item in caps.frames.items:
        if item is None:
            continue
        i, gray_c, cand = item
        seq, idx = _identify(sess, fed, i, gray_c)
        if seq is None:
            return {k: math.inf for k in want}  # the program built a frame the window never fed
        gray = torch.from_numpy(sess.frame(seq, idx)[0]).to(device, torch.float32)
        ref = reference_frame(gray, s)
        _add_bits(acc["frontend_bits"], cand, ref, nums)
        if control:
            _add_bits(acc["control.frontend_bits"], reference_frame(gray, s, tf32=True), ref, nums, "control.")
    for k, (bad, tot) in acc.items():
        if tot > 0:
            nums[k] = bad / tot
    for k in [k for k in nums if k.endswith("_bits") and k.startswith("diag.")]:
        bad, tot = nums[k]
        nums[k] = bad / tot if tot else math.nan
    gaps, gaps_c, flips, flips_c = [], [], [], []
    for item in caps.poses.items:
        if item is None:
            continue
        for prob in _problems(item):
            if int(prob["pts"].valid.sum()) < MIN_POSE_ROWS:
                continue
            ref_T, ref_in = reference_pose(prob)
            gaps.append(float((prob["Tcw"] - ref_T).abs().max()))
            flips.append(int((prob["pin"] != ref_in).sum()))
            if control:
                ctl_T, ctl_in = reference_pose(prob, tf32=True)
                gaps_c.append(float((ctl_T - ref_T).abs().max()))
                flips_c.append(int((ctl_in != ref_in).sum()))
    nums["diag.frames_checked"] = float(sum(1 for it in caps.frames.items if it is not None))
    nums["diag.problems_checked"] = float(len(gaps))
    for prefix, g, f in (("", gaps, flips), ("control.", gaps_c, flips_c)):
        if g:
            nums[prefix + "pose_gap_p90"] = float(np.quantile(g, 0.9))
            worst = int(np.argmax(g))
            nums[f"diag.{prefix}pose_gap_max"] = max(g)
            nums[f"diag.{prefix}pose_flips_worst"] = float(f[worst])
            nums[f"diag.{prefix}pose_flipped_share"] = float(np.mean(np.asarray(f) > 0))
    ba, ba_c = [], []
    for item in caps.ba.items:
        if item is None:
            continue
        ba += ba_gaps(item, s)
        if control:
            ba_c += ba_gaps(item, s, tf32=True)
    nums["diag.ba_problems_checked"] = float(len(ba))
    for prefix, g in (("", ba), ("control.", ba_c)):
        if g:
            nums[prefix + "ba_pose_gap"] = max(g)
            nums[f"diag.{prefix}ba_pose_gap_median"] = float(np.median(g))
    nums["ate_m"] = ate_rmse(out["traj"], sess.gt_pose)
    if out["kf"]:
        nums["ate_kf_m"] = ate_rmse(out["kf"], sess.gt_pose, skip_short=True)
    return nums


def _add_bits(acc, cand, ref, nums, prefix=""):
    """Add one frame's ORB and keyline bits to acc; keep each part's share
    apart as a diagnostic."""
    for part, (bad, tot) in (("orb", orb_bits(cand, ref)), ("line", line_bits(cand, ref))):
        acc[0] += bad
        acc[1] += tot
        d = nums.setdefault(f"diag.{prefix}{part}_bits", [0.0, 0.0])
        d[0] += bad
        d[1] += tot


def _identify(sess, fed, i, gray_c):
    """(sequence, scene index) of the i-th frame the program built in the
    window: the i-th frame fed if its pixels are the captured ones, else
    the fed frame with exactly those pixels (a frame built twice, as a
    relocalization rebuilds one), else (None, None)."""
    g = gray_c.cpu().numpy()
    if i < len(fed) and np.array_equal(sess.frame(*fed[i])[0], g):
        return fed[i]
    for seq, idx in fed:
        if np.array_equal(sess.frame(seq, idx)[0], g):
            return seq, idx
    return None, None
